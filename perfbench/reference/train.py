"""The reference's first train steps and the readings they give.

From the weights and the batches the benchmark hands over, it runs the
configuration's AdamW steps itself: the learning rate from the
configuration's cosine schedule, each step's loss and gradient summed over
blocks of rows so that long sequences fit, torch's AdamW update order
(decoupled decay, then the bias-corrected moments). It reads each step's
loss, each leaf's gradient norm at the first step, and each leaf's change
after the last step. The model is the configuration's family's plain one
(`spec.family`); the loss, the cross-entropy with uniform label smoothing
as a mean over the batch, is the train traffic's own.

`fault` plants what a broken program would do, for the check's own test
and its upper readings: "half" takes the loss over the first half of each
batch only, "answer" adds 1 to one row's logit of its label.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from .. import spec
from .precision import Products, float32_products

BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def learning_rate(config: dict, mix: dict, step: int) -> float:
    """The configuration's schedule at update `step` (0-based): cosine decay
    from base_learning_rate x batch / base_batch over epochs x the chunks an
    epoch of the held images fills."""
    peak = config["base_learning_rate"] * mix["batch"] / config["base_batch"]
    per_epoch = mix["held_images"] // (mix["batch"] * mix["fused_steps"]) * mix["fused_steps"]
    total = max(1, config["epochs"] * per_epoch)
    if config["scheduler"] != "cosine":
        raise ValueError(f"unknown scheduler {config['scheduler']!r}")
    return peak * 0.5 * (1.0 + math.cos(math.pi * min(step, total) / total))


def normalise(images_u8: torch.Tensor, config: dict) -> torch.Tensor:
    mean = torch.tensor(config["mean"], dtype=torch.float32, device=images_u8.device)
    std = torch.tensor(config["std"], dtype=torch.float32, device=images_u8.device)
    return (images_u8.float() / 255.0 - mean) / std


def row_losses(logits: torch.Tensor, labels: torch.Tensor, smoothing: float) -> torch.Tensor:
    """Per-row cross-entropy with (1 - s) on the label and s / K on every
    class."""
    logp = torch.log_softmax(logits, dim=-1)
    on = logp.gather(1, labels[:, None].long())[:, 0]
    return -((1.0 - smoothing) * on + (smoothing / logits.shape[-1]) * logp.sum(-1))


def run_steps(config: dict, mix: dict, weights: Dict[str, torch.Tensor],
              batches: List[Tuple[torch.Tensor, torch.Tensor]], device,
              precision: str = "fp32", fault: Optional[str] = None) -> dict:
    """len(batches) AdamW steps from `weights` over `batches` (uint8 images
    [B, S, S, C], labels [B]) on `device`.

    Returns {"losses": [...], "grad_norms": {leaf: |g_1|},
    "delta_norms": {leaf: |theta_last - theta_0|}} over the leaves that
    train.
    """
    prods = Products(precision)
    model = spec.family(config).reference
    leaves = model.parameter_spec(config, mix)
    w = {n: weights[n].to(device, torch.float32).clone().requires_grad_(model.trains(init))
         for n, _, init in leaves}
    train = [n for n, _, init in leaves if model.trains(init)]
    start = {n: w[n].detach().clone() for n in train}
    m = {n: torch.zeros_like(w[n]) for n in train}
    v = {n: torch.zeros_like(w[n]) for n in train}
    rows = model.block_rows(config, mix)
    losses, grad_norms = [], {}
    with float32_products():
        for t, (images, labels) in enumerate(batches):
            b = images.shape[0]
            weight = torch.full((b,), 1.0 / b, device=device)
            if fault == "half":
                weight[: b // 2] = 2.0 / b
                weight[b // 2:] = 0.0
            loss = 0.0
            for lo in range(0, b, rows):
                x = normalise(images[lo:lo + rows].to(device), config)
                y = labels[lo:lo + rows].to(device).long()
                logits = model.forward(w, x, config, prods)
                if fault == "answer" and lo == 0:
                    bump = torch.zeros_like(logits)
                    bump[0, y[0]] = 1.0
                    logits = logits + bump
                part = (row_losses(logits, y, config["label_smoothing"])
                        * weight[lo:lo + rows]).sum()
                part.backward()
                loss += float(part.detach())
            losses.append(loss)
            lr = learning_rate(config, mix, t)
            with torch.no_grad():
                if t == 0:
                    grad_norms = {n: float(w[n].grad.norm()) for n in train}
                for n in train:
                    g = w[n].grad
                    w[n].mul_(1.0 - lr * config["weight_decay"])
                    m[n].lerp_(g, 1.0 - BETAS[0])
                    v[n].mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
                    c1, c2 = 1.0 - BETAS[0] ** (t + 1), 1.0 - BETAS[1] ** (t + 1)
                    w[n].addcdiv_(m[n], (v[n] / c2).sqrt().add_(ADAM_EPS), value=-lr / c1)
                    w[n].grad = None
    with torch.no_grad():
        delta = {n: float((w[n] - start[n]).norm()) for n in train}
    return {"losses": losses, "grad_norms": grad_norms, "delta_norms": delta}
