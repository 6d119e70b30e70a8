"""Loss and the serving (eval) step.

Counterpart of the inference half of
`efficient_rpe_vit_tpu/train/training.py`; the optimiser, schedules and
train steps come with the training slice.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch
from torch import nn

from ..utils.device import resolve_device


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy from fp32 log-softmax; optional uniform smoothing:
    (1-s) on the target + s/K everywhere."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    on = logp.gather(1, labels[:, None].long())[:, 0]
    if label_smoothing:
        k = logits.shape[-1]
        s = label_smoothing
        return -((1.0 - s) * on + (s / k) * logp.sum(dim=-1)).mean()
    return -on.mean()


def make_eval_step(model: nn.Module,
                   device: Union[str, torch.device, None] = None
                   ) -> Callable[[torch.Tensor, torch.Tensor],
                                 Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Serving step `(images, labels) -> (loss, correct, preds)`.

    Puts `model` in eval mode and runs it under `torch.inference_mode()` on
    `device` (None means the GPU, raising when there is none). The model
    must already live there; images [B, H, W, C] and labels [B] are moved
    to it.
    """
    device = resolve_device(device)
    for name, t in [*model.named_parameters(), *model.named_buffers()]:
        if t.device != device:
            raise ValueError(f"model tensor {name} lies on {t.device}, the "
                             f"eval step runs on {device}")
    model.eval()

    def eval_step(images, labels):
        with torch.inference_mode():
            images = torch.as_tensor(images, device=device)
            labels = torch.as_tensor(labels, device=device)
            logits = model(images)
            loss = cross_entropy_loss(logits, labels)
            preds = logits.argmax(dim=-1)
            correct = (preds == labels).sum()
        return loss, correct, preds

    return eval_step
