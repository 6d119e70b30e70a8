"""Loss, LR schedules, optimisers, the train step and the serving (eval) step.

Counterpart of `efficient_rpe_vit_tpu/train/training.py` (:68-310 and
`make_eval_step`): the same schedule vocabulary with optax's values at
every step, adam / adamw / sgd with optax's update rules, a train state
with an optional EMA shadow, and a train step (forward, backward, update)
with label smoothing and gradient accumulation over microbatches. The JAX
package jits one program per step; here the step runs eagerly on the
model's device, updating the model and optimiser in place. Dropout masks
and redrawn random features come from the generator each step is given.
`make_multi_step` (K steps in one program) is not ported yet.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch
from torch import nn

from ..utils.device import resolve_device

Schedule = Callable[[int], float]


# ─── LR schedules (optax's formulas, as functions of the update count) ───

def _constant(value: float) -> Schedule:
    return lambda count: value


def _linear(init_value: float, end_value: float, steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over `steps`, then end."""
    if steps <= 0:
        return _constant(init_value)

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init_value - end_value) * frac + end_value

    return schedule


def _cosine(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps)
                                       / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _warmup_cosine(peak_value: float, warmup_steps: int,
                   decay_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule(init_value=0, end_value=0)."""
    warmup = _linear(0.0, peak_value, warmup_steps)
    decay = _cosine(peak_value, decay_steps - warmup_steps)
    return lambda count: (warmup(count) if count < warmup_steps
                          else decay(count - warmup_steps))


def _staircase_decay(init_value: float, transition_steps: int,
                     decay_rate: float) -> Schedule:
    """optax.exponential_decay(..., staircase=True)."""
    if transition_steps <= 0 or decay_rate == 0:
        return _constant(init_value)
    return lambda count: (init_value if count <= 0 else init_value
                          * decay_rate ** math.floor(count / transition_steps))


def create_lr_scheduler(scheduler: Optional[str], learning_rate: float,
                        epochs: int, steps_per_epoch: int,
                        warmup_epochs: int = 0, step_size: int = 10,
                        gamma: float = 0.1) -> Schedule:
    """LR schedule `count -> lr`, count being the number of updates already
    applied: cosine | warmup_cosine | step | constant (also 'none' / None).
    Cosine with warmup epochs becomes warmup_cosine, as in the JAX package.
    """
    total_steps = max(1, epochs * steps_per_epoch)
    warmup_steps = warmup_epochs * steps_per_epoch
    if scheduler == "cosine" and warmup_epochs > 0:
        scheduler = "warmup_cosine"
    if scheduler == "cosine":
        return _cosine(learning_rate, total_steps)
    if scheduler == "warmup_cosine":
        return _warmup_cosine(learning_rate, max(1, warmup_steps), total_steps)
    if scheduler == "step":
        return _staircase_decay(learning_rate, step_size * steps_per_epoch,
                                gamma)
    if scheduler in ("constant", "none", None):
        return _constant(learning_rate)
    raise ValueError(f"unknown scheduler {scheduler!r}")


# ─── optimisers ─────────────────────────────────────────────────────────

def create_optimizer(optimizer: str, params: Iterable[nn.Parameter],
                     schedule: Schedule, weight_decay: float = 0.0,
                     momentum: float = 0.9) -> torch.optim.Optimizer:
    """adam | adamw | sgd (+momentum 0.9), with optax's update rules:

    * adam: weight decay coupled (added to the gradient before the moments,
      optax's `add_decayed_weights` -> `adam`), betas (0.9, 0.999), eps 1e-8;
    * adamw: decay decoupled, `weight_decay` passed explicitly (torch's
      AdamW default 0.01 is not the config's value);
    * sgd: heavy-ball momentum, trace initialised at zero, coupled decay.

    The learning rate is set from `schedule` before every update
    (`TrainState.apply_gradients`); it starts at schedule(0).
    """
    lr = schedule(0)
    if optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    if optimizer == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    if optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum,
                               weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {optimizer!r}")


# ─── train state ────────────────────────────────────────────────────────

@dataclass
class TrainState:
    """The model (parameters and buffers: Omega, redraw counters), its
    optimiser and LR schedule, the number of updates applied, and an
    optional EMA shadow of the parameters (`ema_decay` > 0)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    ema_decay: float = 0.0
    _ema_model: Optional[nn.Module] = field(default=None, repr=False)

    def apply_gradients(self) -> "TrainState":
        """One update from the gradients in the parameters' `.grad`, at the
        learning rate schedule(step); then the EMA shadow moves toward the
        new parameters: e = d*e + (1-d)*p."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        if self.ema_params is not None:
            d = self.ema_decay
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    self.ema_params[name].mul_(d).add_(p, alpha=1.0 - d)
        self.step += 1
        return self

    def eval_view(self) -> nn.Module:
        """The model to evaluate or serve: a copy carrying the EMA
        parameters (and the live buffers) when an EMA is tracked, else the
        model itself."""
        if self.ema_params is None:
            return self.model
        if self._ema_model is None:
            self._ema_model = copy.deepcopy(self.model)
        with torch.no_grad():
            for name, p in self._ema_model.named_parameters():
                p.copy_(self.ema_params[name])
            live = dict(self.model.named_buffers())
            for name, b in self._ema_model.named_buffers():
                b.copy_(live[name])
        return self._ema_model


def create_train_state(model: nn.Module, config, steps_per_epoch: int = 100,
                       ema_decay: float = 0.0) -> TrainState:
    """Optimiser and LR schedule for `model` from an ExperimentConfig.

    `steps_per_epoch` sizes the schedule horizon (epochs * steps_per_epoch);
    `ema_decay` > 0 tracks an EMA shadow of the parameters, initialised to
    them, served by `eval_view()`.
    """
    t = config.train
    schedule = create_lr_scheduler(t.scheduler, t.learning_rate, t.epochs,
                                   steps_per_epoch, t.warmup_epochs)
    optimizer = create_optimizer(t.optimizer, model.parameters(), schedule,
                                 t.weight_decay)
    ema = None
    if ema_decay > 0:
        ema = {name: p.detach().clone() for name, p in model.named_parameters()}
    return TrainState(model=model, optimizer=optimizer, schedule=schedule,
                      ema_params=ema, ema_decay=float(ema_decay))


# ─── loss and steps ─────────────────────────────────────────────────────

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


def _check_on(model: nn.Module, device: torch.device, step: str) -> None:
    for name, t in [*model.named_parameters(), *model.named_buffers()]:
        if t.device != device:
            raise ValueError(f"model tensor {name} lies on {t.device}, the "
                             f"{step} step runs on {device}")


def make_micro_loss(model: nn.Module, label_smoothing: float = 0.0
                    ) -> Callable[[torch.Tensor, torch.Tensor, torch.Generator],
                                  Tuple[torch.Tensor, torch.Tensor]]:
    """The loss every train step shares: `(images, labels, generator) ->
    (loss, correct)`, a train-mode forward whose dropout masks and redrawn
    features (which advance the redraw counters) come from `generator`."""

    def micro_loss(images, labels, generator):
        logits = model(images, generator)
        loss = cross_entropy_loss(logits, labels, label_smoothing)
        correct = (logits.argmax(dim=-1) == labels).sum()
        return loss, correct

    return micro_loss


def make_train_step(model: nn.Module, grad_accum: int = 1,
                    label_smoothing: float = 0.0,
                    device: Union[str, torch.device, None] = None
                    ) -> Callable[..., Tuple[TrainState, torch.Tensor, torch.Tensor]]:
    """Train step `(state, images, labels, generator) -> (state, loss,
    correct)`: forward in train mode, backward, one optimiser update.

    `grad_accum` > 1 splits the batch into that many equal microbatches,
    run one after the other (each forward advances the redraw counters) and
    averages their gradients, as the JAX package's scan does; the loss is
    the mean of the microbatch losses and `correct` their sum. `device`
    None means the GPU (raising when there is none); the model must already
    live there, `generator` must be on the same device type, and images /
    labels are moved to it. The state is updated in place and returned.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    device = resolve_device(device)
    _check_on(model, device, "train")
    micro_loss = make_micro_loss(model, label_smoothing)
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(state: TrainState, images, labels, generator: torch.Generator):
        if state.model is not model:
            raise ValueError("the state was created for another model")
        if generator.device.type != device.type:
            raise ValueError(f"generator lies on {generator.device}, the "
                             f"train step runs on {device}")
        images = torch.as_tensor(images, device=device)
        labels = torch.as_tensor(labels, device=device)
        if images.shape[0] % grad_accum:
            raise ValueError(f"batch {images.shape[0]} not divisible by "
                             f"grad_accum {grad_accum}")
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum, correct = 0.0, 0
        for x, y in zip(images.chunk(grad_accum), labels.chunk(grad_accum)):
            loss, c = micro_loss(x, y, generator)
            loss.backward()  # .grad accumulates the sum over microbatches
            loss_sum = loss_sum + loss.detach()
            correct = correct + c
        if grad_accum > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.div_(grad_accum)
        state.apply_gradients()
        return state, loss_sum / grad_accum, correct

    return train_step


def make_eval_step(model: nn.Module,
                   device: Union[str, torch.device, None] = None
                   ) -> Callable[[torch.Tensor, torch.Tensor],
                                 Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Serving step `(images, labels) -> (loss, correct, preds)`.

    Runs `model` in eval mode under `torch.inference_mode()` on `device`
    (None means the GPU, raising when there is none). The model must already
    live there; images [B, H, W, C] and labels [B] are moved to it.
    """
    device = resolve_device(device)
    _check_on(model, device, "eval")
    model.eval()

    def eval_step(images, labels):
        model.eval()
        with torch.inference_mode():
            images = torch.as_tensor(images, device=device)
            labels = torch.as_tensor(labels, device=device)
            logits = model(images)
            loss = cross_entropy_loss(logits, labels)
            preds = logits.argmax(dim=-1)
            correct = (preds == labels).sum()
        return loss, correct, preds

    return eval_step
