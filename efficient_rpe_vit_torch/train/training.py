"""Loss, LR schedules, optimisers, the train and eval steps, the fused
K-step programs and the epoch / evaluation loops.

Counterpart of `efficient_rpe_vit_tpu/train/training.py`: the same
schedule vocabulary with optax's values at every step, adam / adamw / sgd
with optax's update rules, a train state with an optional EMA shadow, a
train step (forward, backward, update) with label smoothing and gradient
accumulation over microbatches, `make_multi_step` and the gather-fused
`make_gather_multi_step` / `make_gather_multi_eval` (K steps per call),
and `train_epoch` / `evaluate` with their fused loops. The JAX package
jits one program per step or scans K of them; here a step runs eagerly on
the model's device, updating the model and optimiser in place, and on the
GPU the K-step programs are CUDA graphs (`_Replays`): K full steps
captured once per input shape and replayed by one call. Dropout masks and
augmentation draws come from the generator each call is given.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..data.pipeline import _gather_batch
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
    (`TrainState.apply_gradients`); it starts at schedule(0). On the GPU
    adam and adamw are built capturable, with the learning rate a 0-dim
    fp32 tensor on the card and the step counts on the card too, so that
    K updates can be captured in one CUDA graph (`make_multi_step`), and
    the eager step takes the same arithmetic as the replayed one.
    """
    params = list(params)
    lr = schedule(0)
    on_card = any(p.is_cuda for p in params)
    if optimizer in ("adam", "adamw"):
        cls = torch.optim.Adam if optimizer == "adam" else torch.optim.AdamW
        if on_card:
            lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
        return cls(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                   weight_decay=weight_decay, capturable=on_card)
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
        self._update(self.schedule(self.step))
        self.step += 1
        return self

    def _update(self, lr: Union[float, torch.Tensor]) -> None:
        """`apply_gradients` at learning rate `lr`, without counting the
        update: a float, or a 0-dim tensor that a capturable optimiser's
        device lr copies on the device (a captured step reads its lr from
        the table its replay was given)."""
        for group in self.optimizer.param_groups:
            if not isinstance(group["lr"], torch.Tensor):
                group["lr"] = lr
            elif isinstance(lr, torch.Tensor):
                group["lr"].copy_(lr)
            else:
                group["lr"].fill_(lr)
        self.optimizer.step()
        if self.ema_params is not None:
            d = self.ema_decay
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    self.ema_params[name].mul_(d).add_(p, alpha=1.0 - d)

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


def _step_body(model: nn.Module, grad_accum: int, label_smoothing: float):
    """`run(state, images, labels, generator, lr) -> (loss, correct)`: one
    train step on device tensors at learning rate `lr` (float or 0-dim
    tensor), without counting it in `state.step`. It reads nothing back to
    the host, so a CUDA graph can capture it."""
    micro_loss = make_micro_loss(model, label_smoothing)
    params = [p for p in model.parameters() if p.requires_grad]

    def run(state: TrainState, images, labels, generator, lr):
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
        state._update(lr)
        return loss_sum / grad_accum, correct

    return run


def _check_call(state: TrainState, model: nn.Module, generator,
                device: torch.device) -> None:
    if state.model is not model:
        raise ValueError("the state was created for another model")
    if generator.device.type != device.type:
        raise ValueError(f"generator lies on {generator.device}, the "
                         f"train step runs on {device}")


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
    run = _step_body(model, grad_accum, label_smoothing)

    def train_step(state: TrainState, images, labels, generator: torch.Generator):
        _check_call(state, model, generator, device)
        images = torch.as_tensor(images, device=device)
        labels = torch.as_tensor(labels, device=device)
        if images.shape[0] % grad_accum:
            raise ValueError(f"batch {images.shape[0]} not divisible by "
                             f"grad_accum {grad_accum}")
        loss, correct = run(state, images, labels, generator,
                            state.schedule(state.step))
        state.step += 1
        return state, loss, correct

    return train_step


# ─── K steps per call: CUDA graphs on the GPU ───────────────────────────

class _Replays:
    """Calls of a K-step body replayed from CUDA graphs, one graph per key.

    The first call with a new key runs `body(*copied, generator)` eagerly
    on a side stream and returns that run's result: it is the warm-up of
    PyTorch's whole-network capture recipe, in which the kernel libraries'
    first load, cuBLAS workspaces and the optimiser's state are made. Then
    `body` is captured over static copies of `copied`. A later call with
    the key copies its `copied` tensors into those buffers, replays, and
    returns copies of the graph's outputs. Every other tensor the body
    touches is read at the address it had at capture (the model, the
    optimiser state, a device-resident dataset): `pins` keeps those
    objects alive, and the caller puts their identity in the key. The
    body's Python runs only at capture (so wrappers' `.launches` count the
    kernels a graph holds, once) and must make no host read of a device
    value. Random draws come from a generator of the graph's own,
    registered with it: before each replay it takes the caller's
    generator state and after it gives the advanced state back, so the
    caller's generator moves on as it would over the eager steps and the
    next replay draws new masks. `before_capture`, when set, is called
    between a key's warm-up and its capture (a caller that counts
    launches reads the warm-up's there and zeroes them, so that what it
    reads after the call is the graph's own).
    """

    def __init__(self, device: torch.device, inference: bool = False):
        self.device = device
        self.inference = inference
        self.graphs: Dict[tuple, tuple] = {}
        self.before_capture: Optional[Callable[[], None]] = None

    def _run(self, body, copied, generator):
        with torch.inference_mode(self.inference):
            return body(*copied, generator)

    def __call__(self, key: tuple, body: Callable, copied: Tuple[torch.Tensor, ...],
                 generator: Optional[torch.Generator] = None, pins=()):
        entry = self.graphs.get(key)
        if entry is None:
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                out = self._run(body, copied, generator)
            current.wait_stream(side)
            if self.before_capture is not None:
                self.before_capture()
            static = tuple(t.clone() for t in copied)
            own = None if generator is None else torch.Generator(self.device)
            graph = torch.cuda.CUDAGraph()
            if own is not None:
                graph.register_generator_state(own)
            with torch.cuda.graph(graph):
                static_out = self._run(body, static, own)
            self.graphs[key] = (graph, static, static_out, own, pins)
            return out
        graph, static, static_out, own, _ = entry
        for dst, src in zip(static, copied):
            dst.copy_(src)
        if own is not None:
            own.set_state(generator.get_state())
        graph.replay()
        if own is not None:
            generator.set_state(own.get_state())
        return tuple(t.clone() for t in static_out)


def _lr_table(schedule: Schedule, step: int, k: int) -> np.ndarray:
    """The learning rates of updates step .. step+k-1 as fp32: a replayed
    step i copies entry i into the optimiser's device lr, the value the
    eager step's fill of schedule(step + i) writes."""
    return np.asarray([schedule(step + i) for i in range(k)], np.float32)


def _graph_blocker(model: nn.Module, optimizer: torch.optim.Optimizer) -> Optional[str]:
    """Why K steps of `model` under `optimizer` cannot be captured in a CUDA
    graph, or None."""
    redraw = [n for n, m in model.named_modules()
              if getattr(m, "feature_redraw_interval", None) is not None]
    if redraw:
        return ("feature redraw reads its counter on the host to decide which "
                "calls redraw Omega, which a CUDA graph cannot do; "
                f"{redraw[0]} sets feature_redraw_interval")
    if not all(g.get("capturable", False) for g in optimizer.param_groups):
        return (f"{type(optimizer).__name__} is not capturable: its update "
                "reads the learning rate on the host")
    return None


def _k_step_body(run, state, k: int, gather=None):
    """Body of K steps: with `gather` None its inputs are images [K, B, ...],
    labels [K, B] and the fp32 lr table [K]; else one packed int32 vector
    of the [K, B] row indices followed by the K learning rates' bits (one
    host-to-device copy a call), and `gather(rows, generator)` makes each
    step's batch on the device."""

    def steps(*args):
        if gather is None:
            images, labels, lrs, generator = args
            batches = ((images[i], labels[i]) for i in range(k))
        else:
            packed, generator = args
            idx = packed[:-k].view(k, -1)
            lrs = packed[-k:].view(torch.float32)
            batches = (gather(idx[i], generator) for i in range(k))
        losses, corrects = [], []
        for i, (x, y) in enumerate(batches):
            loss, correct = run(state, x, y, generator, lrs[i])
            losses.append(loss)
            corrects.append(correct)
        return torch.stack(losses), torch.stack(corrects)

    return steps


def _to_card(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on the card through pinned memory, without making the
    host wait for the work already queued."""
    return torch.from_numpy(array).pin_memory().to(device, non_blocking=True)


def _loop(train_step, state, batches, generator):
    """K train steps as a loop (the CPU's K-step program)."""
    losses, corrects = [], []
    for x, y in batches:
        state, loss, correct = train_step(state, x, y, generator)
        losses.append(loss)
        corrects.append(correct)
    return state, torch.stack(losses), torch.stack(corrects)


def make_multi_step(model: nn.Module, label_smoothing: float = 0.0,
                    device: Union[str, torch.device, None] = None
                    ) -> Callable[..., Tuple[TrainState, torch.Tensor, torch.Tensor]]:
    """K full train steps per call: `multi_step(state, images [K, B, ...],
    labels [K, B], generator) -> (state, losses [K], corrects [K])`, equal
    to K calls of `make_train_step`'s step with the same generator.

    On the GPU the K steps (forward, backward, optimiser update, EMA) are
    one CUDA graph, captured at the first call of each (K, batch shape,
    dtype) after that call has run them eagerly (`_Replays`), and replayed
    by every later call: a new shape, such as an epoch's tail chunk,
    captures its own graph, as JAX compiles a second program. Each replay
    reads its K learning rates schedule(step + i) from a table the host
    fills, and `state.step` advances by K on the host. A step that cannot
    be captured raises NotImplementedError on the GPU: feature redraw
    (`feature_redraw_interval`), and an optimiser that is not capturable
    (sgd). On the CPU the K steps run as a loop of the train step.
    """
    device = resolve_device(device)
    train_step = make_train_step(model, label_smoothing=label_smoothing,
                                 device=device)
    if device.type != "cuda":
        return lambda state, images, labels, generator: _loop(
            train_step, state, zip(images, labels), generator)

    run = _step_body(model, 1, label_smoothing)
    replays = _Replays(device)

    def graphed_multi_step(state: TrainState, images, labels, generator):
        _check_call(state, model, generator, device)
        blocker = _graph_blocker(model, state.optimizer)
        if blocker:
            raise NotImplementedError(f"make_multi_step on the GPU: {blocker}")
        images = torch.as_tensor(images, device=device)
        labels = torch.as_tensor(labels, device=device)
        k = images.shape[0]
        lrs = _to_card(_lr_table(state.schedule, state.step, k), device)
        key = (id(state), tuple(images.shape), images.dtype, tuple(labels.shape),
               labels.dtype)
        losses, corrects = replays(key, _k_step_body(run, state, k),
                                   (images, labels, lrs), generator, pins=(state,))
        state.step += k
        return state, losses, corrects

    graphed_multi_step.replays = replays
    return graphed_multi_step


def make_gather_multi_step(model: nn.Module, label_smoothing: float = 0.0,
                           augment: Optional[str] = None,
                           device: Union[str, torch.device, None] = None
                           ) -> Callable[..., Tuple[TrainState, torch.Tensor, torch.Tensor]]:
    """K train steps per call with the batch assembly inside:
    `gather_step(state, images_u8 [n, H, W, C], labels_all [n], mean [C],
    std [C], idx [K, B], generator) -> (state, losses [K], corrects [K])`.

    Each step gathers its rows of the device-resident uint8 dataset
    (`DeviceDataset.images` / `.labels`), augments them on raw [0, 1]
    pixels ('mnist' | 'cifar' | None, draws from `generator`), normalises
    and runs one full train step. On the GPU the K steps are one CUDA graph
    per (K, B) and dataset, as `make_multi_step`'s, and the only
    host-to-device copy of a call is one int32 vector: the [K, B] indices
    and the K learning rates. On the CPU the steps run as a loop.
    """
    device = resolve_device(device)
    train_step = make_train_step(model, label_smoothing=label_smoothing,
                                 device=device)
    run = _step_body(model, 1, label_smoothing)
    replays = _Replays(device)

    def gather_step(state: TrainState, images_u8, labels_all, mean, std, idx,
                    generator: torch.Generator):
        _check_call(state, model, generator, device)

        def gather(rows, gen):
            return _gather_batch(images_u8, labels_all, rows, mean, std, augment, gen)

        idx = np.asarray(idx, dtype=np.int32)
        if device.type != "cuda":
            return _loop(train_step, state,
                         (gather(torch.from_numpy(r), generator) for r in idx),
                         generator)
        blocker = _graph_blocker(model, state.optimizer)
        if blocker:
            raise NotImplementedError(f"make_gather_multi_step on the GPU: {blocker}")
        k = idx.shape[0]
        lrs = _lr_table(state.schedule, state.step, k)
        packed = _to_card(np.concatenate([idx.reshape(-1), lrs.view(np.int32)]), device)
        data = (images_u8, labels_all, mean, std)
        losses, corrects = replays((id(state), idx.shape, *map(id, data)),
                                   _k_step_body(run, state, k, gather), (packed,),
                                   generator, pins=(state, *data))
        state.step += k
        return state, losses, corrects

    gather_step.augment = augment
    return gather_step


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


def make_gather_multi_eval(model: nn.Module,
                           device: Union[str, torch.device, None] = None
                           ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """K eval forwards per call with the batch assembly inside (the eval
    mirror of `make_gather_multi_step`, no augmentation):
    `gather_eval(images_u8, labels_all, mean, std, idx [K, B]) -> (losses
    [K], corrects [K], preds [K, B])`, in eval mode under
    `torch.inference_mode()`. On the GPU one CUDA graph per (K, B) and
    dataset, captured under inference mode; the [K, B] indices are the
    only host-to-device copy of a call.
    """
    device = resolve_device(device)
    _check_on(model, device, "eval")
    replays = _Replays(device, inference=True) if device.type == "cuda" else None

    def body(idx, images_u8, labels_all, mean, std):
        model.eval()
        losses, corrects, preds = [], [], []
        for rows in idx:
            x, y = _gather_batch(images_u8, labels_all, rows, mean, std, None, None)
            logits = model(x)
            p = logits.argmax(dim=-1)
            losses.append(cross_entropy_loss(logits, y))
            corrects.append((p == y).sum())
            preds.append(p)
        return torch.stack(losses), torch.stack(corrects), torch.stack(preds)

    def gather_eval(images_u8, labels_all, mean, std, idx):
        idx = np.asarray(idx, dtype=np.int32)
        data = (images_u8, labels_all, mean, std)
        if replays is None:
            with torch.inference_mode():
                return body(torch.from_numpy(idx), *data)
        return replays((idx.shape, *map(id, data)), lambda i, _: body(i, *data),
                       (_to_card(idx, device),), pins=data)

    return gather_eval


# ─── epoch and evaluation loops ─────────────────────────────────────────

def _index_chunks(order: np.ndarray, bs: int, n: int, drop_last: bool,
                  fused_steps: int) -> List[np.ndarray]:
    """Cut an epoch's index order into rectangular [K, B] chunks (plus one
    [1, rem] tail chunk when the dataset keeps partial batches)."""
    n_full = n // bs
    full = np.asarray(order[: n_full * bs]).reshape(n_full, bs)
    chunks = [full[i: i + fused_steps] for i in range(0, n_full, fused_steps)]
    rem = n - n_full * bs
    if rem and not drop_last:
        chunks.append(np.asarray(order[n_full * bs:]).reshape(1, rem))
    return chunks


class _EpochMetrics:
    """Loss and correct counts summed on the device, read by the host only
    for a progress line and once at the end."""

    def __init__(self, epoch: int, n_batches: int, log_interval_frac: float,
                 verbose: bool):
        self.t0 = time.perf_counter()
        self.epoch, self.n_batches, self.verbose = epoch, n_batches, verbose
        self.log_every = max(1, int(n_batches * log_interval_frac))
        self.loss, self.correct, self.seen, self.done = 0.0, 0, 0, 0

    def add(self, losses, corrects, steps: int, batch: int, k: int = 1) -> None:
        """`steps` steps of `batch` samples; prints when the log point
        falls in this chunk of up to `k` steps."""
        self.loss = self.loss + losses.sum() * batch
        self.correct = self.correct + corrects.sum()
        self.seen += steps * batch
        self.done += steps
        if self.verbose and self.done % self.log_every < k:
            print(f"  epoch {self.epoch} [{self.done}/{self.n_batches}] "
                  f"loss {float(self.loss) / self.seen:.4f} "
                  f"acc {100.0 * float(self.correct) / self.seen:.2f}% "
                  f"({time.perf_counter() - self.t0:.1f}s)", flush=True)

    def result(self, state: TrainState) -> Dict[str, float]:
        # one host read that also depends on a parameter, so it waits for
        # the last step's backward and update, not only its forward
        leaf = next(state.model.parameters())
        final_loss = float(self.loss + 0.0 * leaf.detach().float().sum())
        seen = max(1, self.seen)
        return {"loss": final_loss / seen,
                "accuracy": 100.0 * float(self.correct) / seen,
                "time": time.perf_counter() - self.t0,
                "samples": self.seen}


def train_epoch(state: TrainState, train_step: Optional[Callable], dataset,
                generator: torch.Generator, epoch: int = 0,
                log_interval_frac: float = 0.02, verbose: bool = True,
                multi_step: Optional[Callable] = None, fused_steps: int = 1,
                gather_step: Optional[Callable] = None
                ) -> Tuple[TrainState, Dict[str, float]]:
    """One epoch: `train_step` per batch of `dataset` (an iterable of
    (images, labels), e.g. a `DeviceDataset`), loss and accuracy summed on
    the device, a progress line every ~2% of batches in the JAX package's
    format. Returns (state, {loss, accuracy (%), time, samples}).

    With `multi_step` (`make_multi_step`) and `fused_steps=K` > 1, batches
    are buffered and stacked, K per call (a shorter tail when the batch
    shape changes or the epoch ends). With `gather_step`
    (`make_gather_multi_step`), `fused_steps=K` > 1 and a `DeviceDataset`,
    the epoch's index order is cut into [K, B] chunks (`_index_chunks`)
    and each chunk's batches are gathered inside the call.
    """
    if gather_step is not None and fused_steps > 1 and hasattr(dataset, "images"):
        return _train_epoch_gather_fused(state, gather_step, dataset, generator,
                                         epoch, fused_steps, log_interval_frac,
                                         verbose)
    if multi_step is not None and fused_steps > 1:
        return _train_epoch_fused(state, multi_step, dataset, generator, epoch,
                                  fused_steps, log_interval_frac, verbose)
    metrics = _EpochMetrics(epoch, len(dataset), log_interval_frac, verbose)
    for images, labels in dataset:
        state, loss, correct = train_step(state, images, labels, generator)
        metrics.add(loss, correct, 1, images.shape[0])
    return state, metrics.result(state)


def _train_epoch_fused(state, multi_step, dataset, generator, epoch, fused_steps,
                       log_interval_frac, verbose):
    """The K-step loop of `train_epoch`: buffers up to `fused_steps`
    same-shape batches, stacks them and runs one multi_step per chunk,
    flushing early where the batch shape changes, so every chunk is
    rectangular."""
    metrics = _EpochMetrics(epoch, len(dataset), log_interval_frac, verbose)
    buf_x, buf_y = [], []

    def flush():
        nonlocal state
        if buf_x:
            state, losses, corrects = multi_step(state, torch.stack(buf_x),
                                                 torch.stack(buf_y), generator)
            metrics.add(losses, corrects, len(buf_x), buf_x[0].shape[0], fused_steps)
            buf_x.clear()
            buf_y.clear()

    for images, labels in dataset:
        if buf_x and images.shape != buf_x[0].shape:
            flush()
        buf_x.append(images)
        buf_y.append(labels)
        if len(buf_x) == fused_steps:
            flush()
    flush()
    return state, metrics.result(state)


def _train_epoch_gather_fused(state, gather_step, dataset, generator, epoch,
                              fused_steps, log_interval_frac, verbose):
    """The gather-fused loop of `train_epoch`: the epoch's index order in
    [K, B] chunks, each one gather_step call; a partial last batch (when
    the dataset keeps it) is its own [1, rem] chunk. The augmentation is the
    step's (`make_gather_multi_step(augment=...)`) and must be the dataset's,
    which the other loops apply."""
    step_augment = getattr(gather_step, "augment", None)
    data_augment = getattr(dataset, "augment", None)
    if step_augment != data_augment:
        raise ValueError(f"gather_step augments with {step_augment!r} but the dataset "
                         f"with {data_augment!r}: build the step with "
                         "make_gather_multi_step(model, augment=dataset.augment)")
    metrics = _EpochMetrics(epoch, len(dataset), log_interval_frac, verbose)
    for chunk in _index_chunks(dataset.epoch_order(), dataset.batch_size,
                               dataset.n, dataset.drop_last, fused_steps):
        state, losses, corrects = gather_step(
            state, dataset.images, dataset.labels, dataset.mean, dataset.std,
            chunk, generator)
        metrics.add(losses, corrects, chunk.shape[0], chunk.shape[1], fused_steps)
    return state, metrics.result(state)


def evaluate(eval_step: Callable, dataset, num_classes: Optional[int] = None,
             detailed: bool = False, gather_eval: Optional[Callable] = None,
             fused_steps: int = 1) -> Dict[str, float]:
    """Full-split evaluation with `eval_step` (`make_eval_step`, which binds
    the model: pass `make_eval_step(state.eval_view())` to evaluate an EMA)
    over `dataset`: {loss, accuracy (%), samples}, and with `detailed` the
    precision / recall / F1 and confusion matrix of `metrics.py` (their
    fraction-scale accuracy dropped, the percentage kept). With
    `gather_eval` (`make_gather_multi_eval`), `fused_steps=K` > 1 and a
    `DeviceDataset`, the split runs in [K, B] index chunks.
    """
    if gather_eval is not None and fused_steps > 1 and hasattr(dataset, "images"):
        chunks = _index_chunks(np.arange(dataset.n), dataset.batch_size,
                               dataset.n, dataset.drop_last, fused_steps)
        outs = [(gather_eval(dataset.images, dataset.labels, dataset.mean,
                             dataset.std, c), c) for c in chunks]
        parts = [(losses.sum() * c.shape[1], corrects.sum(), c.size, preds.reshape(-1))
                 for (losses, corrects, preds), c in outs]
        labels = None
        if detailed:
            used = torch.from_numpy(np.concatenate([c.reshape(-1) for c in chunks]))
            labels = dataset.labels.index_select(0, used.to(dataset.labels.device))
    else:
        parts, all_labels = [], []
        for images, y in dataset:
            loss, correct, preds = eval_step(images, y)
            parts.append((loss * images.shape[0], correct, images.shape[0], preds))
            all_labels.append(torch.as_tensor(y))
        labels = torch.cat(all_labels) if detailed and all_labels else None
    seen = max(1, sum(p[2] for p in parts))
    out = {"loss": float(sum(p[0] for p in parts)) / seen,
           "accuracy": 100.0 * float(sum(p[1] for p in parts)) / seen,
           "samples": sum(p[2] for p in parts)}
    if detailed and parts:
        from .metrics import compute_classification_metrics

        preds = torch.cat([p[3] for p in parts])
        detail = compute_classification_metrics(preds, labels.to(preds.device),
                                                num_classes)
        # keep the percentage accuracy above; the detailed dict's is a
        # 0-1 fraction
        detail.pop("accuracy", None)
        out.update(detail)
    return out
