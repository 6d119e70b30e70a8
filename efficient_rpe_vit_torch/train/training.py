"""Loss, LR schedules, optimisers, the train and eval steps, the fused
K-step programs, the epoch / evaluation loops and the inference benchmark.

Counterpart of `efficient_rpe_vit_tpu/train/training.py`: the same
schedule vocabulary with optax's values at every step, adam / adamw / sgd
with optax's update rules, a train state with an optional EMA shadow, a
train step (forward, backward, update) with label smoothing and gradient
accumulation over microbatches, `make_multi_step` and the gather-fused
`make_gather_multi_step` / `make_gather_multi_eval` (K steps per call),
`train_epoch` / `evaluate` with their fused loops, the ensemble engine
(`create_ensemble_train_state`, the `make_ensemble_*` programs,
`ensemble_train_epoch` / `ensemble_evaluate`: S seeds trained together,
each member its own model, optimiser and generator), and
`make_inference_chain` / `benchmark_inference`. The JAX package
jits one program per step or scans K of them; here a step runs eagerly on
the model's device, updating the model and optimiser in place, and on the
GPU the K-step programs are CUDA graphs (`_Replays`): K full steps
captured once per input shape and replayed by one call (an ensemble's S
members' steps in one graph). Dropout masks and augmentation draws come
from the generator each call is given, one per member in an ensemble.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

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

class SGD(torch.optim.Optimizer):
    """Heavy-ball SGD with optax's rule (`add_decayed_weights` -> `sgd`):
    g' = g + wd p, trace = momentum trace + g', p -= lr trace, the trace
    made at zero with the optimiser.

    Its update is foreach ops on tensors only: `lr` may be a float or a
    0-dim tensor on the parameters' device, which the update multiplies in
    on the device without reading it, so the update can be captured in a
    CUDA graph (`capturable` marks the groups built that way)."""

    def __init__(self, params, lr: Union[float, torch.Tensor], momentum: float = 0.9,
                 weight_decay: float = 0.0, capturable: bool = False):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay, capturable=capturable))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["momentum_buffer"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            traces = [self.state[p]["momentum_buffer"] for p in params]
            torch._foreach_mul_(traces, group["momentum"])
            torch._foreach_add_(traces, grads)
            torch._foreach_sub_(params, torch._foreach_mul(traces, group["lr"]))
        return None


def create_optimizer(optimizer: str, params: Iterable[nn.Parameter],
                     schedule: Schedule, weight_decay: float = 0.0,
                     momentum: float = 0.9) -> torch.optim.Optimizer:
    """adam | adamw | sgd (+momentum 0.9), with optax's update rules:

    * adam: weight decay coupled (added to the gradient before the moments,
      optax's `add_decayed_weights` -> `adam`), betas (0.9, 0.999), eps 1e-8;
    * adamw: decay decoupled, `weight_decay` passed explicitly (torch's
      AdamW default 0.01 is not the config's value);
    * sgd: heavy-ball momentum, trace initialised at zero, coupled decay
      (`SGD`).

    The learning rate is set from `schedule` before every update
    (`TrainState.apply_gradients`); it starts at schedule(0). On the GPU
    every optimiser is built capturable, with the learning rate a 0-dim
    fp32 tensor on the card (and adam's step counts on the card too), so
    that K updates can be captured in one CUDA graph (`make_multi_step`),
    and the eager step takes the same arithmetic as the replayed one.
    """
    params = list(params)
    lr = schedule(0)
    on_card = any(p.is_cuda for p in params)
    if optimizer not in ("adam", "adamw", "sgd"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if on_card:
        lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
    if optimizer == "sgd":
        return SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay,
                   capturable=on_card)
    cls = torch.optim.Adam if optimizer == "adam" else torch.optim.AdamW
    return cls(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
               weight_decay=weight_decay, capturable=on_card)


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


@torch.no_grad()
def copy_module_(dst: nn.Module, src: nn.Module) -> None:
    """Copy every parameter and buffer of `src` into `dst`'s tensor of the
    same name, in place (a captured CUDA graph keeps reading `dst`'s)."""
    theirs = {**dict(src.named_parameters()), **dict(src.named_buffers())}
    ours = [*dst.named_parameters(), *dst.named_buffers()]
    if sorted(theirs) != sorted(name for name, _ in ours):
        raise ValueError(f"{type(src).__name__} and {type(dst).__name__} hold "
                         "different parameters or buffers")
    for name, t in ours:
        t.copy_(theirs[name])


@torch.no_grad()
def reset_train_state(state: TrainState, template: nn.Module) -> TrainState:
    """Make `state` what `create_train_state` makes for `template` (a freshly
    built model of the same structure) without moving a tensor: the
    template's parameters and buffers are copied into `state.model`, every
    optimiser state tensor (moments, momentum traces, the capturable step
    counts) is zeroed, the learning rate is set back to schedule(0), the
    update count to 0 and the EMA shadow to the parameters. A CUDA graph
    captured for the state then computes a fresh state's steps."""
    copy_module_(state.model, template)
    for per_param in state.optimizer.state.values():
        for value in per_param.values():
            if isinstance(value, torch.Tensor):
                value.zero_()
    lr = state.schedule(0)
    for group in state.optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr
    state.step = 0
    if state.ema_params is not None:
        for name, p in state.model.named_parameters():
            state.ema_params[name].copy_(p)
    return state


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
    value. Random draws come from generators of the graph's own, one for
    each generator the caller passes (one, or a tuple of them: an
    ensemble's members each draw from their own), all registered with the
    graph: before each replay each takes its caller generator's state and
    after it gives the advanced state back, so the caller's generators
    move on as they would over the eager steps and the next replay draws
    new masks. The body gets the graph's generators in the form the
    caller gave its own. `before_capture`, when set, is called
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
                 generator: Union[torch.Generator, Tuple[torch.Generator, ...], None] = None,
                 pins=()):
        callers = (() if generator is None else (generator,)
                   if isinstance(generator, torch.Generator) else tuple(generator))
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
            owns = tuple(torch.Generator(self.device) for _ in callers)
            graph = torch.cuda.CUDAGraph()
            for own in owns:
                graph.register_generator_state(own)
            given = (None if generator is None else owns[0]
                     if isinstance(generator, torch.Generator) else owns)
            with torch.cuda.graph(graph):
                static_out = self._run(body, static, given)
            self.graphs[key] = (graph, static, static_out, owns, pins)
            return out
        graph, static, static_out, owns, _ = entry
        for dst, src in zip(static, copied):
            dst.copy_(src)
        for own, caller in zip(owns, callers):
            own.set_state(caller.get_state())
        graph.replay()
        for own, caller in zip(owns, callers):
            caller.set_state(own.get_state())
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
    (one not built by `create_optimizer` for the card). On the CPU the K
    steps run as a loop of the train step.
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
    gather_step.replays = replays
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

    def gather_eval(images_u8, labels_all, mean, std, idx):
        idx = np.asarray(idx, dtype=np.int32)
        data = (images_u8, labels_all, mean, std)
        if replays is None:
            with torch.inference_mode():
                return _eval_chunk(model, torch.from_numpy(idx), *data)
        return replays((idx.shape, *map(id, data)), lambda i, _: _eval_chunk(model, i, *data),
                       (_to_card(idx, device),), pins=data)

    return gather_eval


def _eval_chunk(model: nn.Module, idx, images_u8, labels_all, mean, std):
    """K eval forwards of `model` over the rows idx [K, B]: (losses [K],
    corrects [K], preds [K, B])."""
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


# ─── ensembles: S members, each its own model, optimiser and generator ──

@dataclass
class EnsembleTrainState:
    """S members trained together (`create_ensemble_train_state`): member i
    is `members[i]`, a `TrainState` of its own model, optimiser, schedule,
    update count and EMA shadow. The JAX package stacks the members' arrays
    and vmaps one member's program over them; here each member keeps its
    module and runs its own steps, and on the GPU the `make_ensemble_*`
    programs capture all members' steps in one CUDA graph."""

    members: List[TrainState]

    def __len__(self) -> int:
        return len(self.members)

    def eval_view(self) -> List[nn.Module]:
        """Each member's `TrainState.eval_view()`: its EMA copy, refreshed
        in place, or its model."""
        return [member.eval_view() for member in self.members]


def _structure(model: nn.Module):
    return (type(model), [(n, tuple(t.shape), t.dtype, t.device) for n, t in
                          [*model.named_parameters(), *model.named_buffers()]])


def create_ensemble_train_state(models: Sequence[nn.Module], config,
                                steps_per_epoch: int = 100,
                                ema_decay: float = 0.0) -> EnsembleTrainState:
    """Train states for S seeds at once: one `create_train_state` per model
    of `models`, which the caller builds, each from its own seed, as the
    train CLI builds its one model. The members share one optimiser
    configuration and one step program, so models that differ in structure
    (class, parameter or buffer names, shapes, dtypes or devices) are
    refused, as is one model passed twice."""
    models = list(models)
    if not models:
        raise ValueError("an ensemble needs at least one member")
    if len({id(m) for m in models}) != len(models):
        raise ValueError("each ensemble member needs a model of its own")
    layout = _structure(models[0])
    for i, model in enumerate(models[1:], 1):
        if _structure(model) != layout:
            raise ValueError(f"ensemble member {i} differs in structure from member 0: "
                             "the members share one optimiser configuration and one "
                             "step program")
    return EnsembleTrainState([create_train_state(m, config, steps_per_epoch, ema_decay)
                               for m in models])


def ensemble_member(state: EnsembleTrainState, i: int) -> TrainState:
    """Member i's `TrainState`, the member itself (not a copy): saving it
    checkpoints that seed's model, `eval_view()` serves it."""
    return state.members[i]


def _check_ensemble(state: EnsembleTrainState, models: List[nn.Module],
                    generators, device: torch.device, step: str) -> None:
    if len(state.members) != len(models) or any(
            m.model is not model for m, model in zip(state.members, models)):
        raise ValueError("the ensemble state was created for other models")
    if len(generators) != len(models):
        raise ValueError(f"{len(generators)} generators for {len(models)} members")
    for i, member in enumerate(state.members):
        _check_call(member, models[i], generators[i], device)
    if device.type == "cuda":
        for i, member in enumerate(state.members):
            blocker = _graph_blocker(member.model, member.optimizer)
            if blocker:
                raise NotImplementedError(f"{step} on the GPU: member {i}: {blocker}")


def _member_lr_tables(state: EnsembleTrainState, k: int) -> np.ndarray:
    """[S, K] fp32: each member's learning rates of its next K updates."""
    return np.stack([_lr_table(m.schedule, m.step, k) for m in state.members])


def _stacked(outs) -> Tuple[torch.Tensor, ...]:
    """Per-member tuples of tensors -> one tensor per position, stacked
    over the members."""
    return tuple(torch.stack(t) for t in zip(*outs))


def make_ensemble_train_step(models: Sequence[nn.Module], label_smoothing: float = 0.0,
                             mesh=None, member_axis: str = "data",
                             device: Union[str, torch.device, None] = None
                             ) -> Callable[..., Tuple[EnsembleTrainState, torch.Tensor,
                                                      torch.Tensor]]:
    """One train step of every member on a shared batch: `ensemble_step(state,
    images, labels, generators) -> (state, losses [S], corrects [S])`,
    member i's step `make_train_step`'s with `generators[i]` (its dropout
    masks and redrawn features). On the GPU all S steps are one CUDA graph
    per batch shape (`_Replays`, one registered generator per member); on
    the CPU they run one after the other. `mesh` (members sharded over
    `member_axis`) is not ported."""
    if mesh is not None:
        raise NotImplementedError(
            f"make_ensemble_train_step over a mesh ({member_axis!r} axis) is not ported: "
            "the multi-device paths come with the parallelism slice (ROADMAP.md Queue A #7)")
    device = resolve_device(device)
    models = list(models)
    steps = [make_train_step(m, label_smoothing=label_smoothing, device=device)
             for m in models]
    runs = [_step_body(m, 1, label_smoothing) for m in models]
    replays = _Replays(device)

    def ensemble_step(state: EnsembleTrainState, images, labels, generators):
        _check_ensemble(state, models, generators, device, "make_ensemble_train_step")
        if device.type != "cuda":
            outs = [steps[i](m, images, labels, generators[i])[1:]
                    for i, m in enumerate(state.members)]
            return (state, *_stacked(outs))
        images = torch.as_tensor(images, device=device)
        labels = torch.as_tensor(labels, device=device)
        lrs = _to_card(_member_lr_tables(state, 1), device)

        def body(images, labels, lrs, gens):
            return _stacked([runs[i](m, images, labels, gens[i], lrs[i, 0])
                             for i, m in enumerate(state.members)])

        key = (id(state), tuple(images.shape), images.dtype, tuple(labels.shape), labels.dtype)
        losses, corrects = replays(key, body, (images, labels, lrs), tuple(generators),
                                   pins=(state,))
        for member in state.members:
            member.step += 1
        return state, losses, corrects

    return ensemble_step


def make_ensemble_gather_multi_step(models: Sequence[nn.Module], label_smoothing: float = 0.0,
                                    augment: Optional[str] = None,
                                    per_member_order: bool = False,
                                    device: Union[str, torch.device, None] = None
                                    ) -> Callable[..., Tuple[EnsembleTrainState,
                                                             torch.Tensor, torch.Tensor]]:
    """K gather-fused train steps of every member per call:
    `ens_gather_step(state, images_u8, labels_all, mean, std, idx,
    generators) -> (state, losses [S, K], corrects [S, K])`. Member i
    gathers its rows, augments from `generators[i]` and runs K full steps:
    what `make_gather_multi_step`'s step computes for it alone.

    `per_member_order` False: idx is [K, B], shared by the members; True:
    idx is [S, K, B], each member's own (`ensemble_train_epoch`'s
    `member_rngs`). On the GPU all S x K steps are one CUDA graph per
    (S, K, B) and dataset, and the only host-to-device copy of a call is one
    int32 vector: the indices and the members' K learning rates. On the CPU
    each member's K steps run as its own loop."""
    device = resolve_device(device)
    models = list(models)
    singles = [make_gather_multi_step(m, label_smoothing, augment, device) for m in models]
    runs = [_step_body(m, 1, label_smoothing) for m in models]
    replays = _Replays(device)
    order_dims = 3 if per_member_order else 2

    def ens_gather_step(state: EnsembleTrainState, images_u8, labels_all, mean, std, idx,
                        generators):
        _check_ensemble(state, models, generators, device, "make_ensemble_gather_multi_step")
        idx = np.asarray(idx, dtype=np.int32)
        n = len(models)
        if idx.ndim != order_dims or (per_member_order and idx.shape[0] != n):
            raise ValueError(f"idx of shape {idx.shape}: expected "
                             f"{f'[{n}, K, B]' if per_member_order else '[K, B]'} "
                             f"(per_member_order={per_member_order})")
        if device.type != "cuda":
            outs = [singles[i](m, images_u8, labels_all, mean, std,
                               idx[i] if per_member_order else idx, generators[i])[1:]
                    for i, m in enumerate(state.members)]
            return (state, *_stacked(outs))
        k = idx.shape[-2]
        lrs = _member_lr_tables(state, k)
        packed = _to_card(np.concatenate([idx.reshape(-1), lrs.reshape(-1).view(np.int32)]),
                          device)
        data = (images_u8, labels_all, mean, std)

        def steps(packed, gens):
            rows = packed[:idx.size].view(idx.shape)
            lr = packed[idx.size:].view(torch.float32).view(n, k)
            outs = []
            for i, member in enumerate(state.members):
                own = rows[i] if per_member_order else rows
                member_outs = []
                for j in range(k):
                    x, y = _gather_batch(images_u8, labels_all, own[j], mean, std, augment,
                                         gens[i])
                    member_outs.append(runs[i](member, x, y, gens[i], lr[i, j]))
                outs.append(_stacked(member_outs))
            return _stacked(outs)

        losses, corrects = replays((id(state), idx.shape, *map(id, data)), steps, (packed,),
                                   tuple(generators), pins=(state, *data))
        for member in state.members:
            member.step += k
        return state, losses, corrects

    ens_gather_step.augment = augment
    ens_gather_step.per_member_order = per_member_order
    ens_gather_step.replays = replays
    return ens_gather_step


def make_ensemble_gather_multi_eval(models: Sequence[nn.Module],
                                    device: Union[str, torch.device, None] = None
                                    ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor,
                                                             torch.Tensor]]:
    """K eval forwards of every member per call, the members sharing the
    eval order: `ens_eval(images_u8, labels_all, mean, std, idx [K, B]) ->
    (losses [S, K], corrects [S, K], preds [S, K, B])`, member i's what
    `make_gather_multi_eval(models[i])` returns. Pass the members' eval
    views (`EnsembleTrainState.eval_view()`) to evaluate their EMA shadows.
    On the GPU one inference-mode CUDA graph per chunk shape and dataset."""
    device = resolve_device(device)
    models = list(models)
    singles = [make_gather_multi_eval(m, device) for m in models]
    replays = _Replays(device, inference=True)

    def ens_eval(images_u8, labels_all, mean, std, idx):
        if device.type != "cuda":
            return _stacked([single(images_u8, labels_all, mean, std, idx)
                             for single in singles])
        idx = np.asarray(idx, dtype=np.int32)
        data = (images_u8, labels_all, mean, std)
        return replays((idx.shape, *map(id, data)),
                       lambda i, _: _stacked([_eval_chunk(m, i, *data) for m in models]),
                       (_to_card(idx, device),), pins=data)

    return ens_eval


def _member_sums(totals, outs, scale: int) -> None:
    """Add each member's row of `outs` [S, K] to its running total as its
    own loop does: the row's sum (taken from a fresh copy, aligned as a
    single model's output is, so the reduction is the same) times `scale`."""
    for i in range(len(totals)):
        totals[i] = totals[i] + outs[i].clone().sum() * scale


def _read_members(losses, corrects, leaves=()) -> Tuple[List[float], List[float]]:
    """One host read of the members' loss and correct totals (with
    `leaves`, loss i plus 0 times a sum of a parameter of member i, so the
    read waits for its last update, as `_EpochMetrics.result` does)."""
    loss = [torch.as_tensor(t) for t in losses]
    if leaves:
        loss = [t + 0.0 * leaf.detach().float().sum() for t, leaf in zip(loss, leaves)]
    device = loss[0].device
    both = torch.cat([torch.stack([t.to(device) for t in loss]).double(),
                      torch.stack([torch.as_tensor(c).to(device) for c in corrects]).double()])
    host = both.tolist()
    return host[:len(loss)], host[len(loss):]


def ensemble_train_epoch(state: EnsembleTrainState, ens_gather_step: Callable, dataset,
                         generators: Sequence[torch.Generator], n_members: int,
                         epoch: int = 0, fused_steps: int = 64,
                         member_rngs: Optional[List[np.random.Generator]] = None,
                         verbose: bool = True) -> Tuple[EnsembleTrainState, Dict]:
    """One epoch of every member through `ens_gather_step`
    (`make_ensemble_gather_multi_step`) over a `DeviceDataset`, in [K, B]
    chunks of `fused_steps`. Returns (state, {loss, accuracy: length-S lists,
    time, samples: per member}).

    With `member_rngs` (S numpy Generators the caller keeps across epochs)
    each member draws its own epoch permutation: seeded
    `np.random.default_rng(seed_i)`, member i sees the order a sequential
    run of seed i sees (`DeviceDataset`'s stream), and the step must be
    built with `per_member_order=True`. Without them the order is the
    dataset's, shared. Each member's loss and correct count are summed as
    `train_epoch` sums one model's, and read by the host once, at the end.
    """
    if len(generators) != n_members or len(state) != n_members:
        raise ValueError(f"{len(generators)} generators and {len(state)} members for "
                         f"n_members={n_members}")
    if getattr(ens_gather_step, "augment", None) != getattr(dataset, "augment", None):
        raise ValueError("the ensemble step must augment as the dataset does: build it "
                         "with make_ensemble_gather_multi_step(..., augment=dataset.augment)")
    if getattr(ens_gather_step, "per_member_order", member_rngs is not None) != (
            member_rngs is not None):
        raise ValueError("member_rngs needs a step built with per_member_order=True, and "
                         "a shared order one built with per_member_order=False")
    t0 = time.perf_counter()
    if member_rngs is not None:
        if len(member_rngs) != n_members:
            raise ValueError(f"member_rngs has {len(member_rngs)} generators for "
                             f"{n_members} members")
        per_member = [_index_chunks(g.permutation(dataset.n) if dataset.shuffle
                                    else np.arange(dataset.n), dataset.batch_size,
                                    dataset.n, dataset.drop_last, fused_steps)
                      for g in member_rngs]
        # the members' chunks have the same shapes: each stack is [S, K, B]
        chunks = [np.stack(cs) for cs in zip(*per_member)]
    else:
        chunks = _index_chunks(dataset.epoch_order(), dataset.batch_size, dataset.n,
                               dataset.drop_last, fused_steps)
    loss, correct, seen = [0.0] * n_members, [0] * n_members, 0
    for chunk in chunks:
        state, losses, corrects = ens_gather_step(
            state, dataset.images, dataset.labels, dataset.mean, dataset.std, chunk,
            generators)
        _member_sums(loss, losses, chunk.shape[-1])
        _member_sums(correct, corrects, 1)
        seen += chunk.shape[-2] * chunk.shape[-1]
    loss, correct = _read_members(
        loss, correct, [next(m.model.parameters()) for m in state.members])
    total = max(1, seen)
    elapsed = time.perf_counter() - t0
    accuracy = [100.0 * c / total for c in correct]
    if verbose:
        print(f"  epoch {epoch} [ensemble x{n_members}] acc {min(accuracy):.2f}-"
              f"{max(accuracy):.2f}% ({elapsed:.1f}s)", flush=True)
    return state, {"loss": [v / total for v in loss], "accuracy": accuracy,
                   "time": elapsed, "samples": seen}


def ensemble_evaluate(ens_gather_eval: Callable, dataset, n_members: int,
                      fused_steps: int = 64) -> Dict:
    """Full-split evaluation of every member with `ens_gather_eval`
    (`make_ensemble_gather_multi_eval`) over a `DeviceDataset` in [K, B]
    chunks: {loss, accuracy: length-S lists, samples}, each member's as the
    gather-fused `evaluate` takes one model's, one host read in all."""
    chunks = _index_chunks(np.arange(dataset.n), dataset.batch_size, dataset.n,
                           dataset.drop_last, fused_steps)
    loss, correct, seen = [0] * n_members, [0] * n_members, 0
    for chunk in chunks:
        losses, corrects, _ = ens_gather_eval(dataset.images, dataset.labels, dataset.mean,
                                              dataset.std, chunk)
        _member_sums(loss, losses, chunk.shape[1])
        _member_sums(correct, corrects, 1)
        seen += chunk.size
    if not chunks:
        return {"loss": [0.0] * n_members, "accuracy": [0.0] * n_members, "samples": 0}
    loss, correct = _read_members(loss, correct)
    total = max(1, seen)
    return {"loss": [v / total for v in loss],
            "accuracy": [100.0 * c / total for c in correct],
            "samples": seen}


# ─── inference benchmark ────────────────────────────────────────────────

def make_inference_chain(model: nn.Module) -> Callable[[torch.Tensor, int], torch.Tensor]:
    """`chain(images, length) -> scalar`: `length` data-dependent eval
    forwards of `model` under `torch.inference_mode()`, each one's input
    images + 1e-30 * sum(previous logits), so no forward can start before
    the one it depends on has finished or be skipped; the result is one
    scalar for one host read at the end. `length` is an argument, so one
    chain serves every length."""

    def chain(images: torch.Tensor, length: int) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            x = images
            for _ in range(int(length)):
                out = model(x)
                x = images + (1e-30 * out.float().sum()).to(images.dtype)
            return x.sum()

    return chain


def _latency_stats(samples: List[float], batch: int) -> Dict[str, float]:
    lat = np.asarray(samples, np.float64)
    mean = float(lat.mean())
    return {
        "latency_mean_ms": mean * 1e3,
        "latency_std_ms": float(lat.std()) * 1e3,
        "latency_min_ms": float(lat.min()) * 1e3,
        "latency_max_ms": float(lat.max()) * 1e3,
        "latency_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "latency_ms_per_sample": mean * 1e3 / batch,
    }


class _Clock:
    """Seconds of device work between `start()` and `stop()`: CUDA events
    on the GPU (the stop waits for the event), the host clock around a
    finished host read on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.begin = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self.begin.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self, result: torch.Tensor) -> float:
        if self.cuda:
            self.end.record()
            float(result)
            self.end.synchronize()
            return self.begin.elapsed_time(self.end) / 1e3
        float(result)
        return time.perf_counter() - self.t0


def benchmark_inference(
    model: nn.Module,
    images: torch.Tensor,
    num_warmup: int = 10,
    num_iterations: int = 100,
    fwd: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    mode: str = "chained",
    num_chains: int = 10,
    chain_fn: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None,
    target_chain_time: Optional[float] = None,
) -> Dict[str, float]:
    """Latency and throughput of eval forwards of `model` (which carries its
    weights: pass `state.eval_view()` to serve an EMA) on one fixed batch.

    mode='chained' (default): `num_chains` chains of data-dependent
    forwards (`make_inference_chain`, or `chain_fn`), one host read per
    chain; per-iteration latency is the chain's time divided by its length,
    and the statistics are over the chains. The chain length starts at
    num_iterations // num_chains and grows until a chain takes
    `target_chain_time` seconds (default max(8 x the host-read round trip,
    50 ms)); 0 pins it at the start length. mode='per_iter': `num_warmup`
    forwards, then `num_iterations` timed one by one (`fwd`, default the
    model's eval forward), each ended by a host read.

    On the GPU every time is taken with CUDA events after the warm-up; on
    the CPU with the host clock, less the round trip of a host read (a
    CPU time, never a device measurement). `fetch_rt_ms` is that round
    trip; `peak_memory_bytes` (the GPU's allocator peak) is there on the
    GPU only. The keys are the JAX package's.
    """
    from ..utils.timing import device_memory_stats

    device = images.device
    batch = images.shape[0]
    clock = _Clock(device)

    def measure_rt() -> float:
        ready = torch.zeros((), device=device)
        float(ready)
        rts = []
        for _ in range(5):
            t0 = time.perf_counter()
            float(ready.sum())
            rts.append(time.perf_counter() - t0)
        return sorted(rts)[len(rts) // 2]

    def elapsed(run) -> float:
        clock.start()
        seconds = clock.stop(run())
        return seconds if clock.cuda else max(0.0, seconds - rt)

    def memory() -> Dict[str, int]:
        peak = device_memory_stats(device).get("peak_bytes_in_use")
        return {} if peak is None else {"peak_memory_bytes": peak}

    if mode == "chained":
        chain = chain_fn if chain_fn is not None else make_inference_chain(model)
        chain_len = max(1, num_iterations // num_chains)
        float(chain(images, chain_len))  # warm-up (and kernel builds)
        float(chain(images, chain_len))
        rt = measure_rt()
        if target_chain_time is None:
            target_chain_time = max(8.0 * rt, 0.05)
        max_chain_len = 65536
        if target_chain_time > 0:
            for _ in range(12):
                probe = elapsed(lambda: chain(images, chain_len))
                if probe >= target_chain_time or chain_len >= max_chain_len:
                    break
                if probe < 0.5 * rt:
                    chain_len = min(max_chain_len, chain_len * 4)
                else:
                    est = int(math.ceil(target_chain_time / (probe / chain_len)))
                    chain_len = min(max_chain_len, max(chain_len + 1, est))
        samples = [elapsed(lambda: chain(images, chain_len)) / chain_len
                   for _ in range(num_chains)]
        clipped = sum(1 for s in samples if s == 0.0)
        mean = float(np.mean(samples))
        return {
            # chains whose host time fell below the read's round trip clip
            # to 0: the chain is too short for the clock (CPU only)
            **({"clipped_chains": clipped} if clipped else {}),
            **memory(),
            "mode": "chained",
            "chain_length": chain_len,
            "num_chains": num_chains,
            "fetch_rt_ms": rt * 1e3,
            "throughput_images_per_sec": batch / max(mean, 1e-9),
            **_latency_stats(samples, batch),
            "batch_size": batch,
            "num_iterations": num_chains * chain_len,
        }
    if mode != "per_iter":
        raise ValueError(f"unknown mode {mode!r}: 'chained' or 'per_iter'")

    if fwd is None:
        def fwd(x):
            model.eval()
            with torch.inference_mode():
                return model(x)

    out = fwd(images)
    for _ in range(max(0, num_warmup - 1)):
        out = fwd(images)
    float(out.float().sum())
    rt = measure_rt()
    samples = [elapsed(lambda: fwd(images).float().sum()) for _ in range(num_iterations)]
    total = max(float(np.sum(samples)), 1e-9)
    return {
        **memory(),
        "mode": "per_iter",
        "fetch_rt_ms": rt * 1e3,
        "throughput_images_per_sec": batch * num_iterations / total,
        **_latency_stats(samples, batch),
        "batch_size": batch,
        "num_iterations": num_iterations,
    }
