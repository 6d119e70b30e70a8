"""Data-, tensor-, FSDP-, context- and expert-parallel training.

Counterpart of `efficient_rpe_vit_tpu/parallel/train_parallel.py`. The JAX
package jits the step over a mesh and XLA inserts the collectives from the
state's shardings; here every rank runs the port's own step
(`training._step_body`, `make_micro_loss`) on its part of the model and
its rows of the batch, with the collectives written out:

  * the model: every rank builds the same model from the same seed (the
    single-device init) and `shard_model` keeps its tensor-parallel part;
    a model built with `seq_mesh` / `expert_mesh` runs its attention core
    or experts split over those axes;
  * data parallel: each rank of the 'data' axis runs its rows of the global
    batch; after the backward one bucketed all-reduce averages the
    gradients over the axis; the loss and correct count returned are the
    global batch's;
  * FSDP (`fsdp=True`): each parameter, its Adam moments and its EMA
    shadow are kept as this rank's 1/P flat shard (flattened, padded to a
    multiple of P) at rest; the step all-gathers the parameters before the
    forward, reduce-scatters the gradients and the optimiser steps on the
    shards. This flat layout is a layout only; it differs from the JAX
    package's split of each leaf's largest divisible dim;
  * the optimiser and the EMA follow their parameters by identity (a
    moment is made for, and lies like, the tensor it belongs to), never by
    shape;
  * dropout: a rank draws each mask for the whole batch and width from the
    generator that all ranks share and keeps its part (`batch_shard`,
    `Dropout.shard`); the flash kernel's keep-mask seed is folded with the
    data and model rank; a feature redraw draws Omega for all heads and
    keeps this rank's. At dropout 0 the step equals the single-device
    step; with dropout it is stochastically equivalent, as in JAX.

`make_parallel_multi_step` is K steps in one CUDA graph on NCCL
(collectives inside), a loop on the CPU; gloo cannot be captured.
Collectives are explicit, not `DistributedDataParallel` or `fully_shard`,
whose hooks would have to be captured too.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.dense import batch_shard
from ..train.training import (
    TrainState,
    _check_call,
    _check_on,
    _EpochMetrics,
    _graphed_steps,
    _loop,
    _step_body,
    create_lr_scheduler,
    create_optimizer,
    make_eval_step,
)
from . import comm
from .comm import Shard
from .mesh import Mesh, gather_full, local_slice, param_layouts, shard_model
from .multihost import host_batch_slice


class FlatShards:
    """A model's parameters, each kept as this rank's 1/P flat shard of the
    flattened tensor padded to a multiple of P (`shards`, the parameters
    the optimiser sees); the model's own parameters hold no storage at rest
    (`free`) and the full values while a step runs (`gather`)."""

    def __init__(self, model: nn.Module, shard: Shard):
        self.shard = shard
        self.params = list(model.named_parameters())
        self.meta: Dict[str, Tuple[torch.Size, int, int]] = {}
        self.shards: Dict[str, nn.Parameter] = {}
        for name, p in self.params:
            n = p.numel()
            per = math.ceil(n / shard.count)
            self.meta[name] = (p.shape, n, per)
            self.shards[name] = nn.Parameter(self.local(name, p.detach()))
        self.free()

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's flat shard of a full tensor shaped like `name`."""
        _, n, per = self.meta[name]
        flat = F.pad(full.reshape(-1), (0, per * self.shard.count - n))
        return flat[self.shard.index * per:(self.shard.index + 1) * per].clone()

    def full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's flat shard (a collective)."""
        shape, n, _ = self.meta[name]
        return comm.all_gather(local.detach(), self.shard.group)[:n].view(shape)

    @torch.no_grad()
    def gather(self) -> None:
        for name, p in self.params:
            p.data = self.full(name, self.shards[name])

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """Each shard's gradient: this rank's part of the ranks' mean."""
        for name, p in self.params:
            if p.grad is None:
                continue
            _, n, per = self.meta[name]
            flat = F.pad(p.grad.reshape(-1), (0, per * self.shard.count - n))
            self.shards[name].grad = comm.reduce_scatter(flat, self.shard.group).div_(
                self.shard.count)
            p.grad = None

    def free(self) -> None:
        for _, p in self.params:
            p.data = p.data.new_empty(0)


@torch.no_grad()
def _average_grads(params, group, count: int) -> None:
    """One bucketed all-reduce: the gradients' mean over the group."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    comm.all_reduce(flat, group).div_(count)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@dataclass
class ParallelTrainState(TrainState):
    """A `TrainState` on a mesh: the rank's part of the model, the optimiser
    over its parameters (or over their FSDP shards, `fsdp`), the EMA shadow
    likewise, and the gradient reduction over `data_axis` before every
    update."""

    mesh: Optional[Mesh] = None
    data_axis: str = "data"
    fsdp: Optional[FlatShards] = None

    def _update(self, lr) -> None:
        if self.fsdp is not None:
            self.fsdp.reduce_grads()
        elif self.data_axis in self.mesh:
            _average_grads(self.model.parameters(), self.mesh.get_group(self.data_axis),
                           self.mesh.size(self.data_axis))
        super()._update(lr)
        if self.fsdp is not None:
            self.fsdp.free()

    def _stepped(self):
        return self.model.named_parameters() if self.fsdp is None else self.fsdp.shards.items()

    def eval_view(self) -> nn.Module:
        """As `TrainState.eval_view`; under FSDP the model's parameters are
        gathered first (they stay until the next step frees them) and the
        EMA copy gets the gathered shadow."""
        if self.fsdp is None:
            return super().eval_view()
        self.fsdp.gather()
        if self.ema_params is None:
            return self.model
        if self._ema_model is None:
            self._ema_model = copy.deepcopy(self.model)
        with torch.no_grad():
            for name, p in self._ema_model.named_parameters():
                p.data = self.fsdp.full(name, self.ema_params[name]).clone()
            live = dict(self.model.named_buffers())
            for name, b in self._ema_model.named_buffers():
                b.copy_(live[name])
        return self._ema_model

    @property
    def param_names(self):
        return [name for name, _ in self.model.named_parameters()]


def create_sharded_train_state(model: nn.Module, config, mesh: Mesh,
                               steps_per_epoch: int = 100, ema_decay: float = 0.0,
                               fsdp: bool = False, fsdp_axis: str = "data"
                               ) -> ParallelTrainState:
    """The train state of this rank: `model` (built the same on every rank,
    on the mesh's device) made its tensor-parallel part in place
    (`shard_model`), the optimiser and LR schedule of `create_train_state`
    over its parameters, or with `fsdp` over their flat shards on
    `fsdp_axis` (parameters, Adam moments and EMA shadow then take about
    1/P of the bytes), and the EMA shadow when `ema_decay` > 0."""
    shard_model(model, mesh)
    flat = None
    if fsdp:
        if fsdp_axis not in mesh:
            raise ValueError(f"fsdp over {fsdp_axis!r}: the mesh {mesh.shape} has no such axis")
        flat = FlatShards(model, mesh.shard(fsdp_axis))
    owned = dict(model.named_parameters()) if flat is None else flat.shards
    t = config.train
    schedule = create_lr_scheduler(t.scheduler, t.learning_rate, t.epochs, steps_per_epoch,
                                   t.warmup_epochs)
    optimizer = create_optimizer(t.optimizer, owned.values(), schedule, t.weight_decay)
    ema = ({name: p.detach().clone() for name, p in owned.items()}
           if ema_decay > 0 else None)
    return ParallelTrainState(model=model, optimizer=optimizer, schedule=schedule,
                              ema_params=ema, ema_decay=float(ema_decay), mesh=mesh,
                              data_axis=fsdp_axis if fsdp else "data", fsdp=flat)


def _reduce_metrics(loss, correct, group, count: int):
    t = comm.all_reduce(torch.stack([loss.detach().float(), correct.float()]), group)
    return t[0] / count, t[1].to(correct.dtype)


def _parallel_body(model: nn.Module, mesh: Mesh, grad_accum: int, label_smoothing: float,
                   data_axis: str = "data"):
    """`run(state, images, labels, generator, lr) -> (loss, correct)` of one
    sharded step on this rank's rows, the global batch's loss and count
    returned; nothing read back to the host."""
    run = _step_body(model, grad_accum, label_smoothing)
    index, count = mesh.index(data_axis), mesh.size(data_axis)
    group = mesh.get_group(data_axis) if data_axis in mesh else None

    def parallel_run(state, images, labels, generator, lr):
        if state.fsdp is not None:
            state.fsdp.gather()
        with batch_shard(index, count):
            loss, correct = run(state, images, labels, generator, lr)
        if group is None:
            return loss, correct
        return _reduce_metrics(loss, correct, group, count)

    return parallel_run


def _check_state(state, mesh: Mesh) -> None:
    if getattr(state, "mesh", None) is not mesh:
        raise ValueError("the state was not made on this mesh "
                         "(create_sharded_train_state)")


def make_parallel_train_step(model: nn.Module, mesh: Mesh,
                             state: Optional[ParallelTrainState] = None,
                             label_smoothing: float = 0.0, grad_accum: int = 1
                             ) -> Callable:
    """The sharded train step `(state, images, labels, generator) -> (state,
    loss, correct)`: images [B / n_data, ...] and labels are this rank's
    rows of the global batch (`host_batch_slice`), `generator` the one
    every rank seeds alike; loss and correct are the global batch's, as the
    JAX step's replicated outputs. `grad_accum` > 1 splits the rank's rows
    into that many microbatches before one update."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if state is not None:
        _check_state(state, mesh)
    device = mesh.device
    _check_on(model, device, "train")
    run = _parallel_body(model, mesh, grad_accum, label_smoothing)

    def parallel_step(state, images, labels, generator: torch.Generator):
        _check_call(state, model, generator, device)
        _check_state(state, mesh)
        images = torch.as_tensor(images, device=device)
        labels = torch.as_tensor(labels, device=device)
        if images.shape[0] % grad_accum:
            raise ValueError(f"batch {images.shape[0]} not divisible by "
                             f"grad_accum {grad_accum}")
        loss, correct = run(state, images, labels, generator, state.schedule(state.step))
        state.step += 1
        return state, loss, correct

    return parallel_step


def make_parallel_multi_step(model: nn.Module, mesh: Mesh,
                             state: Optional[ParallelTrainState] = None,
                             label_smoothing: float = 0.0) -> Callable:
    """K sharded steps per call: `(state, images [K, B / n_data, ...],
    labels [K, B / n_data], generator) -> (state, losses [K], corrects
    [K])`, equal to K calls of the `make_parallel_train_step` step.

    On the GPU with NCCL the K steps, their collectives included, are one
    CUDA graph per input shape (`training._Replays`, as `make_multi_step`);
    the engine's blockers raise NotImplementedError, and so does a gloo
    group, whose collectives a graph cannot capture. On the CPU a loop.
    """
    step = make_parallel_train_step(model, mesh, state, label_smoothing)
    device = mesh.device
    if device.type != "cuda":
        return lambda state, images, labels, generator: _loop(
            step, state, zip(images, labels), generator)

    def gloo_blocker():
        if dist.get_backend() != "nccl":
            return (f"{dist.get_backend()} collectives cannot be captured in a CUDA "
                    "graph; K steps are captured on NCCL only")
        return None

    graphed = _graphed_steps(model, _parallel_body(model, mesh, 1, label_smoothing), device,
                             "make_parallel_multi_step", gloo_blocker)

    def graphed_parallel_step(state, images, labels, generator):
        _check_state(state, mesh)
        return graphed(state, images, labels, generator)

    graphed_parallel_step.replays = graphed.replays
    return graphed_parallel_step


def parallel_train_epoch(state: ParallelTrainState, train_step: Callable, dataset,
                         generator: torch.Generator, mesh: Mesh,
                         multi_step: Optional[Callable] = None, fused_steps: int = 1,
                         epoch: int = 0, log_interval_frac: float = 0.02,
                         verbose: bool = True) -> Tuple[ParallelTrainState, Dict[str, float]]:
    """One epoch with the sharded step: every rank iterates the same
    dataset order (the same seed), keeps its data rank's rows of each
    batch (`host_batch_slice`) and sums the global batch's loss and count.
    With `multi_step` and `fused_steps` = K > 1 the rows are stacked K
    batches per call (a shorter chunk where the batch shape changes or
    the epoch ends). Returns (state, {loss, accuracy (%), time, samples}),
    the same on every rank."""
    metrics = _EpochMetrics(epoch, len(dataset), log_interval_frac, verbose)
    buf_x, buf_y = [], []
    fused = multi_step is not None and fused_steps > 1

    def flush():
        nonlocal state
        if buf_x:
            state, losses, corrects = multi_step(state, torch.stack(buf_x), torch.stack(buf_y),
                                                 generator)
            metrics.add(losses, corrects, len(buf_x), buf_x[0].shape[0] * mesh.size("data"),
                        fused_steps)
            buf_x.clear()
            buf_y.clear()

    for images, labels in dataset:
        rows = host_batch_slice(images.shape[0], mesh)
        x, y = images[rows], labels[rows]
        if not fused:
            state, loss, correct = train_step(state, x, y, generator)
            metrics.add(loss, correct, 1, images.shape[0])
            continue
        if buf_x and x.shape != buf_x[0].shape:
            flush()
        buf_x.append(x)
        buf_y.append(y)
        if len(buf_x) == fused_steps:
            flush()
    flush()
    return state, metrics.result(state)


def make_parallel_eval_step(model: nn.Module, mesh: Mesh, data_axis: str = "data"
                            ) -> Callable:
    """`make_eval_step` on a mesh: `(images, labels) -> (loss, correct,
    preds)` of a global batch, each data rank evaluating its rows and the
    loss, count and predictions combined over the axis; a batch the axis
    does not divide is evaluated whole by every rank."""
    inner = make_eval_step(model, device=mesh.device)
    count = mesh.size(data_axis)

    def eval_step(images, labels):
        B = images.shape[0]
        if count == 1 or B % count:
            return inner(images, labels)
        rows = host_batch_slice(B, mesh, data_axis)
        loss, correct, preds = inner(images[rows], labels[rows])
        group = mesh.get_group(data_axis)
        with torch.inference_mode():
            sums = comm.all_reduce(torch.stack([loss * (B // count), correct.float()]), group)
            preds = comm.all_gather(preds, group)
        return sums[0] / B, sums[1].to(correct.dtype), preds

    return eval_step


def parameter_count(state: ParallelTrainState) -> Dict[str, int]:
    """`models.count_parameters` of the whole model a sharded state holds a
    part of (every parameter trains)."""
    layouts = param_layouts(state.model)
    total = 0
    for name, p in state.model.named_parameters():
        n = state.fsdp.meta[name][1] if state.fsdp is not None else p.numel()
        total += n * (layouts[name][0].count if name in layouts else 1)
    return {"total": total, "trainable": total, "non_trainable": 0}


# ─── whole-state views for checkpoints ──────────────────────────────────

def _full(state: ParallelTrainState, name: str, local: torch.Tensor, layouts) -> torch.Tensor:
    if state.fsdp is not None and name in state.fsdp.meta:
        local = state.fsdp.full(name, local)
    return gather_full(local, layouts[name]) if name in layouts else local.detach().clone()


def _local(state: ParallelTrainState, name: str, full: torch.Tensor, layouts) -> torch.Tensor:
    if name in layouts:
        shard, dim, blocks = layouts[name]
        full = local_slice(full, dim, blocks, shard.index, shard.count)
    if state.fsdp is not None and name in state.fsdp.meta:
        full = state.fsdp.local(name, full)
    return full


@torch.no_grad()
def full_payload(state: ParallelTrainState) -> Dict:
    """The single-device checkpoint payload of a sharded state (`step`,
    `model`, `optimizer`, `ema_params`), assembled on every rank (a
    collective: every rank calls it)."""
    layouts = param_layouts(state.model)
    owned = dict(state._stepped())
    model_sd = {}
    for name, t in state.model.state_dict().items():
        model_sd[name] = _full(state, name, owned.get(name, t), layouts)
    opt = state.optimizer.state_dict()
    names = state.param_names
    opt["state"] = {i: {k: (_full(state, names[i], v, layouts)
                            if torch.is_tensor(v) and v.dim() > 0 else v)
                        for k, v in per.items()}
                    for i, per in opt["state"].items()}
    payload = {"step": int(state.step), "model": model_sd, "optimizer": opt}
    if state.ema_params is not None:
        payload["ema_params"] = {n: _full(state, n, e, layouts)
                                 for n, e in state.ema_params.items()}
    return payload


@torch.no_grad()
def local_payload(state: ParallelTrainState, payload: Dict) -> Dict:
    """This rank's part of a single-device checkpoint payload, in the
    layout of `state` (model tensors under their own names, FSDP
    parameters as their flat shards)."""
    layouts = param_layouts(state.model)
    out = dict(payload)
    out["model"] = {n: _local(state, n, t, layouts) for n, t in payload["model"].items()}
    opt = dict(payload["optimizer"])
    names = state.param_names
    opt["state"] = {int(i): {k: (_local(state, names[int(i)], v, layouts)
                                 if torch.is_tensor(v) and v.dim() > 0 else v)
                             for k, v in per.items()}
                    for i, per in opt["state"].items()}
    out["optimizer"] = opt
    if payload.get("ema_params") is not None:
        out["ema_params"] = {n: _local(state, n, e, layouts)
                             for n, e in payload["ema_params"].items()}
    return out
