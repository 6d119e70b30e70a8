"""GPipe pipeline parallelism over a 'pipe' mesh axis.

Counterpart of `efficient_rpe_vit_tpu/parallel/pipeline.py`. The JAX
package runs the stage ring as one SPMD program (`shard_map` + `lax.scan`
+ `ppermute`) and lets reverse-mode AD replay it backwards; here every
rank is a process that runs its own stage and trades activations with its
neighbours, and the backward is built in.

What each rank holds (`stage_model`, the counterpart of
`stack_block_variables` / `pipeline_spec`): pipe rank s of S keeps blocks
[s * depth / S, (s + 1) * depth / S) under their own state-dict names
(`transformer_blocks.{i}.*`) and the optimiser state of what it keeps;
the other blocks are `RemoteBlock` placeholders that hold no tensor. The
embedding and the head (`ViT.embed`, `ViT.head`) are replicated on every
pipe rank. On a 'model' axis the kept blocks are Megatron-split by
`shard_model`'s rules. A checkpoint is the whole model, gathered over the
pipe ranks (`train_parallel.full_payload` through `PipelineTrainState`),
so it loads into the single-process model.

The schedule (`pipeline_blocks`): GPipe over M microbatches, M = S by
default. Stage 0 takes microbatch m from the embedding, every other stage
receives it from stage s - 1; a stage runs its blocks and sends the result
to stage s + 1. The last stage's outputs reach every pipe rank through an
all-reduce over the pipe group to which the other stages add zeros (the
JAX package's `psum` broadcast), so the head and the loss are computed
alike everywhere. The backward reverses the schedule, microbatches M - 1
down to 0. No bubble tick runs anything (the JAX scan pushes zeros through
the blocks on them): a stage runs its depth / S blocks M times in a
forward and M times in a backward, so the KERPLE forward kernel launches
(depth / S) * M times a step on each rank, and so does each backward
kernel.

Messages: `comm.send_to` / `comm.recv_from` between pipe neighbours, in
one fixed order on both sides of every pair: the forward's activations from
s to s + 1 in microbatch order, then the backward's gradients from s + 1 to
s in the reverse order. Sends are posted without waiting and received in
the order they were posted; the stages form a chain, not a ring, so no two
ranks wait on each other. gloo stages CUDA tensors through host memory and
logs it once; NCCL never does.

Gradients: every parameter's gradient is the sequential model's. Every pipe
rank computes the same loss on the same outputs, so the head's gradient is
that one loss's, summed over nothing; the embedding's comes from stage 0's
backward alone and is summed over the pipe group, where the other stages
add zeros (`reduce_pipeline_grads`).

Composition, as in JAX: on a 'data' axis data rank i runs rows
[i * mb / d, (i + 1) * mb / d) of every microbatch of mb rows (JAX's
P(None, 'data')), and when d does not divide mb every data rank runs the
whole microbatch; the train step averages the gradients over 'data'. A
'model' axis splits each stage's blocks (DP x PP x TP). Soft-MoE blocks
run as they are. 'seq' and 'expert' axes and FSDP are refused.

Dropout follows the JAX rule: one draw per block, shared by the
microbatches. Each forward draws `depth` seeds from the step's generator on
every rank (so the ranks' generators stay in step), block b draws its
masks, attention-dropout seed and redrawn features from a generator seeded
with seed b, and a `DrawTape` per block keeps microbatch 0's draws and gives
them back to the other microbatches (the feature redraw runs on microbatch
0 only). Pipelined training therefore matches the sequential model in
distribution, not bit for bit, when dropout > 0. Blocks run without remat,
as JAX's `make_block_apply` builds them.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, fields
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..models.dense import DrawTape, batch_shard
from ..train.training import _check_call, _check_on, cross_entropy_loss
from . import comm
from .comm import Shard
from .mesh import Mesh, local_slice, param_layouts, shard_model
from .train_parallel import (
    ParallelTrainState,
    _average_grads,
    _check_state,
    _reduce_metrics,
    create_sharded_train_state,
)

BLOCKS = "transformer_blocks."
HEAD = "mlp_head."


@dataclass(frozen=True)
class PipeStage:
    """A staged model's place on the 'pipe' axis: the axis's shard and
    the blocks [lo, hi) it keeps."""

    shard: Shard
    lo: int
    hi: int

    @property
    def blocks(self) -> range:
        return range(self.lo, self.hi)


class RemoteBlock(nn.Module):
    """The place of a block that another pipe stage holds: no tensors."""

    def __init__(self, index: int, stage: int):
        super().__init__()
        self.index, self.stage = index, stage

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"transformer block {self.index} lives on pipe stage "
                           f"{self.stage}: run the model with pipeline_vit_forward")


def _stage(model: nn.Module) -> PipeStage:
    stage = getattr(model, "stage", None)
    if stage is None:
        raise ValueError("the model is not staged over a 'pipe' axis (stage_model)")
    return stage


def stage_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Make `model` (the full model, built alike on every rank) this rank's
    pipeline stage on the mesh's 'pipe' axis, in place: the blocks of the
    other stages become `RemoteBlock`s, the kept ones are split over
    'model' by `shard_model`. A model staged already is left as it is.
    Call it before the optimiser is made."""
    if getattr(model, "stage", None) is not None:
        return model
    if "pipe" not in mesh:
        raise ValueError(f"the mesh {mesh.shape} has no 'pipe' axis")
    for other in ("seq", "expert"):
        if mesh.size(other) > 1:
            raise ValueError(f"a 'pipe' axis does not compose with a {other!r} axis")
    S, s = mesh.size("pipe"), mesh.index("pipe")
    depth = len(model.transformer_blocks)
    if depth % S:
        raise ValueError(f"depth {depth} not divisible by {S} stages")
    per = depth // S
    lo, hi = s * per, (s + 1) * per
    for i in range(depth):
        if not lo <= i < hi:
            model.transformer_blocks[i] = RemoteBlock(i, i // per)
    model.stage = PipeStage(mesh.shard("pipe"), lo, hi)
    return shard_model(model, mesh)


def stage_state_dict(model: nn.Module, state_dict) -> Dict[str, torch.Tensor]:
    """This rank's part of the whole model's state dict: the staged
    model's own names, each tensor split as the model splits it."""
    layouts = param_layouts(model)
    out = {}
    for name in model.state_dict():
        t = state_dict[name]
        if name in layouts:
            shard, dim, blocks = layouts[name]
            t = local_slice(t, dim, blocks, shard.index, shard.count)
        out[name] = t
    return out


class PipelineTrainState(ParallelTrainState):
    """A `ParallelTrainState` of one pipeline stage: its step takes the
    global batch, and its checkpoint views and parameter count are the
    whole model's (collectives over the pipe group)."""

    def batch_rows(self, batch: int) -> slice:
        return slice(None)  # the step takes each data rank's rows itself

    def _whole_count(self, counts: Dict[str, int]) -> int:
        """The blocks' parameters summed over the pipe group, the rest once."""
        blocks = sum(n for name, n in counts.items() if name.startswith(BLOCKS))
        rest = sum(counts.values()) - blocks
        shard = _stage(self.model).shard
        if shard.count > 1:
            t = comm.all_reduce(torch.tensor([blocks], dtype=torch.float64,
                                             device=self.model.pos_embedding.device),
                                shard.group)
            blocks = int(t.item())
        return rest + blocks

    def _join(self, payload: Dict) -> Dict:
        return join_stages(self, payload)

    def _select(self, payload: Dict) -> Dict:
        return select_stage(self, payload)


def create_pipeline_train_state(model: nn.Module, config, mesh: Mesh,
                                steps_per_epoch: int = 100, ema_decay: float = 0.0,
                                state_dict=None) -> PipelineTrainState:
    """The train state of this rank's stage: `model` (the full model,
    built alike on every rank) staged in place (`stage_model`), its part of
    `state_dict` (the whole model's, e.g. `flax_to_state_dict` of carried
    weights) loaded when given, and `create_sharded_train_state`'s
    optimiser, schedule and EMA over the stage's parameters."""
    stage_model(model, mesh)
    if state_dict is not None:
        model.load_state_dict(stage_state_dict(model, state_dict), strict=True)
    state = create_sharded_train_state(model, config, mesh, steps_per_epoch=steps_per_epoch,
                                       ema_decay=ema_decay)
    return PipelineTrainState(**{f.name: getattr(state, f.name) for f in fields(state)})


# ─── the schedule ───────────────────────────────────────────────────────

class _Schedule:
    """One GPipe pass of this rank's stage over M microbatches of `rows`
    rows; keeps each microbatch's graph for the backward."""

    def __init__(self, model: nn.Module, M: int, rows: int, generator, data_part):
        stage = _stage(model)
        self.M, self.data_part = M, data_part
        self.blocks = [model.transformer_blocks[b] for b in stage.blocks]
        shard = stage.shard
        self.group, self.S, self.s = shard.group, shard.count, shard.index
        self.prev = dist.get_global_rank(self.group, self.s - 1) if self.s > 0 else None
        self.next = dist.get_global_rank(self.group, self.s + 1) if self.s < self.S - 1 else None
        self.shape = (rows, model.num_patches + 1, model.pos_embedding.shape[-1])
        self.dtype = model.compute_dtype
        self.device = model.pos_embedding.device
        self.gens: List[Optional[torch.Generator]] = [None] * len(self.blocks)
        self.tapes: Optional[List[DrawTape]] = None
        if model.training and generator is not None:
            seeds = torch.randint(0, 2 ** 62, (len(model.transformer_blocks),),
                                  generator=generator, device=generator.device).tolist()
            self.gens = [torch.Generator(device=self.device).manual_seed(seeds[b])
                         for b in stage.blocks]
            self.tapes = [DrawTape() for _ in self.blocks]
        self.inputs: List[torch.Tensor] = []
        self.outputs: List[torch.Tensor] = []

    @property
    def first(self) -> bool:
        return self.s == 0

    @property
    def last(self) -> bool:
        return self.s == self.S - 1

    def run_stage(self, x: torch.Tensor) -> torch.Tensor:
        with batch_shard(*self.data_part):
            for i, block in enumerate(self.blocks):
                with self.tapes[i].active() if self.tapes else contextlib.nullcontext():
                    x = block(x, self.gens[i])
        return x

    def forward(self, h: Optional[torch.Tensor], grad: bool) -> torch.Tensor:
        """h: [M, rows, N, C] on stage 0. Returns the last stage's outputs
        [M, rows, N, C] on every pipe rank."""
        outs, pending = [], []
        for m in range(self.M):
            if self.first:
                x = h[m].detach().requires_grad_(h.requires_grad) if grad else h[m]
            else:
                x = comm.recv_from(self.shape, self.dtype, self.device, self.prev, self.group)
                x.requires_grad_(grad)
            y = self.run_stage(x)
            if self.last:
                outs.append(y.detach())
            else:
                pending.append(comm.send_to(y.detach(), self.next, self.group))
            if grad:
                self.inputs.append(x)
                self.outputs.append(y)
        comm.wait(pending)
        if self.S == 1:
            return torch.stack(outs)
        out = (torch.stack(outs) if self.last
               else torch.zeros((self.M, *self.shape), dtype=self.dtype, device=self.device))
        return comm.all_reduce(out, self.group)

    def backward(self, g: torch.Tensor) -> Optional[torch.Tensor]:
        """g: the gradient of the returned outputs (used on the last stage
        only). Returns the gradient of stage 0's input, None elsewhere."""
        grads: List[Optional[torch.Tensor]] = [None] * self.M
        pending = []
        for m in reversed(range(self.M)):
            gy = (g[m] if self.last else
                  comm.recv_from(self.shape, self.dtype, self.device, self.next, self.group))
            torch.autograd.backward(self.outputs[m], gy)
            gx = self.inputs[m].grad
            if self.first:
                grads[m] = gx
            else:
                pending.append(comm.send_to(gx, self.prev, self.group))
            self.inputs[m] = self.outputs[m] = None
        comm.wait(pending)
        if not self.first or grads[0] is None:
            return None
        return torch.stack(grads)


class _GPipe(torch.autograd.Function):
    """The schedule as one differentiable op: its inputs are stage 0's
    embedding output (an empty tensor elsewhere) and the stage's
    parameters, whose gradients the backward accumulates in their `.grad`
    as it runs each microbatch's graph."""

    @staticmethod
    def forward(ctx, schedule: _Schedule, h: torch.Tensor, *params):
        ctx.schedule, ctx.n_params = schedule, len(params)
        with torch.enable_grad():
            return schedule.forward(h if schedule.first else None, grad=True)

    @staticmethod
    def backward(ctx, g):
        gh = ctx.schedule.backward(g.contiguous())
        ctx.schedule = None
        return (None, gh, *([None] * ctx.n_params))


def pipeline_blocks(model: nn.Module, h: Optional[torch.Tensor], n_microbatches: int,
                    rows: int, generator: Optional[torch.Generator] = None,
                    data_part=(0, 1)) -> torch.Tensor:
    """Run the staged model's block stack as a GPipe pipeline.

    h: [M, rows, N, C], stage 0's embedding output for M microbatches of
    `rows` rows (ignored on the other stages); `data_part` the (index,
    count) of the rows within a microbatch (`batch_shard`). Returns
    [M, rows, N, C] on every pipe rank, equal to the blocks applied in
    order; differentiable when grad mode is on.
    """
    schedule = _Schedule(model, n_microbatches, rows, generator, data_part)
    params = [p for b in schedule.blocks for p in b.parameters() if p.requires_grad]
    if not torch.is_grad_enabled() or not params:
        return schedule.forward(h, grad=False)
    if h is None:
        h = torch.empty(0, device=schedule.device)
    return _GPipe.apply(schedule, h, *params)


def _layout(model: nn.Module, B: int, mesh: Mesh, n_microbatches: Optional[int]):
    """(M, mb, rows, (data index, count)) of a global batch of B rows."""
    S = _stage(model).shard.count
    depth = len(model.transformer_blocks)
    if depth % S:
        raise ValueError(f"depth {depth} not divisible by {S} stages")
    M = n_microbatches or S
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    mb = B // M
    d, i = mesh.size("data"), mesh.index("data")
    if mb % d:
        d, i = 1, 0  # the microbatch does not split: every data rank runs it whole
    return M, mb, mb // d, (i, d)


def _local_logits(model: nn.Module, x: torch.Tensor, mesh: Mesh,
                  n_microbatches: Optional[int], generator):
    """This rank's rows' logits [M * rows, K] of the global batch x, and
    the index of those rows in x."""
    B = x.shape[0]
    M, mb, rows, (i, d) = _layout(model, B, mesh, n_microbatches)
    index = (torch.arange(B, device=x.device).view(M, mb)[:, i * rows:(i + 1) * rows]
             .reshape(-1))
    h = None
    if _stage(model).shard.index == 0:
        h = model.embed(x[index])
        h = h.view(M, rows, *h.shape[1:])
    out = pipeline_blocks(model, h, M, rows, generator, (i, d))
    return model.head(out.reshape(M * rows, *out.shape[2:])), index, (M, rows, d)


def pipeline_vit_forward(model: nn.Module, x: torch.Tensor, mesh: Mesh,
                         n_microbatches: Optional[int] = None,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The staged model's forward with its block stack pipelined over the
    'pipe' axis: x [B, H, W, C], the global batch on every rank, ->
    logits [B, K] on every rank, equal to the sequential model's (at
    dropout 0; `generator` feeds a train-mode forward). On a 'data' axis
    each data rank runs its rows of every microbatch and the logits are
    gathered over the axis; the backward of that gather keeps this rank's
    rows, so a loss computed alike on every rank leaves each data rank the
    part of the gradient its rows give."""
    from .comm import gather_seq

    x = torch.as_tensor(x, device=mesh.device)
    logits, _, (M, rows, d) = _local_logits(model, x, mesh, n_microbatches, generator)
    if d == 1:
        return logits
    gathered = gather_seq(logits.view(M, rows, -1), mesh.get_group("data"), dim=1)
    return gathered.reshape(x.shape[0], -1)


@torch.no_grad()
def reduce_pipeline_grads(model: nn.Module) -> None:
    """Complete the gradients of a pipelined backward: the embedding's
    summed over the pipe group (stage 0's; the other stages add zeros).
    The mean over 'data' is the train state's update."""
    stage = _stage(model)
    if stage.shard.count > 1:
        embed = [p for n, p in model.named_parameters() if not n.startswith((BLOCKS, HEAD))]
        for p in embed:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _average_grads(embed, stage.shard.group, 1)


# ─── steps ──────────────────────────────────────────────────────────────

def make_pipeline_train_step(model: nn.Module, mesh: Mesh, state=None,
                             n_microbatches: Optional[int] = None, grad_accum: int = 1
                             ) -> Callable:
    """The pipelined train step `(state, images, labels, generator) ->
    (state, loss, correct)`, `make_parallel_train_step`'s contract except
    that images [B, ...] and labels [B] are the global batch on every rank
    (the step takes each data rank's rows of every microbatch itself); loss
    and correct are the global batch's. `state` is the stage's
    (`create_pipeline_train_state`). `grad_accum` = A > 1 runs A chunks of
    B / A rows, each a full GPipe forward and backward, then one update
    with the chunks' mean gradient; each chunk draws its own dropout."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    _stage(model)
    if state is not None:
        _check_state(state, mesh)
    device = mesh.device
    _check_on(model, device, "train")
    params = [p for p in model.parameters() if p.requires_grad]

    def pipeline_step(state, images, labels, generator: torch.Generator):
        _check_call(state, model, generator, device)
        _check_state(state, mesh)
        images = torch.as_tensor(images, device=device)
        labels = torch.as_tensor(labels, device=device)
        B = images.shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} not divisible by grad_accum {grad_accum}")
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum, correct, split = 0.0, 0, 1
        for x, y in zip(images.chunk(grad_accum), labels.chunk(grad_accum)):
            logits, index, (_, _, split) = _local_logits(model, x, mesh, n_microbatches,
                                                         generator)
            loss = cross_entropy_loss(logits, y[index])
            loss.backward()
            loss_sum = loss_sum + loss.detach()
            correct = correct + (logits.argmax(dim=-1) == y[index]).sum()
        if grad_accum > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.div_(grad_accum)
        reduce_pipeline_grads(model)  # the data mean is the state's update
        state._update(state.schedule(state.step))
        state.step += 1
        loss = loss_sum / grad_accum
        if split > 1:
            loss, correct = _reduce_metrics(loss, correct, mesh.get_group("data"), split)
        return state, loss, correct

    return pipeline_step


def make_pipeline_eval_step(model: nn.Module, mesh: Mesh,
                            n_microbatches: Optional[int] = None) -> Callable:
    """`make_eval_step` through the pipeline: `(images, labels) -> (loss,
    correct, preds)` of the global batch on every rank; a batch that the
    microbatch count does not divide runs as one microbatch."""
    M = n_microbatches or _stage(model).shard.count

    def eval_step(images, labels):
        model.eval()
        with torch.inference_mode():
            images = torch.as_tensor(images, device=mesh.device)
            labels = torch.as_tensor(labels, device=mesh.device)
            m = M if images.shape[0] % M == 0 else 1
            logits = pipeline_vit_forward(model, images, mesh, m)
            loss = cross_entropy_loss(logits, labels)
            preds = logits.argmax(dim=-1)
            correct = (preds == labels).sum()
        return loss, correct, preds

    return eval_step


def make_pipeline_inference_chain(model: nn.Module, mesh: Mesh,
                                  n_microbatches: Optional[int] = None
                                  ) -> Callable[[torch.Tensor, int], torch.Tensor]:
    """`training.make_inference_chain` through the pipeline: `length`
    data-dependent eval forwards, every rank taking part in each."""
    M = n_microbatches or _stage(model).shard.count

    def chain(images: torch.Tensor, length: int) -> torch.Tensor:
        model.eval()
        m = M if images.shape[0] % M == 0 else 1
        with torch.inference_mode():
            x = images
            for _ in range(int(length)):
                out = pipeline_vit_forward(model, x, mesh, m)
                x = images + (1e-30 * out.float().sum()).to(images.dtype)
            return x.sum()

    return chain


# ─── whole-model views for checkpoints ──────────────────────────────────

def _split_names(names: Sequence[str]):
    """(names before the first block's, the blocks', names after)."""
    first = next((k for k, n in enumerate(names) if n.startswith(BLOCKS)), len(names))
    last = max((k for k, n in enumerate(names) if n.startswith(BLOCKS)), default=first - 1)
    return list(names[:first]), list(names[first:last + 1]), list(names[last + 1:])


def join_stages(state, payload: Dict) -> Dict:
    """The whole model's payload from every pipe stage's (a collective
    over the pipe group): model and EMA tensors by name, the optimiser
    state re-indexed in the whole model's parameter order. On the CPU."""
    stage = _stage(state.model)
    names = state.param_names
    def cpu(t):
        return t.cpu() if torch.is_tensor(t) else t

    mine = {"model": {n: cpu(t) for n, t in payload["model"].items()},
            "opt": {names[int(i)]: {k: cpu(v) for k, v in per.items()}
                    for i, per in payload["optimizer"]["state"].items()},
            "ema": ({n: cpu(t) for n, t in payload["ema_params"].items()}
                    if payload.get("ema_params") is not None else None),
            "names": names}
    if stage.shard.count == 1:
        parts = [mine]
    else:
        parts = [None] * stage.shard.count
        dist.all_gather_object(parts, mine, group=stage.shard.group)

    def merge(dicts):
        keys = [list(d) for d in dicts]
        head, _, tail = _split_names(keys[0])
        out = {k: dicts[0][k] for k in head}
        for d, ks in zip(dicts, keys):
            out.update((k, d[k]) for k in _split_names(ks)[1])
        out.update((k, dicts[0][k]) for k in tail)
        return out

    head, _, tail = _split_names(parts[0]["names"])
    full_names = head + [n for p in parts for n in _split_names(p["names"])[1]] + tail
    opt_by_name = {n: per for p in parts for n, per in p["opt"].items()}
    opt = dict(payload["optimizer"])
    opt["state"] = {k: opt_by_name[n] for k, n in enumerate(full_names) if n in opt_by_name}
    opt["param_groups"] = [dict(g, params=list(range(len(full_names))))
                           for g in opt["param_groups"]]
    out = dict(payload, model=merge([p["model"] for p in parts]), optimizer=opt)
    if mine["ema"] is not None:
        out["ema_params"] = merge([p["ema"] for p in parts])
    return out


def select_stage(state, payload: Dict) -> Dict:
    """The part of a whole-model payload that this stage holds: its
    names' tensors and its parameters' optimiser state, re-indexed in the
    stage's parameter order (the split over 'model' is applied after)."""
    stage = _stage(state.model)
    own = set(state.model.state_dict())
    local_params = state.param_names
    is_param = set(local_params)
    first = f"{BLOCKS}{stage.lo}."

    def param(name: str) -> bool:
        if name.startswith(BLOCKS):
            rest = name[len(BLOCKS):].split(".", 1)[1]
            return first + rest in is_param
        return name in is_param

    full_names = [n for n in payload["model"] if param(n)]
    index = {n: k for k, n in enumerate(full_names)}
    saved = {int(k): v for k, v in payload["optimizer"]["state"].items()}
    opt = dict(payload["optimizer"])
    opt["state"] = {i: saved[index[n]] for i, n in enumerate(local_params)
                    if index[n] in saved}
    opt["param_groups"] = [dict(g, params=list(range(len(local_params))))
                           for g in opt["param_groups"]]
    out = dict(payload, model={n: t for n, t in payload["model"].items() if n in own},
               optimizer=opt)
    if payload.get("ema_params") is not None:
        out["ema_params"] = {n: t for n, t in payload["ema_params"].items() if n in is_param}
    return out

