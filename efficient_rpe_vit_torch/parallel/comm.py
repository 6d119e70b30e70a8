"""Collectives over a process group, and the autograd functions that the
JAX package gets from XLA's sharding annotations.

The JAX package names a sharding and lets XLA insert the collectives; here
each one is written out as a `torch.autograd.Function` over a
`torch.distributed` process group:

  * the Megatron pair: `copy_to_group` (identity forward, all-reduce
    backward) where a replicated activation enters rank-local work, and
    `reduce_from_group` (all-reduce forward, identity backward) where the
    ranks' partial results are summed into a replicated one;
  * `psum`: all-reduce forward and backward, for a sum whose consumers
    are rank-local (the sequence-parallel linear attention's summaries);
  * the sequence pair: `scatter_seq` (forward: this rank's slice of a
    replicated tensor; backward: all-gather the gradient) and `gather_seq`
    (forward: all-gather; backward: this rank's slice of the gradient,
    without a sum, because every rank computes the same loss downstream);
  * `ring_exchange`: send to rank + 1 and receive from rank - 1 in one
    `batch_isend_irecv`;
  * `send_to` / `recv_from`: one point-to-point message to or from a
    neighbour (the GPipe stages' activations and their gradients).

Backends: NCCL when each rank owns a card, gloo on the CPU and for several
ranks that share one card. gloo takes CUDA tensors itself for the
collectives in `GLOO_CUDA_OPS` (its CUDA work copies through host memory
inside the op); its point-to-point ops refuse them (torch 2.11: "Bad
address"), so `ring_exchange`, `send_to` and `recv_from` copy a CUDA
tensor to host memory, send it and copy the received one back, which is
logged once per op. That is chosen
by the backend, never as a fallback: NCCL never stages.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Sequence

import torch
import torch.distributed as dist

# the gloo ops that take CUDA tensors themselves; the rest are staged here
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"})

_log = logging.getLogger(__name__)
_staged: set = set()


@dataclass(frozen=True)
class Shard:
    """A module's place on one mesh axis: the axis's process group, this
    rank's index on it and the axis size. Copies of a module share it."""

    group: object
    index: int
    count: int

    def __deepcopy__(self, memo):
        return self


def staged_ops() -> frozenset:
    """The ops that have gone through host memory in this process."""
    return frozenset(_staged)


def _via_host(t: torch.Tensor, group, op: str) -> bool:
    if not t.is_cuda or op in GLOO_CUDA_OPS or dist.get_backend(group) != "gloo":
        return False
    if op not in _staged:
        _staged.add(op)
        _log.warning("gloo %s of CUDA tensors goes through host memory", op)
    return True


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a contiguous tensor; returns it."""
    if _via_host(t, group, "all_reduce"):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors concatenated along dim 0, in rank order."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    if _via_host(t, group, "all_gather_into_tensor"):
        host = t.new_empty((n * t.shape[0], *t.shape[1:]), device="cpu")
        dist.all_gather_into_tensor(host, t.cpu(), group=group)
        return host.to(t.device)
    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's 1/P of dim 0 of the group's sum of `t`."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    shape = (t.shape[0] // n, *t.shape[1:])
    if _via_host(t, group, "reduce_scatter_tensor"):
        host = t.new_empty(shape, device="cpu")
        dist.reduce_scatter_tensor(host, t.cpu(), group=group)
        return host.to(t.device)
    out = t.new_empty(shape)
    dist.reduce_scatter_tensor(out, t, group=group)
    return out


def ring_exchange(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Send each tensor to the next rank of the group and receive the
    previous rank's, in one batch; returns the received tensors."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    tensors = [t.contiguous() for t in tensors]
    staged = _via_host(tensors[0], group, "batch_isend_irecv")
    sends = [t.cpu() if staged else t for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recvs, tensors)] if staged else recvs


def send_to(t: torch.Tensor, peer: int, group):
    """Post the send of `t` to global rank `peer`; returns the pending
    (work, buffer) for `wait`, which keeps the buffer alive until then."""
    t = t.contiguous()
    if _via_host(t, group, "send"):
        t = t.cpu()
    return dist.isend(t, peer, group=group), t


def recv_from(shape, dtype: torch.dtype, device: torch.device, peer: int,
              group) -> torch.Tensor:
    """Receive a tensor of `shape` and `dtype` from global rank `peer`,
    onto `device`."""
    buf = torch.empty(shape, dtype=dtype, device=device)
    if _via_host(buf, group, "recv"):
        host = torch.empty(shape, dtype=dtype)
        dist.recv(host, peer, group=group)
        return host.to(device)
    dist.recv(buf, peer, group=group)
    return buf


def wait(pending) -> None:
    """Wait for the sends `send_to` posted."""
    for work, _ in pending:
        work.wait()


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, me = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim=dim)[me].contiguous()


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return all_gather(x.movedim(dim, 0), group).movedim(0, dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the ranks' gradients."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' sum; the backward passes the gradient through."""
    return _ReduceFromGroup.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' sum; the backward sums the ranks' gradients."""
    return _Psum.apply(x, group)


def scatter_seq(x: torch.Tensor, group, dim: int = 2) -> torch.Tensor:
    """This rank's 1/P of a replicated tensor along `dim`; the backward
    all-gathers the gradient."""
    return _ScatterSeq.apply(x, group, dim)


def gather_seq(x: torch.Tensor, group, dim: int = 2) -> torch.Tensor:
    """The ranks' slices concatenated along `dim`; the backward takes this
    rank's slice of the gradient."""
    return _GatherSeq.apply(x, group, dim)
