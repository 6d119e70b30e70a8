"""Linear, LayerNorm and Dropout layers.

Parameters stay fp32 and are cast to the compute dtype where they are
used, as flax's `nn.Dense(dtype=...)` does in the JAX package;
LayerNorm takes its statistics in fp32 and returns the compute dtype.
State-dict names are torch's own (`weight`, `bias`). Dropout draws its
masks from a generator the caller passes, never from torch's global RNG,
through `draw`, which lets a recomputed block (`ViT(remat=True)`) take
back the draws of its first run.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch import nn


def torch_dtype(name: str) -> torch.dtype:
    """'float32' | 'bfloat16' -> torch dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


class DrawTape:
    """The random draws of one checkpointed block call, in order.

    The block's first run keeps each draw (`draw` appends it); each later
    run, the recompute in the backward, takes them back in the same order
    instead of drawing, so it sees the forward's dropout masks and seeds and
    leaves the generator where the forward left it. Inside a CUDA-graph
    capture a generator's state cannot be saved and restored (`set_state`
    refuses there, `get_state` does not see the offsets a capture advances,
    and `graphsafe_get_state` shares the state rather than copying it), so
    the draws themselves are kept: boolean masks, which a dropout's
    backward keeps in any case, and int32 seeds."""

    def __init__(self):
        self.draws: List[torch.Tensor] = []
        self.runs = 0
        self.pos = 0

    @property
    def replaying(self) -> bool:
        return self.runs > 1

    @contextlib.contextmanager
    def active(self) -> Iterator["DrawTape"]:
        """Make this tape the one `draw` uses on this thread, for one run of
        the block (the recompute runs on the autograd engine's thread)."""
        previous = _current_tape()
        _ACTIVE.tape = self
        self.runs += 1
        self.pos = 0
        try:
            yield self
        finally:
            _ACTIVE.tape = previous


# the tape of the block run in progress on each thread: the draws happen
# deep inside the block's modules, which take no tape argument
_ACTIVE = threading.local()


def _current_tape() -> Optional[DrawTape]:
    return getattr(_ACTIVE, "tape", None)


def draw(make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """`make()`, a random draw from the caller's generator; inside a block
    run under a `DrawTape`, kept on the first run and taken back on a
    recompute."""
    tape = _current_tape()
    if tape is None:
        return make()
    if tape.replaying:
        tape.pos += 1
        return tape.draws[tape.pos - 1]
    tape.draws.append(make())
    return tape.draws[-1]


def replaying() -> bool:
    """True while a checkpointed block is being recomputed: work with side
    effects (the feature redraw and its counter) must not run again."""
    tape = _current_tape()
    return tape is not None and tape.replaying


class Dense(nn.Linear):
    """nn.Linear that computes in `compute_dtype`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with fp32 statistics and output in `compute_dtype`."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype)


class Dropout(nn.Dropout):
    """Dropout whose mask comes from an explicit generator, as flax's
    `nn.Dropout` takes its 'dropout' rng: in train mode with p > 0, keep
    each element with probability 1-p and scale it by 1/(1-p); identity
    otherwise."""

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("train-mode dropout needs a generator: pass one "
                             "to the model's forward")
        keep_prob = 1.0 - self.p
        keep = draw(lambda: torch.rand(x.shape, generator=generator,
                                       device=x.device) < keep_prob)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))
