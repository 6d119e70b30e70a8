"""Linear, LayerNorm and Dropout layers.

Parameters stay fp32 and are cast to the compute dtype where they are
used, as flax's `nn.Dense(dtype=...)` does in the JAX package;
LayerNorm takes its statistics in fp32 and returns the compute dtype.
State-dict names are torch's own (`weight`, `bias`). Dropout draws its
masks from a generator the caller passes, never from torch's global RNG.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def torch_dtype(name: str) -> torch.dtype:
    """'float32' | 'bfloat16' -> torch dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


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
        keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))
