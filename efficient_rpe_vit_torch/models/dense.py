"""Linear and LayerNorm layers under the compute-dtype policy.

Parameters stay fp32 and are cast to the compute dtype where they are
used, as flax's `nn.Dense(dtype=...)` does in the JAX package;
LayerNorm takes its statistics in fp32 and returns the compute dtype.
State-dict names are torch's own (`weight`, `bias`).
"""

from __future__ import annotations

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
