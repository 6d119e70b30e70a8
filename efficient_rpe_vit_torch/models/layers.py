"""Shared model layers: MLP and the pre-norm transformer block.

Counterpart of `efficient_rpe_vit_tpu/models/layers.py`:
x + attn(LN(x), rpe) then x + mlp(LN(x)), with the RPE threaded INTO the
attention call (KERPLE runs inside the kernelised-attention math). Only
the dense MLP is ported; the soft-MoE MLP comes with the parallelism slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from .attention import ATTENTION_REGISTRY
from .dense import Dense, Dropout, LayerNorm
from .rpe import RPE_REGISTRY


class Mlp(nn.Sequential):
    """Linear -> GELU(exact erf) -> Dropout -> Linear -> Dropout; the
    linears are `mlp.0` and `mlp.3` in a state dict. The dropout masks come
    from the generator passed to forward."""

    def __init__(self, dim: int, mlp_dim: int, dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(
            Dense(dim, mlp_dim, compute_dtype=compute_dtype),
            nn.GELU(approximate="none"),
            Dropout(dropout),
            Dense(mlp_dim, dim, compute_dtype=compute_dtype),
            Dropout(dropout),
        )

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self:
            x = layer(x, generator) if isinstance(layer, Dropout) else layer(x)
        return x


class TransformerBlock(nn.Module):
    """Pre-norm transformer block with its own attention and RPE instance.

    LayerNorm statistics stay fp32; outputs are in the compute dtype.
    """

    def __init__(self, dim: int, heads: int, mlp_dim: int, num_patches: int,
                 dropout: float = 0.0, attention_type: str = "favor_plus",
                 rpe_type: Optional[str] = None,
                 attention_kwargs: Optional[Dict[str, Any]] = None,
                 rpe_kwargs: Optional[Dict[str, Any]] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attention = ATTENTION_REGISTRY[attention_type](
            dim=dim, heads=heads, dropout=dropout, compute_dtype=compute_dtype,
            **(attention_kwargs or {}))
        self.rpe = (
            RPE_REGISTRY[rpe_type](num_patches=num_patches, dim=dim,
                                   heads=heads, **(rpe_kwargs or {}))
            if rpe_type is not None else None
        )
        self.norm1 = LayerNorm(dim, eps=1e-5, compute_dtype=compute_dtype)
        self.norm2 = LayerNorm(dim, eps=1e-5, compute_dtype=compute_dtype)
        self.mlp = Mlp(dim, mlp_dim, dropout, compute_dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None,
                return_attention: bool = False):
        """`generator` feeds dropout and feature redraw in train mode. With
        return_attention, returns (x, the attention's probabilities)."""
        out = self.attention(self.norm1(x), mask=mask, rpe=self.rpe,
                             return_attention=return_attention,
                             generator=generator)
        weights = None
        if return_attention:
            out, weights = out
        x = x + out
        x = x + self.mlp(self.norm2(x), generator)
        return (x, weights) if return_attention else x
