"""Shared model layers: the dense and soft-MoE MLPs and the pre-norm
transformer block.

Counterpart of `efficient_rpe_vit_tpu/models/layers.py`:
x + attn(LN(x), rpe) then x + mlp(LN(x)), with the RPE threaded INTO the
attention call (KERPLE runs inside the kernelised-attention math). The
block's MLP is the dense one or the soft mixture of experts on one device;
sharding the experts over devices (`expert_mesh`) is not ported.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
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


class MoeMlp(nn.Module):
    """Soft mixture of E experts (dense routing), on one device.

    gates = softmax(router(x)) over the experts, in the compute dtype; each
    expert is fc1 -> exact GELU -> fc2 on every token, its products summed
    in fp32 and rounded to the compute dtype; the output is the
    gate-weighted sum of the experts' outputs (fp32 sum, rounded), with
    dropout once on it. Parameters keep the flax layouts: `router` [E, C]
    (a Linear), `w1` [E, C, M], `b1` [E, M], `w2` [E, M, C], `b2` [E, C].
    """

    def __init__(self, dim: int, mlp_dim: int, num_experts: int = 4,
                 dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32,
                 expert_mesh=None, expert_axis: Optional[str] = None):
        super().__init__()
        if expert_mesh is not None or expert_axis is not None:
            raise NotImplementedError(
                "expert parallelism (expert_mesh / expert_axis) is not ported "
                "yet; it comes with the parallel paths (ROADMAP.md Queue A #7)")
        E, C, M = num_experts, dim, mlp_dim
        self.compute_dtype = compute_dtype
        self.router = Dense(C, E, compute_dtype=compute_dtype)
        self.w1 = nn.Parameter(torch.empty(E, C, M))
        self.b1 = nn.Parameter(torch.empty(E, M))
        self.w2 = nn.Parameter(torch.empty(E, M, C))
        self.b2 = nn.Parameter(torch.empty(E, C))
        self.drop = Dropout(dropout)

    @property
    def init_limit(self) -> float:
        """flax's xavier_uniform bound for the [E, C, M] / [E, M, C] expert
        kernels: the leading E counts as a receptive field, so fan_in + fan_out
        = E * (C + M)."""
        E, C, M = self.w1.shape
        return math.sqrt(6.0 / (E * (C + M)))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        gates = torch.softmax(self.router(x), dim=-1)  # [B, N, E]
        h = torch.einsum("bnc,ecm->ebnm", x, self.w1.to(dt))
        h = F.gelu(h + self.b1.to(dt)[:, None, None, :], approximate="none")
        y = torch.einsum("ebnm,emc->ebnc", h, self.w2.to(dt))
        y = y + self.b2.to(dt)[:, None, None, :]
        out = torch.einsum("ebnc,bne->bnc", y.float(), gates.float()).to(dt)
        return self.drop(out, generator)


class TransformerBlock(nn.Module):
    """Pre-norm transformer block with its own attention and RPE instance.

    LayerNorm statistics stay fp32; outputs are in the compute dtype.
    `mlp_type` "moe" takes `MoeMlp` (`mlp_kwargs`: num_experts).
    """

    def __init__(self, dim: int, heads: int, mlp_dim: int, num_patches: int,
                 dropout: float = 0.0, attention_type: str = "favor_plus",
                 rpe_type: Optional[str] = None,
                 attention_kwargs: Optional[Dict[str, Any]] = None,
                 rpe_kwargs: Optional[Dict[str, Any]] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 mlp_type: str = "dense",
                 mlp_kwargs: Optional[Dict[str, Any]] = None):
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
        if mlp_type == "moe":
            self.mlp = MoeMlp(dim, mlp_dim, dropout=dropout,
                              compute_dtype=compute_dtype, **(mlp_kwargs or {}))
        elif mlp_type == "dense":
            self.mlp = Mlp(dim, mlp_dim, dropout, compute_dtype)
        else:
            raise ValueError(f"unknown mlp_type {mlp_type!r}: 'dense' or 'moe'")

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
