"""Shared model layers: the dense and soft-MoE MLPs and the pre-norm
transformer block.

Counterpart of `efficient_rpe_vit_tpu/models/layers.py`:
x + attn(LN(x), rpe) then x + mlp(LN(x)), with the RPE threaded INTO the
attention call (KERPLE runs inside the kernelised-attention math). The
block's MLP is the dense one or the soft mixture of experts, whose experts
may be split over a mesh axis (`expert_mesh`); under tensor parallelism
(`parallel.shard_model`) the dense MLP holds mlp_dim / P hidden units.
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
    from the generator passed to forward. Under tensor parallelism (`tp`)
    the input enters through `copy_to_group`, `mlp.3`'s partial sums go
    through `reduce_from_group` and its bias is added once after them."""

    tp = None

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
        if self.tp is not None:
            return self._tp_forward(x, generator)
        for layer in self:
            x = layer(x, generator) if isinstance(layer, Dropout) else layer(x)
        return x

    def _tp_forward(self, x: torch.Tensor, generator) -> torch.Tensor:
        from ..parallel.comm import copy_to_group, reduce_from_group

        fc1, gelu, drop1, fc2, drop2 = self
        h = drop1(gelu(fc1(copy_to_group(x, self.tp.group))), generator)
        dt = fc2.compute_dtype
        y = reduce_from_group(F.linear(h.to(dt), fc2.weight.to(dt)), self.tp.group)
        return drop2(y + fc2.bias.to(dt), generator)


class MoeMlp(nn.Module):
    """Soft mixture of E experts (dense routing).

    gates = softmax(router(x)) over the experts, in the compute dtype; each
    expert is fc1 -> exact GELU -> fc2 on every token, its products summed
    in fp32 and rounded to the compute dtype; the output is the
    gate-weighted sum of the experts' outputs (fp32 sum, rounded), with
    dropout once on it. Parameters keep the flax layouts: `router` [E, C]
    (a Linear), `w1` [E, C, M], `b1` [E, M], `w2` [E, M, C], `b2` [E, C].

    With `expert_mesh` (a `parallel.Mesh`) the experts are split over its
    `expert_axis`: this rank holds E / P of them (`w1`, `b1`, `w2`, `b2`
    [E / P, ...], drawn as the single-device model's and sliced), runs them
    on every token with its slice of the gates (x entering through
    `copy_to_group`, the gates through `scatter_seq` on the expert dim),
    rounds its partial mixture to the compute dtype and sums the ranks'
    partials with `reduce_from_group`, as the JAX package's
    `_moe_partial_combine` and psum do.
    """

    def __init__(self, dim: int, mlp_dim: int, num_experts: int = 4,
                 dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32,
                 expert_mesh=None, expert_axis: str = "expert"):
        super().__init__()
        self.num_experts = num_experts
        self.ep = None
        E, C, M = num_experts, dim, mlp_dim
        if expert_mesh is not None:
            from ..parallel.mesh import Mesh

            if not isinstance(expert_mesh, Mesh):
                raise TypeError("expert_mesh must be a parallel.Mesh, got "
                                f"{type(expert_mesh).__name__}")
            if expert_axis not in expert_mesh:
                raise ValueError(f"expert_mesh {expert_mesh.shape} has no axis {expert_axis!r}")
            self.ep = expert_mesh.shard(expert_axis)
            if E % self.ep.count:
                raise ValueError(f"{E} experts do not split over {self.ep.count} ranks")
            E //= self.ep.count
            self.split = {name: (self.ep, 0, 1) for name in ("w1", "b1", "w2", "b2")}
        self.compute_dtype = compute_dtype
        self.router = Dense(C, num_experts, compute_dtype=compute_dtype)
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
        _, C, M = self.w1.shape
        return math.sqrt(6.0 / (self.num_experts * (C + M)))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        gates = torch.softmax(self.router(x), dim=-1)  # [B, N, E]
        if self.ep is not None:
            from ..parallel.comm import copy_to_group, reduce_from_group, scatter_seq

            x = copy_to_group(x, self.ep.group)
            gates = scatter_seq(gates, self.ep.group, dim=-1)
        h = torch.einsum("bnc,ecm->ebnm", x, self.w1.to(dt))
        h = F.gelu(h + self.b1.to(dt)[:, None, None, :], approximate="none")
        y = torch.einsum("ebnm,emc->ebnc", h, self.w2.to(dt))
        y = y + self.b2.to(dt)[:, None, None, :]
        out = torch.einsum("ebnc,bne->bnc", y.float(), gates.float()).to(dt)
        if self.ep is not None:
            out = reduce_from_group(out, self.ep.group)
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
