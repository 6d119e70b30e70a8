"""Kernelised attention modules: FAVOR+ O(N) and ReLU O(N), forward only.

Counterpart of `efficient_rpe_vit_tpu/models/attention.py`:
  * fused QKV projection, optional bias,
  * linear-attention scale d^-1/4 on both q and k, except under KERPLE,
    which L2-normalises q and k instead (clamp inside the sqrt),
  * raise on return_attention,
  * Omega in the non-trainable buffer `omega` [heads, head_dim, m].

The softmax module comes with the softmax slice; feature redraw with the
training slice.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..ops import (
    default_num_features,
    gaussian_features,
    linear_attention,
    orthogonal_gaussian_features,
    phi_positive,
    phi_relu,
)
from ..ops.feature_maps import mxu_num_features
from .dense import Dense
from .rpe import KerpleRPE

# Byte size past which the training step recomputes phi in the backward
# instead of keeping it (used by the training slice).
PHI_CHECKPOINT_BYTES = 128 * 1024 ** 2


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, N, C] -> [B, H, N, C/H]"""
    B, N, C = x.shape
    return x.reshape(B, N, heads, C // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, D] -> [B, N, H*D]"""
    B, H, N, D = x.shape
    return x.transpose(1, 2).reshape(B, N, H * D)


def _safe_normalize(t: torch.Tensor) -> torch.Tensor:
    """L2 normalisation with the clamp inside the sqrt (finite on all-zero
    rows), in t's dtype."""
    sq = (t * t).sum(dim=-1, keepdim=True)
    return t / torch.sqrt(torch.clamp(sq, min=1e-24))


class _KernelAttention(nn.Module):
    """Shared machinery for FAVOR+ and ReLU linear attention."""

    feature_kind: str = "favor_plus"  # overridden by subclasses

    def __init__(self, dim: int, heads: int, dropout: float = 0.0,
                 num_features: Union[int, str, None] = None,
                 use_orthogonal: bool = True,
                 feature_redraw_interval: Optional[int] = None,
                 qkv_bias: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 fused_phi: bool = False):
        super().__init__()
        if fused_phi:
            raise NotImplementedError(
                "fused_phi (phi computed inside the KERPLE kernel) is not "
                "ported yet; it follows the rotation slice")
        self.dim = dim
        self.heads = heads
        self.num_features = num_features
        self.use_orthogonal = use_orthogonal
        self.feature_redraw_interval = feature_redraw_interval
        self.qkv = Dense(dim, dim * 3, bias=qkv_bias, compute_dtype=compute_dtype)
        self.proj = Dense(dim, dim, compute_dtype=compute_dtype)
        self.drop = nn.Dropout(dropout)
        self.register_buffer("omega", torch.empty(heads, self.head_dim, self.m))

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def m(self) -> int:
        if self.num_features == "mxu":
            return mxu_num_features(self.head_dim)
        return (
            self.num_features
            if self.num_features is not None
            else default_num_features(self.head_dim)
        )

    def draw_omega(self, generator: torch.Generator) -> torch.Tensor:
        draw = (orthogonal_gaussian_features if self.use_orthogonal
                else gaussian_features)
        return draw(generator, self.heads, self.head_dim, self.m)

    def _phi(self, x: torch.Tensor) -> torch.Tensor:
        if self.feature_kind == "favor_plus":
            return phi_positive(x, self.omega)
        return phi_relu(x, self.omega)

    def forward(self, x: torch.Tensor, rpe: Optional[nn.Module] = None,
                return_attention: bool = False) -> torch.Tensor:
        if return_attention:
            raise NotImplementedError(
                "Linear attention doesn't compute explicit attention "
                "matrices. Returning attention weights would require O(N^2) "
                "computation."
            )
        if self.training and self.feature_redraw_interval is not None:
            raise NotImplementedError(
                "feature redraw is a training-time feature; it comes with "
                "the training slice of the port")
        q, k, v = (_split_heads(t, self.heads)
                   for t in self.qkv(x).chunk(3, dim=-1))

        use_kerple = isinstance(rpe, KerpleRPE)
        if use_kerple:
            # L2 normalisation for stability (Luo et al. 2021 §3.3, Thm 3);
            # no d^-1/4 scale on this branch
            q, k = _safe_normalize(q), _safe_normalize(k)
        else:
            scale = self.head_dim ** -0.25  # d^-1/4 on both q and k
            q, k = q * scale, k * scale

        q_prime, k_prime = self._phi(q), self._phi(k)
        if use_kerple:
            out = rpe.attention(q_prime, k_prime, v.contiguous())
        else:
            out = linear_attention(q_prime, k_prime, v)
        return self.drop(self.proj(_merge_heads(out)))


class FavorPlusAttention(_KernelAttention):
    """FAVOR+ positive-random-feature attention (Choromanski et al. 2020)."""

    feature_kind = "favor_plus"


class ReluAttention(_KernelAttention):
    """ReLU-feature linear attention."""

    feature_kind = "relu"


# name -> class, with aliases; softmax and favor_hyper join in their slices
ATTENTION_REGISTRY = {
    "favor_plus": FavorPlusAttention,
    "favor+": FavorPlusAttention,
    "performer": FavorPlusAttention,
    "relu": ReluAttention,
}
