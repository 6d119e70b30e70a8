"""RPE modules — parameter containers over the `ops` cores.

Counterpart of `efficient_rpe_vit_tpu/models/rpe.py`: RoPE (no parameters),
axial RoPE2D (no parameters), KERPLE ([heads, 2n-1] biases) and
Circulant-STRING ([heads, coord_dim, head_dim] coefficients, or
[heads, coord_dim, num_blocks, block_size] block-circulant). The registry's
names and aliases are the JAX package's.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
from torch import nn

from ..ops import kerple_linear_attention
from ..ops.fft_toeplitz import toeplitz_matmul
from ..ops.rotations import (
    _rotate_keep_cls,
    apply_block_circulant_rotation,
    apply_circulant_string,
    apply_rope,
    apply_rope_2d,
    circulant_eigenvalues,
    grid_positions_2d,
    rope_2d_tables,
    rope_tables,
    METHODS,
)


class RoPE(nn.Module):
    """1D rotary embedding over token index 0..N-1 including CLS; the
    cos/sin tables are buffers outside the state dict."""

    def __init__(self, num_patches: int, dim: int, heads: int, theta: float = 10000.0):
        super().__init__()
        self.num_patches = num_patches  # sequence length including CLS
        self.dim = dim
        self.heads = heads
        cos, sin = rope_tables(num_patches, dim // heads, theta)
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    def apply_rotary(self, q: torch.Tensor, k: torch.Tensor):
        return apply_rope(q, k, self.cos, self.sin)

    def forward(self, x):  # the reference's BaseRPE interface: a no-op
        return x


class RoPE2D(nn.Module):
    """Axial 2D rotary embedding over the patch grid (first half of
    head_dim by x, second by y, theta 100); CLS is not rotated."""

    def __init__(self, num_patches: int, dim: int, heads: int, theta: float = 100.0):
        super().__init__()
        self.num_patches = num_patches  # sequence length including CLS
        self.dim = dim
        self.heads = heads
        cos, sin = rope_2d_tables(num_patches - 1, dim // heads, theta)
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    def apply_rotary(self, q: torch.Tensor, k: torch.Tensor):
        return apply_rope_2d(q, k, self.cos, self.sin)

    def forward(self, x):
        return x


class KerpleRPE(nn.Module):
    """KERPLE 'most general' RPE (Luo et al. 2021, Alg. 1).

    Learnable biases b_{j-i} per head; Toeplitz C[i,j] = exp(b_{j-i}) applied
    inside kernelised attention. Parameter `rel_pos_bias` [heads, 2n-1],
    init N(0, 0.02) (`ViT.reset_parameters`).
    """

    # parameters used in their own dtype: c = exp(b) is computed in b's
    # dtype, as flax computes it, so a bf16 serving artifact (which keeps b
    # in bf16, `serve.export.ServedForward`) rounds c to bf16 as the JAX
    # package's bf16 artifact does
    keeps_param_dtype = ("rel_pos_bias",)

    def __init__(self, num_patches: int, dim: int, heads: int,
                 method: str = "auto"):
        super().__init__()
        self.num_patches = num_patches  # sequence length including CLS
        self.dim = dim
        self.heads = heads
        self.method = method  # kerple compute path: auto | pallas | dense | fft
        self.rel_pos_bias = nn.Parameter(torch.empty(heads, 2 * num_patches - 1))

    @property
    def max_rel_pos(self) -> int:
        return 2 * self.num_patches - 1

    def coeffs(self) -> torch.Tensor:
        """Positive Toeplitz coefficients c_k = exp(b_k) in b's dtype, as
        fp32."""
        return torch.exp(self.rel_pos_bias).float()

    def attention(self, q_prime: torch.Tensor, k_prime: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
        """Full KERPLE linear attention (numerator/denominator fused)."""
        return kerple_linear_attention(q_prime, k_prime, v, self.coeffs(),
                                       method=self.method)

    def apply_rpe_fft(self, k_prime: torch.Tensor,
                      v: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The reference's D1/D2 API, by FFT:

        D1 (v given): [B, H, n, F, D] = T @ outer(phi(K), V);
        D2 (v None):  [B, H, n, F]    = T @ phi(K).
        For tests and diagnostics; `attention` never forms D1 whole.
        """
        c = self.coeffs()
        if v is None:
            return toeplitz_matmul(c, k_prime, method="fft")
        B, H, N, F_ = k_prime.shape
        D = v.shape[-1]
        a1 = (k_prime[..., :, None] * v[..., None, :]).reshape(B, H, N, F_ * D)
        return toeplitz_matmul(c, a1, method="fft").reshape(B, H, N, F_, D)

    def forward(self, x):
        raise NotImplementedError(
            "KERPLE does not use the standard forward() interface. "
            "It must run inside kernelised attention (FAVOR+/ReLU); see "
            "models/attention.py."
        )


class CirculantStringRPE(nn.Module):
    """Circulant-STRING RPE (Schenck et al. 2025).

    Learnable `circulant_coeffs` [heads, coord_dim, head_dim], init
    N(0, 0.01) (`ViT.reset_parameters`); the rotation along head_dim by the
    2D integer grid positions of the patches, CLS excluded. With
    `enable_block_circulant`, [heads, coord_dim, head_dim // block_size,
    block_size] block-circulant coefficients (the chain only); a bare
    `block_size` warns and falls back to the full circulant, as the
    reference does. `method` picks the rotation arm of the full circulant
    ('pallas', 'chain' or 'auto'; `ops/rotations.py`).
    """

    def __init__(self, num_patches: int, dim: int, heads: int, coord_dim: int = 2,
                 block_size: Optional[int] = None, enable_block_circulant: bool = False,
                 method: str = "auto"):
        super().__init__()
        if method not in METHODS:
            raise ValueError(f"unknown rotation method {method!r}: one of {METHODS}")
        self.num_patches = num_patches  # sequence length including CLS
        self.dim = dim
        self.heads = heads
        self.method = method
        head_dim = dim // heads
        self.blocked = False
        if block_size is not None:
            if head_dim % block_size != 0:
                raise ValueError(f"head_dim ({head_dim}) must be divisible by "
                                 f"block_size ({block_size})")
            if enable_block_circulant:
                self.blocked = True
            else:
                warnings.warn(
                    f"block_size={block_size} specified but "
                    "enable_block_circulant is False; using full-dimension "
                    "circulant (reference-compatible fallback). Pass "
                    "enable_block_circulant=True to use the real "
                    "block-circulant structure.",
                    UserWarning,
                )
        shape = ((heads, coord_dim, head_dim // block_size, block_size) if self.blocked
                 else (heads, coord_dim, head_dim))
        self.circulant_coeffs = nn.Parameter(torch.empty(shape))
        self.register_buffer("positions", grid_positions_2d(num_patches - 1, coord_dim),
                             persistent=False)

    def get_eigenvalues(self) -> torch.Tensor:
        return circulant_eigenvalues(self.circulant_coeffs)

    def rotate(self, q: torch.Tensor, k: torch.Tensor):
        """Rotate the patch tokens of q and k; CLS passes through."""
        if not self.blocked:
            return apply_circulant_string(q, k, self.positions, self.circulant_coeffs,
                                          method=self.method)
        if q.shape[2] <= 1:
            return q, k
        return tuple(_rotate_keep_cls(apply_block_circulant_rotation, t, self.positions,
                                      self.circulant_coeffs) for t in (q, k))

    def forward(self, x):
        return x


# name -> class, with aliases (the JAX package's registry)
RPE_REGISTRY = {
    "most_general": KerpleRPE,
    "kerple": KerpleRPE,
    "circulant_string": CirculantStringRPE,
    "circulant": CirculantStringRPE,
    "rope": RoPE,
    "rotary": RoPE,
    "rope_2d": RoPE2D,
    "rope_axial": RoPE2D,
}
