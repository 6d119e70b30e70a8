"""RPE modules — parameter containers over the `ops` cores.

Counterpart of `efficient_rpe_vit_tpu/models/rpe.py`. Only KERPLE is
ported so far; RoPE, RoPE2D and Circulant-STRING come with the rotation
slice (see `models/factory.py`).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import kerple_linear_attention


class KerpleRPE(nn.Module):
    """KERPLE 'most general' RPE (Luo et al. 2021, Alg. 1).

    Learnable biases b_{j-i} per head; Toeplitz C[i,j] = exp(b_{j-i}) applied
    inside kernelised attention. Parameter `rel_pos_bias` [heads, 2n-1],
    init N(0, 0.02) (`ViT.reset_parameters`).
    """

    def __init__(self, num_patches: int, dim: int, heads: int,
                 method: str = "auto"):
        super().__init__()
        self.num_patches = num_patches  # sequence length including CLS
        self.dim = dim
        self.heads = heads
        self.method = method  # kerple compute path: auto | pallas | dense
        self.rel_pos_bias = nn.Parameter(torch.empty(heads, 2 * num_patches - 1))

    @property
    def max_rel_pos(self) -> int:
        return 2 * self.num_patches - 1

    def coeffs(self) -> torch.Tensor:
        """Positive Toeplitz coefficients c_k = exp(b_k), fp32."""
        return torch.exp(self.rel_pos_bias.float())

    def attention(self, q_prime: torch.Tensor, k_prime: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
        """Full KERPLE linear attention (numerator/denominator fused)."""
        return kerple_linear_attention(q_prime, k_prime, v, self.coeffs(),
                                       method=self.method)

    def forward(self, x):
        raise NotImplementedError(
            "KERPLE does not use the standard forward() interface. "
            "It must run inside kernelised attention (FAVOR+/ReLU); see "
            "models/attention.py."
        )


# name -> class, with aliases; the rotation RPEs join in their slice
RPE_REGISTRY = {
    "most_general": KerpleRPE,
    "kerple": KerpleRPE,
}
