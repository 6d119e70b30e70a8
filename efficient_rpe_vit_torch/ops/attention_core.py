"""Attention compute cores — plain tensor functions on [B, H, N, D] tensors.

Counterpart of `efficient_rpe_vit_tpu/ops/attention_core.py`:
  * linear  O(N)  two-einsum kernelised attention,
  * KERPLE        linear attention with a Toeplitz relative-position bias
                  inside the kernelised sum,

    num[i] = sum_j T[i,j] * (q' k'^T)[i,j] * v[j],
    den[i] = sum_j T[i,j] * (q' k'^T)[i,j],      T[i,j] = c[j - i + N - 1].

KERPLE dispatch. The JAX package's dense-vs-kernel constants were measured
on its own accelerator and are not inherited: here `method` picks the arm
explicitly, and `"auto"` means the hand-written kernel until measurements
on the GPU set a real dispatch.
"""

from __future__ import annotations

import torch

from .kernels.masked_linear_coeffs import (
    EPS,
    masked_linear_attention_coeffs,
    masked_linear_attention_coeffs_reference,
)

__all__ = ["EPS", "linear_attention", "kerple_linear_attention"]


def linear_attention(q_prime: torch.Tensor, k_prime: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """O(N) kernelised attention: out_i = phi(q_i) (sum_j phi(k_j)^T v_j)
    normalised by phi(q_i) (sum_j phi(k_j)).

    Products accumulate in fp32; like the JAX version, sum_j phi(k_j) is
    rounded to the input dtype before the denominator product.

    Args:
        q_prime, k_prime: [B, H, N, F] non-negative features.
        v: [B, H, N, D].
    Returns:
        [B, H, N, D] in v's dtype.
    """
    qf = q_prime.float()
    kv = torch.einsum("bhnf,bhnd->bhfd", k_prime.float(), v.float())
    num = torch.einsum("bhnf,bhfd->bhnd", qf, kv)
    k_sum = k_prime.sum(dim=2).float()  # [B, H, F]
    den = torch.einsum("bhnf,bhf->bhn", qf, k_sum)
    return (num / (den[..., None] + EPS)).to(v.dtype)


def kerple_linear_attention(q_prime: torch.Tensor, k_prime: torch.Tensor,
                            v: torch.Tensor, coeffs: torch.Tensor,
                            method: str = "auto") -> torch.Tensor:
    """KERPLE attention: out_i = sum_j c[j-i+N-1] (q'_i.k'_j) v_j
    / (sum_j c[j-i+N-1] (q'_i.k'_j) + eps).

    Args:
        q_prime, k_prime: [B, H, N, F].
        v: [B, H, N, D].
        coeffs: [H, 2N-1] positive Toeplitz coefficients c = exp(rel_pos_bias).
        method: 'pallas' runs the hand-written kernel (its plain version for
            CPU tensors); 'dense' the plain [B, H, N, N] formula on any
            device; 'auto' means 'pallas'; 'fft' is not ported yet.
    Returns:
        [B, H, N, D] in v's dtype.
    """
    if method == "auto":
        method = "pallas"
    if method == "pallas":
        return masked_linear_attention_coeffs(q_prime, k_prime, v, coeffs)
    if method == "dense":
        return masked_linear_attention_coeffs_reference(
            q_prime, k_prime, v, coeffs)[0]
    if method == "fft":
        raise NotImplementedError(
            "KERPLE method='fft' (the streamed FFT path) is not ported yet; "
            "it comes with the long-sequence slice of the port. Use "
            "method='pallas' or 'dense'."
        )
    raise ValueError(f"unknown method {method!r}")
