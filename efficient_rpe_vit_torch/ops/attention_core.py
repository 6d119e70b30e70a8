"""Attention compute cores — plain tensor functions on [B, H, N, D] tensors.

Counterpart of `efficient_rpe_vit_tpu/ops/attention_core.py`:
  * softmax O(N^2) softmax(scale * q k^T) v, on the flash kernels or dense,
  * linear  O(N)  two-einsum kernelised attention,
  * KERPLE        linear attention with a Toeplitz relative-position bias
                  inside the kernelised sum (kernel, dense or FFT),

    num[i] = sum_j T[i,j] * (q' k'^T)[i,j] * v[j],
    den[i] = sum_j T[i,j] * (q' k'^T)[i,j],      T[i,j] = c[j - i + N - 1].

Dispatch. The JAX package's dense-vs-kernel constants (`FLASH_MIN_N`,
`SOFTMAX_DENSE_MEMORY_BUDGET`, the KERPLE budgets) were measured on its
own accelerator and are not inherited: here `method` picks the arm
explicitly, and `"auto"` means the hand-written kernels (for softmax, the
dense arm when the probabilities are returned) until measurements on the
GPU set a real dispatch. KERPLE's two arms are differentiable with the
explicit residual VJP (`masked_linear_vjp_residual`): the kernel arm through
the backward kernels, the dense arm as plain tensor code over T. Softmax's
flash arm runs the flash backward kernels; its dense arm is differentiated
by autograd, as the JAX package's dense path is by JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from .fft_toeplitz import toeplitz_from_coeffs, toeplitz_matmul_fft
from .kernels.flash_attention import (
    canonical_mask,
    dropout_keep_dense,
    flash_softmax_attention,
)
from .kernels.masked_linear_coeffs import (
    EPS,
    kerple_dense_forward,
    masked_linear_attention_coeffs,
    masked_linear_vjp_residual,
)

__all__ = ["EPS", "softmax_attention", "linear_attention",
           "kerple_linear_attention", "masked_linear_vjp_residual",
           "KERPLE_FFT_BLOCK_BUDGET"]

# Per-block byte cap of the `fft` arm's streamed [B, H, N, F * fft_block]
# intermediate, the JAX package's: a memory rule, kept so that both
# packages block the head dim alike.
KERPLE_FFT_BLOCK_BUDGET = 1 * 1024**3


def softmax_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, mask: Optional[torch.Tensor] = None,
                  dropout_rate: float = 0.0, dropout_seed=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain [B, H, N, N] path, differentiated by autograd, as the JAX
    package's dense `softmax_attention`: fp32 scores, masked cells -inf,
    softmax, dropout on the probabilities, then the value product with the
    probabilities rounded to v's dtype (fp32 accumulation). Dropout keeps
    the cells of the kernels' counter hash (`dropout_keep_dense`), so both
    arms drop the same cells from the same seed.

    Returns:
        (out [B, H, N, D] in v's dtype, the fp32 probabilities after dropout).
    """
    B, H, N, _ = q.shape
    attn = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    if mask is not None:
        mask, _ = canonical_mask(mask, B, H)
        attn = attn.masked_fill(mask == 0, float("-inf"))
    attn = torch.softmax(attn, dim=-1)
    if dropout_rate > 0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        keep = dropout_keep_dense(dropout_seed, B, H, N, N, dropout_rate,
                                  device=q.device)
        attn = torch.where(keep, attn / (1.0 - dropout_rate), 0.0)
    out = torch.einsum("bhnm,bhmd->bhnd", attn.to(v.dtype).float(), v.float())
    return out.to(v.dtype), attn


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, mask: Optional[torch.Tensor] = None,
                      return_attention: bool = False,
                      dropout_rate: float = 0.0, dropout_seed=None,
                      method: str = "auto"):
    """softmax(scale * q k^T) v.

    Args:
        q, k, v: [B, H, N, D].
        scale: scalar (typically head_dim ** -0.5).
        mask: optional [B, N, N] / [B, 1, N, N] / [B, H, N, N]; zeros are
            masked out.
        return_attention: also return the [B, H, N, N] probabilities (after
            dropout); only the dense arm forms them.
        dropout_rate: attention-probability drop rate; 0 disables.
        dropout_seed: required when dropout_rate > 0: an int or a one-value
            integer tensor (on q's device for the kernel arm); both arms
            drop the cells of the counter hash of (seed, b, h, i, j).
        method: 'flash' runs the hand-written flash kernels (their plain
            versions for CPU tensors); 'dense' the plain [B, H, N, N]
            formula on any device; 'auto' means 'flash', or 'dense' when
            return_attention asks for the probabilities.
    Returns:
        [B, H, N, D] in v's dtype, and the probabilities if return_attention.
    """
    if method == "auto":
        method = "dense" if return_attention else "flash"
    if method == "flash":
        if return_attention:
            raise ValueError("the flash arm never forms the [B, H, N, N] "
                             "probabilities: use method='dense' (or 'auto') "
                             "with return_attention")
        return flash_softmax_attention(q, k, v, scale, mask, dropout_rate,
                                       dropout_seed)
    if method == "dense":
        out, attn = softmax_dense(q, k, v, scale, mask, dropout_rate,
                                  dropout_seed)
        return (out, attn) if return_attention else out
    raise ValueError(f"unknown method {method!r}")


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


class _KerpleDenseCore(torch.autograd.Function):
    """Dense KERPLE over (q', k', v, T) whose backward is the residual VJP
    from the saved (den, out), as the JAX package's `_kerple_dense_core`
    custom VJP; autograd handles only the coeffs -> T gather."""

    @staticmethod
    def forward(ctx, q_prime, k_prime, v, t):
        out, den = kerple_dense_forward(q_prime, k_prime, v, t)
        ctx.save_for_backward(q_prime, k_prime, v, t, den, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return masked_linear_vjp_residual(*ctx.saved_tensors, g)


def kerple_dense(q_prime: torch.Tensor, k_prime: torch.Tensor,
                 v: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """The exact O(N^2) path: W = (q' k'^T) * T, out = W v / W 1."""
    t = toeplitz_from_coeffs(coeffs.float(), q_prime.shape[2])  # [H, N, N]
    return _KerpleDenseCore.apply(q_prime, k_prime, v, t)


def _kerple_fft(q_prime: torch.Tensor, k_prime: torch.Tensor, v: torch.Tensor,
                coeffs: torch.Tensor, fft_block: int) -> torch.Tensor:
    """O(N log N) path, as the JAX `_kerple_fft`: D2 = T @ phi(K) in one
    FFT, D1 = T @ [phi(k_j) v_j^T]_j streamed over head_dim blocks of
    `fft_block` columns in order, so the extra memory is one
    [B, H, N, F, fft_block] block. The block shrinks to the largest divisor
    of D whose block stays under KERPLE_FFT_BLOCK_BUDGET, and falls back to
    D when it does not divide D. Under autograd every block's spectra are
    kept for the backward (no checkpointing, as in the JAX package)."""
    B, H, N, F_ = q_prime.shape
    D = v.shape[-1]
    max_block = max(1, KERPLE_FFT_BLOCK_BUDGET // max(1, B * H * N * F_ * 4))
    if fft_block > max_block:
        fft_block = max((d for d in range(1, max_block + 1) if D % d == 0), default=1)
    if D % fft_block != 0:
        fft_block = D
    q32 = q_prime.float()
    d2 = toeplitz_matmul_fft(coeffs, k_prime)  # [B, H, N, F]
    den = torch.einsum("bhnf,bhnf->bhn", q32, d2.float())
    nums = []
    for start in range(0, D, fft_block):
        v_blk = v[..., start:start + fft_block]
        a1 = (k_prime[..., :, None] * v_blk[..., None, :]).reshape(B, H, N, F_ * fft_block)
        d1 = toeplitz_matmul_fft(coeffs, a1).reshape(B, H, N, F_, fft_block)
        nums.append(torch.einsum("bhnf,bhnfd->bhnd", q32, d1.float()))
    num = torch.cat(nums, dim=-1)
    return (num / (den[..., None] + EPS)).to(v.dtype)


def kerple_linear_attention(q_prime: torch.Tensor, k_prime: torch.Tensor,
                            v: torch.Tensor, coeffs: torch.Tensor,
                            method: str = "auto", fft_block: int = 16) -> torch.Tensor:
    """KERPLE attention: out_i = sum_j c[j-i+N-1] (q'_i.k'_j) v_j
    / (sum_j c[j-i+N-1] (q'_i.k'_j) + eps).

    Args:
        q_prime, k_prime: [B, H, N, F].
        v: [B, H, N, D].
        coeffs: [H, 2N-1] positive Toeplitz coefficients c = exp(rel_pos_bias).
        method: 'pallas' runs the hand-written kernel (its plain version for
            CPU tensors); 'dense' the plain [B, H, N, N] formula on any
            device; 'auto' means 'pallas'; 'fft' the O(N log N) FFT path
            (`torch.fft`, any device).
        fft_block: head_dim block of the 'fft' path's streamed numerator.
    Returns:
        [B, H, N, D] in v's dtype.
    """
    if method == "auto":
        method = "pallas"
    if method == "pallas":
        return masked_linear_attention_coeffs(q_prime, k_prime, v, coeffs)
    if method == "dense":
        return kerple_dense(q_prime, k_prime, v, coeffs)
    if method == "fft":
        return _kerple_fft(q_prime, k_prime, v, coeffs, fft_block)
    raise ValueError(f"unknown method {method!r}")
