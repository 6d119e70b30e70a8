"""Attention compute cores — plain tensor functions on [B, H, N, D] tensors.

Counterpart of `efficient_rpe_vit_tpu/ops/attention_core.py`:
  * softmax O(N^2) softmax(scale * q k^T) v, on the flash kernels or dense,
  * linear  O(N)  two-einsum kernelised attention,
  * KERPLE        linear attention with a Toeplitz relative-position bias
                  inside the kernelised sum (kernel, dense or FFT),

    num[i] = sum_j T[i,j] * (q' k'^T)[i,j] * v[j],
    den[i] = sum_j T[i,j] * (q' k'^T)[i,j],      T[i,j] = c[j - i + N - 1].

Dispatch. `method` picks an arm explicitly, and `"auto"` picks it by the
JAX package's rules on the shape, before any call (never as a fallback):
softmax takes the flash kernels where `softmax_needs_flash` holds
(N >= FLASH_MIN_N, or the dense arm's temporaries past
SOFTMAX_DENSE_MEMORY_BUDGET) and the dense arm elsewhere; return_attention
takes the dense arm, and is refused past the budget; KERPLE takes the dense
arm below KERPLE_DENSE_CROSSOVER_N and KERPLE_DENSE_MEMORY_BUDGET and the
kernel past either (`kerple_arm`). The JAX constants were measured on its
own accelerator and are not inherited: these come from the H100 rows of
PERF.md §6 "Dispatch on the H100", which put both kernels ahead at every N
measured. Under `torch.export` with a symbolic batch the byte counts are
inconclusive and count as below budget, as in JAX. KERPLE's two arms are differentiable with the
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
           "KERPLE_FFT_BLOCK_BUDGET", "FLASH_MIN_N", "SOFTMAX_DENSE_MEMORY_BUDGET",
           "KERPLE_DENSE_CROSSOVER_N", "KERPLE_DENSE_MEMORY_BUDGET",
           "softmax_needs_flash", "softmax_arm", "kerple_arm"]

# ─── the 'auto' dispatch: the JAX package's rules, with constants from
# the rows of PERF.md §6 "Dispatch on the H100" (NVIDIA H100 80GB HBM3,
# 700.00 W; runs AE and AF) ───────────────────────────────────────────────
# Softmax: flash wins every full ViT-B `baseline` train step measured
# (experiments/flash_crossover.py, rows F: 1.06x at N=5, 1.10x at N=17 and
# N=65, 1.43x at N=197, 2.33x / 2.68x / 3.03x at N=577 / 785 / 1025), and
# ties the dense arm within the chains' spread at the mnist widths (dim 32,
# host-bound eager steps: 0.99x at N=17, 1.01x at N=197, 1.04x at N=5). No
# row has dense ahead, so flash takes every N.
FLASH_MIN_N = 0
# The largest dense `baseline` ViT-B train steps that fit on the 80 GB card
# (experiments/scaling_ab.py, rows W): B=48 at N=1025 (3 B H N^2 4 =
# 7,261,920,000 B, peak 82.4 GB) and B=3 at N=4097 (7,251,296,688 B, peak
# 68.7 GB); B=64 and B=4 ran out of memory. The budget is the smaller of
# the two counts that fit, 8.5% of the card's 85,017,493,504 B.
SOFTMAX_DENSE_MEMORY_BUDGET = 3 * 3 * 12 * 4097 ** 2 * 4
# KERPLE: the kernels win every full flagship train step measured
# (experiments/kerple_pallas_ab.py, rows K): ViT-B 1.13x at N=5, 1.16x at
# N=17, 1.22x at N=65, 1.37x at N=197, 2.18x at N=1025; the mnist widths
# 1.11x at N=5, 1.17x at N=17, 1.11x at N=197 (batch 256, 40-step chains;
# a 10-step run there read 0.96x inside its chains' spread). No row has
# dense ahead, so the kernel takes every N.
KERPLE_DENSE_CROSSOVER_N = 0
# The largest dense flagship ViT-B train steps that fit (rows W): B=96 at
# N=1025 (5 B H N^2 4 = 24,206,400,000 B, peak 78.9 GB) and B=8 at N=4097
# (32,227,985,280 B, peak 60.8 GB); B=128 and B=12 ran out of memory. The
# budget is the smaller count that fit, 28.5% of the card. With the
# crossovers at 0 it decides nothing on the card (the materialised-T
# backward's rule, `ops/kernels/masked_linear.py::masked_linear_bwd_mode`,
# reads it too).
KERPLE_DENSE_MEMORY_BUDGET = 5 * 96 * 12 * 1025 ** 2 * 4

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


def _concrete_bytes(x, default: int) -> int:
    """A byte count built from shapes: a plain int, except under
    `torch.export` with a symbolic batch, where it is a SymInt that must not
    be compared (a comparison would add a guard on the batch). Those traces
    are serving exports at a modest batch, so they take `default`, the
    below-budget answer, as the JAX package does under `jax.export`."""
    return x if isinstance(x, int) else default


def _dense_softmax_busts_budget(b, h, n) -> bool:
    """Whether the dense arm's ~3 live [b, h, n, n] fp32 temporaries would
    pass SOFTMAX_DENSE_MEMORY_BUDGET."""
    return _concrete_bytes(3 * b * h * n * n * 4, 0) > SOFTMAX_DENSE_MEMORY_BUDGET


def softmax_needs_flash(b, h, n) -> bool:
    """Whether softmax's 'auto' takes the flash kernels at [b, h, n, *]: at
    N >= FLASH_MIN_N (the model-level time crossover), or past the byte
    budget (`_dense_softmax_busts_budget`). The JAX package's rule."""
    return n >= FLASH_MIN_N or _dense_softmax_busts_budget(b, h, n)


def softmax_arm(method: str, b, h, n, return_attention: bool = False) -> str:
    """The arm `softmax_attention` runs: 'auto' takes 'flash' where
    `softmax_needs_flash` holds and 'dense' elsewhere; with return_attention
    it takes 'dense', and raises NotImplementedError where the [b, h, n, n]
    probabilities would pass the byte budget, as the JAX package does. The
    explicit arms are taken as given."""
    if method != "auto":
        return method
    if not return_attention:
        return "flash" if softmax_needs_flash(b, h, n) else "dense"
    if _dense_softmax_busts_budget(b, h, n):
        raise NotImplementedError(
            "return_attention materialises the [B, H, N, N] probability "
            f"matrix, which exceeds the memory budget at this shape {(b, h, n)}; "
            "drop return_attention (the flash kernel path) or shrink "
            "batch/sequence.")
    return "dense"


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
            formula on any device; 'auto' the arm of `softmax_arm`.
    Returns:
        [B, H, N, D] in v's dtype, and the probabilities if return_attention.
    """
    method = softmax_arm(method, q.shape[0], q.shape[1], q.shape[2], return_attention)
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


def kerple_arm(b, h, n) -> str:
    """The arm KERPLE's 'auto' takes at [b, h, n, *]: 'dense' while
    n < KERPLE_DENSE_CROSSOVER_N and the dense arm's ~5 live [b, h, n, n]
    fp32 temporaries fit KERPLE_DENSE_MEMORY_BUDGET, the kernel ('pallas')
    past either wall. The JAX package's rule, except past the wall under a
    symbolic batch: JAX takes its fft arm there because a Pallas grid must
    be static, while the port's forward kernel is a `torch.library` op that
    `torch.export` traces at any batch, so the port takes the kernel."""
    dense_bytes = _concrete_bytes(5 * b * h * n * n * 4, 0)
    if n < KERPLE_DENSE_CROSSOVER_N and dense_bytes <= KERPLE_DENSE_MEMORY_BUDGET:
        return "dense"
    return "pallas"


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
            device; 'auto' the arm of `kerple_arm`; 'fft' the O(N log N)
            FFT path (`torch.fft`, any device).
        fft_block: head_dim block of the 'fft' path's streamed numerator.
    Returns:
        [B, H, N, D] in v's dtype.
    """
    if method == "auto":
        method = kerple_arm(q_prime.shape[0], q_prime.shape[1], q_prime.shape[2])
    if method == "pallas":
        return masked_linear_attention_coeffs(q_prime, k_prime, v, coeffs)
    if method == "dense":
        return kerple_dense(q_prime, k_prime, v, coeffs)
    if method == "fft":
        return _kerple_fft(q_prime, k_prime, v, coeffs, fft_block)
    raise ValueError(f"unknown method {method!r}")
