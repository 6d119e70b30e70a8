"""Toeplitz helpers: materialisation, its VJP, and Toeplitz x matrix
products by a dense matmul or by FFT.

Counterpart of `efficient_rpe_vit_tpu/ops/fft_toeplitz.py`. Coefficients
are ordered ``[c_{-(n-1)}, ..., c_0, ..., c_{n-1}]`` and the Toeplitz
matrix is ``T[i, j] = c[(j - i) + (n - 1)]``. The FFT product uses the JAX
package's circulant embedding of length 2n-1 through `torch.fft`.
`toeplitz_matmul`'s "auto" takes the FFT product inside the JAX package's
window form (`fft_window`: `FFT_MIN_N`, `FFT_MAX_N`, `FFT_MAX_D`), whose
values here come from the H100 rows of PERF.md §6, not from JAX's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# 'auto' takes the FFT product for FFT_MIN_N <= n < FFT_MAX_N at a trailing
# dim below FFT_MAX_D, and the dense product elsewhere (the JAX package's
# window). The window is the rows of PERF.md §6 "Dispatch on the H100"
# (experiments/crossover_ab.py, rows T; NVIDIA H100 80GB HBM3, 700.00 W):
# at [8, 2, N, 44] and [2, 12, N, 266] bf16 dense wins at every N up to
# 1024 and fft from 2048 (1.50x / 1.46x), by more at 4096 (2.54x / 1.46x).
# It has no upper edge: fft's lead holds or grows with N. Its widest row is
# d = 266, so wider inputs keep the dense product.
FFT_MIN_N = 2048
FFT_MAX_N = 1 << 62
FFT_MAX_D = 267


def fft_window(n: int, d: int) -> bool:
    """Whether `toeplitz_matmul`'s 'auto' takes the FFT product for an
    [..., n, d] input."""
    return FFT_MIN_N <= n < FFT_MAX_N and d < FFT_MAX_D


def toeplitz_from_coeffs(c: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Materialise T[..., i, j] = c[..., (j - i) + (n-1)].

    Args:
        c: [..., 2n-1] coefficients.
        n: sequence length; inferred from c when None.
    Returns:
        [..., n, n] Toeplitz matrix.
    """
    m = c.shape[-1]
    if n is None:
        if m % 2 != 1:
            raise ValueError(f"coefficient length must be odd (2n-1), got {m}")
        n = (m + 1) // 2
    if m != 2 * n - 1:
        raise ValueError(f"expected {2 * n - 1} coefficients for n={n}, got {m}")
    idx = torch.arange(n, device=c.device)
    return c[..., idx[None, :] - idx[:, None] + (n - 1)]


def toeplitz_diag_sums(x: torch.Tensor) -> torch.Tensor:
    """Sum each Toeplitz diagonal: out[..., d] = sum_{j-i+n-1 = d} x[..., i, j].

    This is the VJP of `toeplitz_from_coeffs` (dcoeffs from dT). Flipping
    the rows puts diagonal d on the anti-diagonal i + j = d; padding each
    row with n zeros and re-reading the flat buffer with row length 2n-1
    shifts row i right by i, so column d of the skewed [n, 2n-1] matrix
    holds exactly that anti-diagonal. No scatter, and a fixed summation
    order.

    Args:
        x: [..., n, n].
    Returns:
        [..., 2n-1] diagonal sums, indexed by d = (j - i) + (n - 1).
    """
    n = x.shape[-1]
    lead = x.shape[:-2]
    padded = F.pad(x.flip(-2), (0, n))  # [..., n, 2n]
    skew = padded.reshape(*lead, 2 * n * n)[..., : n * (2 * n - 1)]
    return skew.reshape(*lead, n, 2 * n - 1).sum(dim=-2)


def toeplitz_matmul_dense(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """T @ x with T materialised, in fp32.

    Args:
        c: [..., 2n-1] coefficients (leading dims broadcast against x's).
        x: [..., n, d].
    Returns:
        [..., n, d] in x's dtype.
    """
    t = toeplitz_from_coeffs(c, x.shape[-2])
    return torch.matmul(t.float(), x.float()).to(x.dtype)


def toeplitz_matmul_fft(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """T @ x in O(n log n) by circulant embedding.

    The (2n-1)-circulant whose first column is
    ``[c_0, c_{-1}, ..., c_{-(n-1)}, c_{n-1}, ..., c_1]`` agrees with T on its
    leading n x n block: multiply in the frequency domain (complex64; x is
    upcast, since `torch.fft` takes no bf16), keep the first n rows, and
    cast the real part to x's dtype.

    Args:
        c: [..., 2n-1] coefficients (leading dims broadcast against x's).
        x: [..., n, d].
    Returns:
        [..., n, d] real, in x's dtype.
    """
    n = x.shape[-2]
    if c.shape[-1] != 2 * n - 1:
        raise ValueError(f"coefficient length {c.shape[-1]} != 2n-1 for n={n}")
    col = torch.cat([c[..., n - 1:n],          # c_0
                     c[..., :n - 1].flip(-1),  # c_{-1} .. c_{-(n-1)}
                     c[..., n:].flip(-1)],     # c_{n-1} .. c_1
                    dim=-1).float()
    c_fft = torch.fft.fft(col, dim=-1)  # [..., 2n-1] complex64
    x_fft = torch.fft.fft(F.pad(x.float(), (0, 0, 0, n - 1)), dim=-2)
    y = torch.fft.ifft(c_fft[..., :, None] * x_fft, dim=-2)
    return y[..., :n, :].real.to(x.dtype)


def toeplitz_matmul(c: torch.Tensor, x: torch.Tensor,
                    method: str = "auto") -> torch.Tensor:
    """Toeplitz(c) @ x.

    Args:
        c: [..., 2n-1] coefficients.
        x: [..., n, d] (also [..., n], treated as d = 1).
        method: 'dense' | 'fft' | 'auto' ('fft' inside `fft_window`, else
            'dense').
    """
    squeeze = x.dim() == c.dim()  # vector input [..., n]
    if squeeze:
        x = x[..., None]
    n = x.shape[-2]
    if c.shape[-1] != 2 * n - 1:
        raise ValueError(f"coefficient length {c.shape[-1]} != 2n-1={2 * n - 1} for n={n}")
    if method == "auto":
        method = "fft" if fft_window(n, x.shape[-1]) else "dense"
    if method == "dense":
        y = toeplitz_matmul_dense(c, x)
    elif method == "fft":
        y = toeplitz_matmul_fft(c, x)
    else:
        raise ValueError(f"unknown method {method!r}")
    return y[..., 0] if squeeze else y


def naive_toeplitz_matmul(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """O(n^2) oracle: toeplitz_from_coeffs(c) @ x in x's precision."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    y = toeplitz_from_coeffs(c, x.shape[-2]) @ x
    return y[..., 0] if squeeze else y
