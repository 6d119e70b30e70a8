"""Toeplitz helpers.

Counterpart of `efficient_rpe_vit_tpu/ops/fft_toeplitz.py`. Coefficients
are ordered ``[c_{-(n-1)}, ..., c_0, ..., c_{n-1}]`` and the Toeplitz
matrix is ``T[i, j] = c[(j - i) + (n - 1)]``. Only the materialisation the
plain KERPLE path needs and its VJP (`toeplitz_diag_sums`) are ported so
far; the FFT products come with the `method="fft"` arm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
