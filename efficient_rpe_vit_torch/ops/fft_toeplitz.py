"""Toeplitz helpers.

Counterpart of `efficient_rpe_vit_tpu/ops/fft_toeplitz.py`. Coefficients
are ordered ``[c_{-(n-1)}, ..., c_0, ..., c_{n-1}]`` and the Toeplitz
matrix is ``T[i, j] = c[(j - i) + (n - 1)]``. Only the materialisation the
plain KERPLE path needs is ported so far; the FFT products come with the
`method="fft"` arm.
"""

from __future__ import annotations

import torch


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
