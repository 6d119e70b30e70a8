"""Positional rotations: RoPE (1D), axial RoPE2D and Circulant-STRING.

Counterpart of `efficient_rpe_vit_tpu/ops/rotations.py`.

RoPE: frequencies theta_m = base^(-2m/d); interleaved even/odd lane pairs
rotated by pos * theta_m, over the token index including CLS (the
reference's 1D behaviour). The pairs are formed by indexing (the JAX
package multiplies by a +-1 pairing matrix, a TPU layout workaround; both
are exact). Math in fp32, the result cast back to the input dtype.

Circulant-STRING: R(r) = exp(sum_k r_k L_k) with L_k = C_k - C_k^T
circulant and skew-symmetric, diagonalised by the DFT, applied as
x' = irfft(exp(i theta) * rfft(x)) along head_dim over the real half
spectrum; CLS (token 0) is not rotated.

Dispatch. The JAX package's tri-state `USE_PALLAS_ROTATION` (an
environment variable) is replaced by an explicit `method`:
  * 'pallas' runs the hand-written rotation kernels
    (`ops/kernels/circulant_rotate.py`; their plain version for CPU
    tensors), fp32 spectra inside;
  * 'chain' runs the plain DFT-product chain on any device, with the JAX
    package's `CHAIN_INPUT_DTYPE` semantics: the spectra are rounded to the
    input dtype between products, the sums are fp32 (about 1% apart from
    the kernel arm in bf16; ROADMAP Queue C);
  * 'auto' is the JAX package's `rotation_kernel_enabled` under "auto"
    (`_resolve`): the kernels when the caller says the rotated q and k feed
    a kernel (`prefer_kernel`), the chain otherwise. The attention modules
    pass it as JAX computes it, except that a symbolic batch under
    `torch.export` does not turn it off (the kernel op exports at any
    batch), and the linear ones also under KERNEL_BEFORE_PHI, which the
    H100 rows of PERF.md §6 set.
Block-circulant rotation runs the chain only, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch

from .kernels._library import real_constants
from .kernels.circulant_rotate import circulant_rotate, rdft_matrices

METHODS = ("auto", "pallas", "chain")


# Whether the linear-attention modules ask for the rotation kernels, whose
# rotated q and k feed the phi projections (plain PyTorch) and not a kernel.
# The JAX package never does (its XLA chain fused into the projections);
# on the card the kernels win full ViT-B train steps there too
# (experiments/rotation_kernel_ab.py, rows R of PERF.md §6 "Dispatch on
# the H100", NVIDIA H100 80GB HBM3, 700.00 W): performer_favor_circulant
# 1.28x at N=197, 1.30x at N=4097; performer_relu_circulant 1.34x, 1.38x
# (baseline_circulant, before flash: 1.79x, 1.47x).
KERNEL_BEFORE_PHI = True


def _resolve(method: str, prefer_kernel: bool = False) -> str:
    if method not in METHODS:
        raise ValueError(f"unknown rotation method {method!r}: one of {METHODS}")
    if method == "auto":  # the JAX rule under USE_PALLAS_ROTATION = "auto"
        return "pallas" if prefer_kernel else "chain"
    return method


# ─── RoPE ───────────────────────────────────────────────────────────────

def rope_tables(num_positions: int, head_dim: int, theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [num_positions, head_dim // 2] float32 (CPU), the
    JAX package's numpy tables bit for bit."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    angles = np.arange(num_positions, dtype=np.float32)[:, None] * freqs[None, :]
    return torch.from_numpy(np.cos(angles)), torch.from_numpy(np.sin(angles))


def _rope_full_tables(cos: torch.Tensor, sin: torch.Tensor, N: int):
    """Half-width tables [N', D/2] -> full width [N, D], every lane twice."""
    return (cos[:N].repeat_interleave(2, dim=-1),
            sin[:N].repeat_interleave(2, dim=-1))


def _rope_pairs(x32: torch.Tensor) -> torch.Tensor:
    """The 90-degree partner of each lane: out[2i] = -x[2i+1],
    out[2i+1] = x[2i]."""
    return torch.stack((-x32[..., 1::2], x32[..., 0::2]), dim=-1).flatten(-2)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos, sin):
    """Rotate interleaved even/odd lane pairs of q and k:
    [x_even, x_odd] -> [x_even cos - x_odd sin, x_even sin + x_odd cos].

    Args:
        q, k: [B, H, N, D].
        cos, sin: [N', D//2] with N' >= N (sliced to N).
    Returns:
        (q_rot, k_rot), same shapes and dtypes as the inputs.
    """
    N = q.shape[2]
    cos_full, sin_full = (t.to(device=q.device, dtype=torch.float32)
                          for t in _rope_full_tables(torch.as_tensor(cos),
                                                     torch.as_tensor(sin), N))

    def rot(x):
        x32 = x.float()
        return (x32 * cos_full + _rope_pairs(x32) * sin_full).to(x.dtype)

    return rot(q), rot(k)


def rope_2d_tables(num_patch_tokens: int, head_dim: int, theta: float = 100.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Axial 2D RoPE tables over the patch grid: the first half of the
    head dim rotates by the x coordinate, the second by y.

    Returns:
        (cos, sin): [num_patch_tokens, head_dim // 2] float32 for the patch
        tokens only (CLS is handled by `apply_rope_2d`).
    """
    if head_dim % 4 != 0:
        raise ValueError(f"axial 2D RoPE needs head_dim % 4 == 0, got {head_dim}")
    pos = grid_positions_2d(num_patch_tokens).numpy()  # [N, 2] = (x, y)
    quarter = head_dim // 4
    freqs = 1.0 / (theta ** (np.arange(quarter, dtype=np.float32) / quarter))
    angles = np.concatenate([pos[:, 0:1] * freqs[None, :],
                             pos[:, 1:2] * freqs[None, :]], axis=-1)
    return torch.from_numpy(np.cos(angles)), torch.from_numpy(np.sin(angles))


def apply_rope_2d(q: torch.Tensor, k: torch.Tensor, cos, sin):
    """Axial 2D rotary embedding; CLS (token 0) passes through unrotated
    (an identity row, cos = 1 and sin = 0, before the patch tables: x * 1 +
    partner * 0 is x exactly).

    Args:
        q, k: [B, H, N, D] with CLS at index 0.
        cos, sin: [N-1, D//2] patch-token tables from rope_2d_tables.
    """
    if q.shape[2] <= 1:
        return q, k
    n_patch = q.shape[2] - 1
    cos, sin = torch.as_tensor(cos)[:n_patch], torch.as_tensor(sin)[:n_patch]
    cos_all = torch.cat([torch.ones_like(cos[:1]), cos])
    sin_all = torch.cat([torch.zeros_like(sin[:1]), sin])
    return apply_rope(q, k, cos_all, sin_all)


# ─── Circulant-STRING ───────────────────────────────────────────────────

def grid_positions_2d(num_patch_tokens: int, coord_dim: int = 2) -> torch.Tensor:
    """Row-major integer (x, y) grid of a square patch layout:
    position[i*W + j] = (j, i), zero-padded (or cut) to coord_dim columns.

    Returns:
        [num_patch_tokens, coord_dim] float32 (CPU).
    """
    if num_patch_tokens <= 0:
        return torch.zeros(0, coord_dim)
    side = int(np.sqrt(num_patch_tokens))
    if side * side != num_patch_tokens:
        raise ValueError(
            f"num_patch_tokens={num_patch_tokens} must be a perfect square "
            "for 2D position encoding"
        )
    yy, xx = np.meshgrid(np.arange(side, dtype=np.float32),
                         np.arange(side, dtype=np.float32), indexing="ij")
    pos = np.stack([xx.ravel(), yy.ravel()], axis=-1)  # [n, 2] = (x, y)
    out = np.zeros((num_patch_tokens, coord_dim), np.float32)
    out[:, :min(2, coord_dim)] = pos[:, :min(2, coord_dim)]
    return torch.from_numpy(out)


def circulant_eigenvalues(coeffs: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of L = C - C^T from circulant first-row coefficients,
    FFT(c) - conj(FFT(c)) = 2i Im(FFT(c)): [..., D] complex64, purely
    imaginary (a diagnostic; the rotations use `_circulant_theta`)."""
    lam = torch.fft.fft(coeffs.float(), dim=-1)
    return lam - lam.conj()


@functools.lru_cache(maxsize=None)
def _sin_dft_t(block: int, device) -> torch.Tensor:
    """-sin(2 pi k d / block) as [block, K], cached as a real, normal tensor
    (`real_constants`)."""
    k = np.arange(block // 2 + 1, dtype=np.float32)
    d = np.arange(block, dtype=np.float32)
    with real_constants():
        return torch.from_numpy(-np.sin(2 * np.pi * k[:, None] * d[None, :] / block).T
                                ).contiguous().to(device)


def _circulant_theta(positions: torch.Tensor, coeffs: torch.Tensor, block: int) -> torch.Tensor:
    """Rotation angles theta[h, n, (nb,) k] = 2 sum_c pos[n, c] Im(FFT(c_h,c))_k
    at the rfft frequencies k = 0..block//2 of a length-`block` circulant,
    fp32; Im(FFT(c))_k = -sum_d c_d sin(2 pi k d / block) as one product.

    Args:
        positions: [N, coord_dim].
        coeffs: [H, coord_dim, D] or [H, coord_dim, nb, block].
    Returns:
        Contiguous [H, N, K] or [H, N, nb, K].
    """
    im_fft = coeffs.float() @ _sin_dft_t(block, coeffs.device)  # [H, C, (nb,) K]
    H, C = im_fft.shape[:2]
    pos = positions.to(device=coeffs.device, dtype=torch.float32)
    theta = pos @ im_fft.reshape(H, C, -1)  # contract the coord dim: [H, N, (nb *) K]
    return 2.0 * theta.reshape(H, pos.shape[0], *im_fft.shape[2:])


def _rdft_matrices(D: int, device=torch.device("cpu")):
    """(C_f, S_f [D, K], C_b, S_b [K, D]) fp32: x_re = x @ C_f,
    x_im = -(x @ S_f), y = y_re @ C_b - y_im @ S_b."""
    return rdft_matrices(D, torch.device(device))


def _dft_chain(x, ct, st, C_f, S_f, C_b, S_b):
    """Spectrum -> rotate -> inverse as plain products, the intermediates
    rounded to x's dtype (a no-op in fp32) and every sum in fp32: the JAX
    package's chain with CHAIN_INPUT_DTYPE = True."""
    dt = x.dtype
    x_re = (x.float() @ C_f.to(dt).float()).to(dt)
    x_im = (-(x.float() @ S_f.to(dt).float())).to(dt)
    y_re = (ct * x_re - st * x_im).to(dt)
    y_im = (st * x_re + ct * x_im).to(dt)
    return (y_re.float() @ C_b.to(dt).float()
            - y_im.float() @ S_b.to(dt).float()).to(dt)


def apply_circulant_rotation(x: torch.Tensor, positions: torch.Tensor,
                             coeffs: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """x' = exp(sum_k r_k L_k) x through the real half spectrum along
    head_dim.

    Args:
        x: [B, H, N, D].
        positions: [N, coord_dim].
        coeffs: [H, coord_dim, D] learnable circulant coefficients.
        method: 'pallas', 'chain' or 'auto' (module docstring).
    Returns:
        [B, H, N, D] rotated, in x's dtype.
    """
    D = x.shape[-1]
    theta = _circulant_theta(positions, coeffs, D)  # [H, N, K]
    ct, st = torch.cos(theta), torch.sin(theta)
    if _resolve(method) == "pallas":
        return circulant_rotate(x, ct, st)
    return _dft_chain(x, ct[None], st[None], *_rdft_matrices(D, x.device))


def apply_block_circulant_rotation(x: torch.Tensor, positions: torch.Tensor,
                                   coeffs: torch.Tensor) -> torch.Tensor:
    """Block-circulant rotation: head_dim split into independent circulant
    blocks, each with its own generator (the chain only).

    Args:
        x: [B, H, N, D].
        positions: [N, coord_dim].
        coeffs: [H, coord_dim, num_blocks, block_size] with
            num_blocks * block_size == D.
    """
    B, H, N, D = x.shape
    nb, bs = coeffs.shape[-2], coeffs.shape[-1]
    if nb * bs != D:
        raise ValueError(f"num_blocks*block_size = {nb}*{bs} != head_dim {D}")
    theta = _circulant_theta(positions, coeffs, bs)  # [H, N, nb, K]
    ct, st = torch.cos(theta)[None], torch.sin(theta)[None]
    xb = x.reshape(B, H, N, nb, bs)
    return _dft_chain(xb, ct, st, *_rdft_matrices(bs, x.device)).reshape(B, H, N, D)


def _with_cls_position(positions: torch.Tensor) -> torch.Tensor:
    """positions with a zero row prepended for CLS (its rotation is then the
    identity)."""
    return torch.nn.functional.pad(positions, (0, 0, 1, 0))


def _rotate_keep_cls(rotate_fn: Callable, x: torch.Tensor, positions: torch.Tensor,
                     coeffs: torch.Tensor) -> torch.Tensor:
    """Rotate all N tokens with a zero position for CLS, then take row 0
    from x, so CLS is untouched bit for bit."""
    x_rot = rotate_fn(x, _with_cls_position(positions), coeffs)
    is_cls = (torch.arange(x.shape[2], device=x.device) == 0)[None, None, :, None]
    return torch.where(is_cls, x, x_rot)


def apply_circulant_string(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                           coeffs: torch.Tensor, method: str = "auto",
                           prefer_kernel: bool = False):
    """Rotate the patch tokens of q and k; CLS (index 0) passes through.

    `prefer_kernel`: the caller's word that the rotated q and k feed a
    kernel, which 'auto' turns into the kernel arm (`_resolve`). On the
    kernel arm the angle tables are computed once and shared by q and k,
    and the kernel keeps CLS itself (`keep_cls`)."""
    if q.shape[2] <= 1:
        return q, k
    if _resolve(method, prefer_kernel) == "pallas":
        theta = _circulant_theta(_with_cls_position(positions), coeffs, q.shape[-1])
        ct, st = torch.cos(theta), torch.sin(theta)
        return (circulant_rotate(q, ct, st, keep_cls=True),
                circulant_rotate(k, ct, st, keep_cls=True))
    chain = functools.partial(apply_circulant_rotation, method="chain")
    return (_rotate_keep_cls(chain, q, positions, coeffs),
            _rotate_keep_cls(chain, k, positions, coeffs))
