"""Circulant-STRING rotation along the head dim, forward and backward.

    x' = irfft(exp(i theta) * rfft(x))   per row, theta [H, N, K], K = D/2 + 1

Counterpart of `efficient_rpe_vit_tpu/ops/pallas/rotation_kernels.py`
(`_rot_kernel`, `_bwd_kernel`, `circulant_rotate`). Both kernels are
hand-written CUDA C++ for sm_90a in `csrc/circulant_rotate.cu`: the real
DFT as products against the constants of `rdft_matrices` (the JAX
package's `_rdft_matrices` formula), the rotation per frequency, the
inverse DFT, all on chip; the backward rotates the cotangent back and sums
the angle gradients over the batch in a fixed order (no float atomics).
With `keep_cls`, row 0 passes through bit for bit and gets no angle
gradient. bf16 at head dims that are multiples of 16 up to 64, with
strides that are multiples of 8 (the main paths' head-split views), runs
on `mma.sync` tensor-core products whose split bf16 constants keep fp32
accuracy (`rot_fwd_mma_kernel`, `rot_bwd_mma_kernel`); every other launch
on the staged fp32 FMA kernels. `launch_info` says which a launch runs.

The angle tables ct = cos(theta), st = sin(theta) stay outside the kernels,
so autograd owns the chain from the circulant coefficients to them, as in
the JAX package. Every kernel has a wrapper that checks its inputs, takes
the plain version (`*_reference`, fp32, written from the kernels' math) for
CPU tensors and launches the kernel for CUDA tensors (never falling back),
and counts its launches in `<wrapper>.launches`. The forward wrapper calls
the custom op `efficient_rpe_vit::circulant_rotate_fwd` (`_library.py`),
whose CPU, CUDA and fake implementations are the plain version, the launch
and a shape-only one, so `torch.export` keeps it as one node of an
exported graph. `circulant_rotate` is the differentiable op: a
`torch.autograd.Function` over the forward op whose backward is
`circulant_rotate_bwd`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ._build import dtype_suffix, launch, launch_info_buffer, launch_info_dict, load, on_cpu
from ._library import define, real_constants

MAX_D = 128  # largest head dim the kernels take (a multiple of 4)

_SOURCE = "circulant_rotate"
_DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=None)
def rdft_matrices(D: int, device=torch.device("cpu")):
    """The real DFT as products: x_re = x @ C_f, x_im = -(x @ S_f), and back
    y = y_re @ C_b - y_im @ S_b, with C_f, S_f [D, K] and C_b, S_b [K, D]
    (K = D//2 + 1) by the JAX package's `_rdft_matrices` formula, whose
    C_b / S_b weights fold the Hermitian-half doubling and the 1/D scale.
    fp32 tensors on `device`, built once per (D, device) as real, normal
    tensors (`real_constants`)."""
    k = np.arange(D // 2 + 1, dtype=np.float32)
    d = np.arange(D, dtype=np.float32)
    ang = 2 * np.pi * k[:, None] * d[None, :] / D  # [K, D]
    w = np.full(D // 2 + 1, 2.0, np.float32)
    w[0] = 1.0
    if D % 2 == 0:
        w[-1] = 1.0
    mats = (np.cos(ang).T, np.sin(ang).T,
            np.cos(ang) * w[:, None] / D, np.sin(ang) * w[:, None] / D)
    with real_constants():
        return tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device) for m in mats)


@functools.lru_cache(maxsize=None)
def _kernel_matrices(D: int, device):
    """fm = [C_f | -S_f] [D, D + 2] and bm = [C_b ; -S_b] [D + 2, D] as the
    kernels take them, the spectrum columns ordered [re_0 .. re_{h-1},
    im_0 .. im_{h-1}, re_h, im_h] with h = D // 2 (the Nyquist pair last)."""
    C_f, S_f, C_b, S_b = rdft_matrices(D, device)
    h = D // 2
    with real_constants():
        fm = torch.cat([C_f[:, :h], -S_f[:, :h], C_f[:, h:], -S_f[:, h:]], dim=1)
        bm = torch.cat([C_b[:h], -S_b[:h], C_b[h:], -S_b[h:]], dim=0)
        return fm.contiguous(), bm.contiguous()


# ─── input checks ───────────────────────────────────────────────────────

def _check(x, ct, st, g=None) -> None:
    """x (and g) [B, H, N, D] bfloat16 or float32 with a contiguous last
    dim; ct, st [H, N, D//2 + 1] float32 contiguous; all on one device; CUDA
    tensors need D a multiple of 4, at most MAX_D."""
    tensors = {"x": x, "ct": ct, "st": st}
    if g is not None:
        tensors["g"] = g
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, N, D], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}: bfloat16 or float32")
    if g is not None:
        if g.shape != x.shape:
            raise ValueError(f"g {tuple(g.shape)} != x {tuple(x.shape)}")
        if g.dtype != x.dtype:
            raise TypeError(f"g is {g.dtype}, x is {x.dtype}")
    _, H, N, D = x.shape
    table = (H, N, D // 2 + 1)
    for name, t in (("ct", ct), ("st", st)):
        if tuple(t.shape) != table or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {list(table)} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("x", "g"):
        t = tensors.get(name)
        if t is not None and t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim")
    if not on_cpu(x) and (D % 4 or D > MAX_D):
        raise ValueError(f"the rotation kernels take head dims that are "
                         f"multiples of 4 up to {MAX_D}, got {D}")


# ─── plain versions ─────────────────────────────────────────────────────
# fp32 throughout, as the kernels: the four DFT products of `_rot_kernel` and
# `_bwd_kernel`, the result rounded to x's dtype.

def _spectrum(x32, C_f, S_f):
    return x32 @ C_f, -(x32 @ S_f)


def _keep_row0(rotated: torch.Tensor, passthrough: torch.Tensor) -> torch.Tensor:
    """rotated with row 0 (the CLS token) taken from passthrough."""
    return torch.cat([passthrough[:, :, :1], rotated[:, :, 1:]], dim=2)


def circulant_rotate_fwd_reference(x, ct, st, keep_cls: bool = False) -> torch.Tensor:
    """Plain version of the forward kernel: [B, H, N, D] in x's dtype."""
    C_f, S_f, C_b, S_b = rdft_matrices(x.shape[-1], x.device)
    x32 = x.float()
    x_re, x_im = _spectrum(x32, C_f, S_f)
    y_re = ct * x_re - st * x_im
    y_im = st * x_re + ct * x_im
    y = y_re @ C_b - y_im @ S_b
    if keep_cls:
        y = _keep_row0(y, x32)
    return y.to(x.dtype)


def circulant_rotate_bwd_reference(g, x, ct, st, keep_cls: bool = False
                                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel.

    Returns:
        (dx [B, H, N, D] in x's dtype, dct, dst [H, N, K] fp32 summed over
        the batch).
    """
    C_f, S_f, C_b, S_b = rdft_matrices(x.shape[-1], x.device)
    g32 = g.float()
    dy_re, dy_im = g32 @ C_b.T, -(g32 @ S_b.T)
    if keep_cls:
        zero = torch.zeros_like(dy_re[:, :, :1])
        dy_re, dy_im = _keep_row0(dy_re, zero), _keep_row0(dy_im, zero)
    dx_re = ct * dy_re + st * dy_im
    dx_im = -st * dy_re + ct * dy_im
    dx = dx_re @ C_f.T - dx_im @ S_f.T
    if keep_cls:
        dx = _keep_row0(dx, g32)
    x_re, x_im = _spectrum(x.float(), C_f, S_f)
    dct = (dy_re * x_re + dy_im * x_im).sum(dim=0)
    dst = (dy_im * x_re - dy_re * x_im).sum(dim=0)
    return dx.to(x.dtype), dct, dst


# ─── kernels ────────────────────────────────────────────────────────────

_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib():
    lib = load(_SOURCE)
    for suffix in ("bf16", "f32"):
        fwd = getattr(lib, f"circulant_rotate_fwd_{suffix}")
        fwd.argtypes = [_PTR] * 6 + [_I32] * 5 + [_I64] * 3 + [_PTR]
        fwd.restype = _I32
        bwd = getattr(lib, f"circulant_rotate_bwd_{suffix}")
        bwd.argtypes = [_PTR] * 10 + [_I32] * 5 + [_I64] * 6 + [_PTR]
        bwd.restype = _I32
    lib.circulant_rotate_groups.argtypes = [_I32] * 4
    lib.circulant_rotate_groups.restype = _I32
    lib.circulant_rotate_launch_info.argtypes = [_I32] * 4 + [_I64] * 3 + [_PTR]
    lib.circulant_rotate_launch_info.restype = _I32
    lib.circulant_rotate_error_string.argtypes = [_I32]
    lib.circulant_rotate_error_string.restype = ctypes.c_char_p
    return lib


def batch_groups(B: int, H: int, N: int, D: int) -> int:
    """How many batch groups the backward's workspace must hold at
    [B, H, N, D]: the most that either backward kernel splits the launch
    into (asked of the kernel source, so it needs the built library); the
    backward then sums the angle gradients over them in a second pass."""
    return int(_lib().circulant_rotate_groups(B, H, N, D))


_KINDS = {"circulant_rotate_fwd": 0, "circulant_rotate_bwd": 1}


def launch_info(kernel: str, n: int, d: int, dtype: torch.dtype,
                strides: Tuple[int, int, int]) -> dict:
    """What a launch of the forward ("circulant_rotate_fwd") or backward
    ("circulant_rotate_bwd") kernel at sequence length n and head dim d in
    `dtype`, with x's (and g's) element strides (b, h, n), runs on this
    card, asked of the built library: rows per block, threads, dynamic
    shared memory bytes, resident blocks per SM, registers and local
    (spilled) bytes per thread under `_build.LAUNCH_INFO_KEYS`, and under "kernel"
    which kernel runs ("mma.sync" where bf16 meets the `rot_mma_takes` rule
    of the source, else "staged"). Needs a GPU."""
    if kernel not in _KINDS:
        raise ValueError(f"unknown rotation kernel {kernel!r}")
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype}: bfloat16 or float32")
    if n <= 0 or d <= 0 or len(strides) != 3:
        raise ValueError(f"need n, d > 0 and three strides, got n={n}, d={d}, "
                         f"strides={strides}")
    lib = _lib()
    info = launch_info_buffer()
    err = lib.circulant_rotate_launch_info(_KINDS[kernel], n, d, int(dtype == torch.bfloat16),
                                           *strides, info)
    if err != 0:
        raise RuntimeError(f"{kernel} launch info at n={n} d={d}: CUDA error {err} "
                           f"({lib.circulant_rotate_error_string(err).decode()})")
    return launch_info_dict(info)


def _fwd_cuda(x, ct, st, keep_cls):
    _check(x, ct, st)
    B, H, N, D = x.shape
    lib = _lib()
    fm, bm = _kernel_matrices(D, x.device)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    launch(lib.circulant_rotate_error_string, "circulant_rotate_fwd",
           getattr(lib, f"circulant_rotate_fwd_{dtype_suffix(x.dtype)}"), x.device,
           x, ct, st, fm, bm, out, B, H, N, D, int(keep_cls), *x.stride()[:3])
    circulant_rotate_fwd.launches += 1
    return out


def _fwd_cpu(x, ct, st, keep_cls):
    _check(x, ct, st)
    return circulant_rotate_fwd_reference(x, ct, st, keep_cls)


def _fwd_fake(x, ct, st, keep_cls):
    _check(x, ct, st)  # refuses meta tensors, which land here, like any other device
    return x.new_empty(x.shape)


_fwd_op = define("circulant_rotate_fwd",
                 "(Tensor x, Tensor ct, Tensor st, bool keep_cls) -> Tensor",
                 _fwd_cpu, _fwd_cuda, _fwd_fake)


def circulant_rotate_fwd(x, ct, st, keep_cls: bool = False) -> torch.Tensor:
    """Rotate x by the per-(head, position) half-spectrum angles. Replaces
    `_rot_kernel`; the custom op `efficient_rpe_vit::circulant_rotate_fwd`.

    Args:
        x: [B, H, N, D] bfloat16 or float32 with a contiguous last dim (other
            strides are taken as they are, so the head split's transposed
            views need no copy); on the GPU D is a multiple of 4, <= 128.
        ct, st: [H, N, D//2 + 1] float32 contiguous, cos and sin of the angles.
        keep_cls: row 0 passes through unrotated, bit for bit.
    Returns:
        Contiguous [B, H, N, D] in x's dtype.
    Raises:
        ValueError / TypeError on malformed inputs, RuntimeError when the
        kernel launch is refused.
    """
    return _fwd_op(x, ct, st, bool(keep_cls))


def circulant_rotate_bwd(g, x, ct, st, keep_cls: bool = False):
    """Backward of the rotation: the reverse rotation of g, and the angle
    gradients with the forward spectrum recomputed, summed over the batch in
    a fixed order. Replaces `_bwd_kernel`. Arguments as
    `circulant_rotate_fwd`, plus the cotangent g like x.

    Returns:
        (dx contiguous like x, dct, dst [H, N, K] float32).
    """
    _check(x, ct, st, g)
    if on_cpu(x):
        return circulant_rotate_bwd_reference(g, x, ct, st, keep_cls)
    B, H, N, D = x.shape
    lib = _lib()
    fm, bm = _kernel_matrices(D, x.device)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dct, dst = torch.empty_like(ct), torch.empty_like(st)
    groups = batch_groups(B, H, N, D)
    work = (torch.empty((2, groups) + tuple(ct.shape), dtype=torch.float32, device=x.device)
            if groups > 1 else None)
    launch(lib.circulant_rotate_error_string, "circulant_rotate_bwd",
           getattr(lib, f"circulant_rotate_bwd_{dtype_suffix(x.dtype)}"), x.device,
           g, x, ct, st, fm, bm, dx, dct, dst, work, B, H, N, D, int(keep_cls),
           *g.stride()[:3], *x.stride()[:3])
    circulant_rotate_bwd.launches += 1
    return dx, dct, dst


for _fn in (circulant_rotate_fwd, circulant_rotate_bwd):
    _fn.launches = 0
del _fn


# ─── the differentiable op ──────────────────────────────────────────────

class _CirculantRotate(torch.autograd.Function):
    """Forward kernel; backward kernel from the saved (x, ct, st)."""

    @staticmethod
    def forward(ctx, x, ct, st, keep_cls):
        out = _fwd_op(x, ct, st, keep_cls)
        ctx.save_for_backward(x, ct, st)
        ctx.keep_cls = keep_cls
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, ct, st = ctx.saved_tensors
        if g.stride(-1) != 1:
            g = g.contiguous()
        dx, dct, dst = circulant_rotate_bwd(g, x, ct, st, ctx.keep_cls)
        return dx, dct, dst, None


def circulant_rotate(x: torch.Tensor, ct: torch.Tensor, st: torch.Tensor,
                     keep_cls: bool = False) -> torch.Tensor:
    """Differentiable rotation on the kernels, [B, H, N, D] in x's dtype,
    with gradients for x, ct and st. x keeps its strides if its last dim is
    contiguous (else it is copied); ct and st are made contiguous float32.

    Without autograd (inference mode, no_grad, or no input that needs a
    gradient) autograd records no node and drops what the forward saved, so
    this is one forward launch and keeps nothing.
    """
    if x.stride(-1) != 1:
        x = x.contiguous()
    ct, st = (t.float().contiguous() for t in (ct, st))
    return _CirculantRotate.apply(x, ct, st, bool(keep_cls))
