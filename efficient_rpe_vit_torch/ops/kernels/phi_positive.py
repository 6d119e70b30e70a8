"""The FAVOR+ positive feature map phi+ as one kernel each way.

    phi+(x) = exp(x Omega - max_f(x Omega) - ||x||^2 / 2) / sqrt(F)

`csrc/phi_positive.cu` computes `ops/feature_maps.py::phi_positive` for bf16
x [B, H, N, D] and fp32 Omega [H, D, F] in one pass that reads x and writes
phi (`phi_pos_fwd_mma_kernel`), and its backward in one pass that reads x
and the cotangent and writes dx (`phi_pos_bwd_mma_kernel`): the projection
fp32-exact on bf16 tensor cores (Omega split into three bf16 planes, never
rounded), the row max, the exp (on the special-function unit, within about
2^-21 of expf), the scale and the bf16 cast in registers.
It replaces no TPU kernel: in the JAX package XLA fuses these passes.

`feature_maps.phi_kernel_takes` is the rule: CUDA tensors, x bf16 with D <=
64 and D % 8 == 0, Omega fp32 [H, D, F] without a gradient, F even and <=
272; `phi_positive` takes this module's `phi_positive_kernel` there and the
plain chain everywhere else. Both kernels are custom ops,
`efficient_rpe_vit::phi_positive_fwd` and `::phi_positive_bwd` (`_library.py`;
CPU: the plain version, CUDA: the launch, fake: the shape), so
`torch.export` keeps phi as one node, and each carries a FLOP formula for
`torch.utils.flop_counter.FlopCounterMode`: 2 B H N D F for the forward's
x Omega, 4 B H N D F for the backward's recompute and dz Omega^T, what the
counter saw of the plain chain under `models/attention.py`'s checkpoint.
Both wrappers count their launches in `<wrapper>.launches`; CPU tensors
take the plain versions and never count.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
from torch.autograd.function import once_differentiable
from torch.utils.flop_counter import register_flop_formula

from ..feature_maps import phi_kernel_takes, phi_positive_plain
from ._build import launch, launch_info_buffer, launch_info_dict, load, on_cpu
from ._library import define

_SOURCE = "phi_positive"
_KINDS = {"phi_positive_fwd": 0, "phi_positive_bwd": 1}


def scale_of(num_features: int) -> float:
    """1 / sqrt(F) as the plain version applies it: `/ math.sqrt(F)` on a
    CUDA tensor multiplies by the fp32 reciprocal of the fp32 square root."""
    return float(np.float32(1.0) / np.float32(np.sqrt(num_features)))


# ─── plain versions ─────────────────────────────────────────────────────

def phi_positive_bwd_reference(g: torch.Tensor, x: torch.Tensor,
                               omega: torch.Tensor) -> torch.Tensor:
    """dx of the plain phi+ for the cotangent g: the backward of
    `feature_maps.phi_positive_plain` written out with autograd's rounding
    points (autograd does not run inside the backward op, whose CPU
    implementation this is), bitwise autograd's on the CPU; x's dtype."""
    proj = torch.matmul(x.float(), omega.float())
    nh = (x * x).sum(dim=-1, keepdim=True) / 2.0
    dz = (g.float() / math.sqrt(omega.shape[-1])) * torch.exp(
        proj - proj.amax(dim=-1, keepdim=True) - nh)
    dsq = (-dz).sum(dim=-1, keepdim=True).to(x.dtype) / 2.0
    return 2 * (dsq * x) + torch.matmul(dz, omega.float().transpose(-1, -2)).to(x.dtype)


# ─── input checks ───────────────────────────────────────────────────────

def _check(x, omega, g=None) -> None:
    """The kernels' rule (`phi_kernel_takes`, device aside) on x and Omega;
    g [B, H, N, F] bf16 contiguous like the output."""
    if not phi_kernel_takes(x, omega, device_rule=False):
        raise ValueError(
            f"phi+ kernels take bf16 x [B, H, N, D] with D <= 64, D % 8 == 0 and "
            f"fp32 Omega [H, D, F] without a gradient, F even <= 272: got x "
            f"{tuple(x.shape)} {x.dtype}, Omega {tuple(omega.shape)} {omega.dtype}")
    if x.device != omega.device:
        raise ValueError(f"x on {x.device}, Omega on {omega.device}")
    if g is not None:
        want = (*x.shape[:3], omega.shape[-1])
        if tuple(g.shape) != want or g.dtype != torch.bfloat16 or g.device != x.device:
            raise ValueError(f"g must be {list(want)} bfloat16 on {x.device}, got "
                             f"{tuple(g.shape)} {g.dtype} on {g.device}")


def _rows_aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself where its rows start 16-byte aligned (a contiguous last dim,
    the other strides multiples of 8, an aligned base), else a contiguous
    copy."""
    if (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


# ─── kernels ────────────────────────────────────────────────────────────

_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib():
    lib = load(_SOURCE)
    lib.phi_pos_fwd_bf16.argtypes = [_PTR] * 3 + [_I32] * 5 + [_I64] * 3 + [ctypes.c_float, _PTR]
    lib.phi_pos_fwd_bf16.restype = _I32
    lib.phi_pos_bwd_bf16.argtypes = [_PTR] * 4 + [_I32] * 5 + [_I64] * 6 + [ctypes.c_float, _PTR]
    lib.phi_pos_bwd_bf16.restype = _I32
    lib.phi_pos_products.argtypes = [_I32] + [_PTR] * 4 + [_I32] * 5 + [_I64] * 3 + [
        ctypes.c_float, _PTR]
    lib.phi_pos_products.restype = _I32
    lib.phi_pos_takes.argtypes = [_I32, _I32]
    lib.phi_pos_takes.restype = _I32
    lib.phi_pos_launch_info.argtypes = [_I32] * 3 + [_PTR]
    lib.phi_pos_launch_info.restype = _I32
    lib.phi_pos_error_string.argtypes = [_I32]
    lib.phi_pos_error_string.restype = ctypes.c_char_p
    return lib


def kernel_rule(d: int, f: int) -> bool:
    """The built library's own (D, F) rule, to hold the Python rule against
    (needs a GPU build)."""
    return bool(_lib().phi_pos_takes(d, f))


def launch_info(kernel: str, f: int, d: int) -> dict:
    """What a launch of "phi_positive_fwd" or "phi_positive_bwd" at F
    features and head dim d runs on this card, asked of the built library:
    rows a warp takes at a time, threads, dynamic shared memory bytes,
    resident blocks per SM, registers and local (spilled) bytes per thread
    under `_build.LAUNCH_INFO_KEYS`, and "kernel": "mma.sync". Needs a GPU."""
    if kernel not in _KINDS:
        raise ValueError(f"unknown phi+ kernel {kernel!r}")
    lib = _lib()
    info = launch_info_buffer()
    err = lib.phi_pos_launch_info(_KINDS[kernel], f, d, info)
    if err != 0:
        raise RuntimeError(f"{kernel} launch info at f={f} d={d}: CUDA error {err} "
                           f"({lib.phi_pos_error_string(err).decode()})")
    return launch_info_dict(info)


def kernel_products(x: torch.Tensor, omega: torch.Tensor, dz=None) -> torch.Tensor:
    """The kernels' fp32 products alone, for checks of their precision: u =
    x Omega [B, H, N, F] as the forward kernel forms it, or, given an fp32
    dz [B, H, N, F], dz Omega^T [B, H, N, D] as the backward kernel forms it
    from its own dz. CUDA tensors under the kernels' rule; not counted in
    `.launches`."""
    _check(x, omega)
    want = (*x.shape[:3], omega.shape[-1])
    if dz is not None and (tuple(dz.shape) != want or dz.dtype != torch.float32):
        raise ValueError(f"dz must be {list(want)} float32, got {tuple(dz.shape)} {dz.dtype}")
    x = _rows_aligned(x)
    omega = omega.contiguous()
    B, H, N, D = x.shape
    F = omega.shape[-1]
    lib = _lib()
    y = torch.empty((B, H, N, F if dz is None else D), dtype=torch.float32, device=x.device)
    launch(lib.phi_pos_error_string, "phi_positive products", lib.phi_pos_products, x.device,
           int(dz is not None), None if dz is None else dz.contiguous(), x, omega, y,
           B, H, N, D, F, *x.stride()[:3], scale_of(F))
    return y


def _fwd_cuda(x, omega):
    _check(x, omega)
    x = _rows_aligned(x)
    omega = omega.contiguous()
    B, H, N, D = x.shape
    F = omega.shape[-1]
    lib = _lib()
    out = torch.empty((B, H, N, F), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    launch(lib.phi_pos_error_string, "phi_positive_fwd", lib.phi_pos_fwd_bf16, x.device,
           x, omega, out, B, H, N, D, F, *x.stride()[:3], scale_of(F))
    phi_positive_fwd.launches += 1
    return out


def _fwd_cpu(x, omega):
    _check(x, omega)
    return phi_positive_plain(x, omega)


def _fwd_fake(x, omega):
    _check(x, omega)
    on_cpu(x)  # meta tensors land here: refused like any other device
    return x.new_empty((*x.shape[:3], omega.shape[-1]))


_fwd_op = define("phi_positive_fwd", "(Tensor x, Tensor omega) -> Tensor",
                 _fwd_cpu, _fwd_cuda, _fwd_fake)


def phi_positive_fwd(x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """phi+(x) on the forward kernel (the plain version for CPU tensors):
    [B, H, N, F] bf16, contiguous. The custom op
    `efficient_rpe_vit::phi_positive_fwd`.

    Args:
        x: [B, H, N, D] bfloat16, D <= 64 with D % 8 == 0; rows that are not
            16-byte aligned are copied first.
        omega: [H, D, F] float32 without a gradient, F even and <= 272.
    Raises:
        ValueError outside that rule, RuntimeError when the launch is refused.
    """
    return _fwd_op(x, omega)


def _dx_like(x: torch.Tensor) -> torch.Tensor:
    """dx's buffer: x's strides where x is dense with its last dim
    contiguous, else contiguous."""
    if x.stride(-1) == 1:
        return torch.empty_like(x)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _bwd_cuda(g, x, omega):
    _check(x, omega, g)
    dx = _dx_like(x)
    x = _rows_aligned(x)
    omega = omega.contiguous()
    g = g.contiguous()
    B, H, N, D = x.shape
    F = omega.shape[-1]
    if B == 0:
        return dx
    lib = _lib()
    launch(lib.phi_pos_error_string, "phi_positive_bwd", lib.phi_pos_bwd_bf16, x.device,
           g, x, omega, dx, B, H, N, D, F, *x.stride()[:3], *dx.stride()[:3], scale_of(F))
    phi_positive_bwd.launches += 1
    return dx


def _bwd_cpu(g, x, omega):
    _check(x, omega, g)
    return _dx_like(x).copy_(phi_positive_bwd_reference(g, x, omega))


def _bwd_fake(g, x, omega):
    _check(x, omega, g)
    on_cpu(x)
    return _dx_like(x)


_bwd_op = define("phi_positive_bwd", "(Tensor g, Tensor x, Tensor omega) -> Tensor",
                 _bwd_cpu, _bwd_cuda, _bwd_fake)


def phi_positive_bwd(g: torch.Tensor, x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """dx of phi+ for the cotangent g [B, H, N, F] (bf16) on the backward
    kernel, which recomputes the projection, its row max and exp bitwise as
    the forward did (`phi_positive_bwd_reference` for CPU tensors). dx has
    x's dtype and shape, and x's strides where x's last dim is contiguous
    (else it is contiguous). The custom op
    `efficient_rpe_vit::phi_positive_bwd`."""
    return _bwd_op(g, x, omega)


@register_flop_formula(_fwd_op.overloadpacket)
def _fwd_flops(x_shape, omega_shape, *args, out_shape=None, **kwargs) -> int:
    """x Omega: 2 B H N D F."""
    B, H, N, D = x_shape
    return 2 * B * H * N * D * omega_shape[-1]


@register_flop_formula(_bwd_op.overloadpacket)
def _bwd_flops(g_shape, x_shape, omega_shape, *args, out_shape=None, **kwargs) -> int:
    """The recompute of x Omega and dz Omega^T: 4 B H N D F."""
    return 2 * _fwd_flops(x_shape, omega_shape)


for _fn in (phi_positive_fwd, phi_positive_bwd):
    _fn.launches = 0
del _fn


# ─── the differentiable op ──────────────────────────────────────────────

class _PhiPositive(torch.autograd.Function):
    """Forward kernel; backward kernel from the saved x and Omega (nothing
    of phi is kept: the backward recomputes the projection)."""

    @staticmethod
    def forward(ctx, x, omega):
        ctx.save_for_backward(x, omega)
        return _fwd_op(x, omega)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, omega = ctx.saved_tensors
        return phi_positive_bwd(g, x, omega), None


def phi_positive_kernel(x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Differentiable phi+ on the kernels, for inputs that meet
    `phi_kernel_takes` (x gets a gradient, Omega none). Without autograd
    (inference mode, no_grad, or x without a gradient) this is one forward
    launch and keeps nothing."""
    return _PhiPositive.apply(x, omega)
