"""Toeplitz-masked linear attention over a materialised T [H, N, N], forward
and backward.

    W = (q' k'^T) * T,  out = W v / (W 1 + eps),  den = W 1

Counterpart of `efficient_rpe_vit_tpu/ops/pallas/attention_kernels.py::
fused_masked_linear_attention` (`_masked_linear_fwd_impl`,
`_masked_linear_kernel`) and of `ops/pallas/masked_linear_bwd.py::
masked_linear_bwd` (`_dq_kernel`, `_dkv_kernel`, `_dt_kernel`). The forward
is hand-written CUDA C++ for sm_90a in `csrc/masked_linear_fwd.cu`, the
backward three kernels in `csrc/masked_linear_bwd.cu`. They are the
coefficient kernels (`masked_linear_coeffs.py`) with a staged tile of T in
place of the coefficient window, so T may be any [H, N, N] matrix, and the
backward also returns dT = sum_b dW*A.

Every kernel has a wrapper that checks its inputs, takes the plain version
for CPU tensors and launches the kernel for CUDA tensors (never falling
back), and counts its launches in `<wrapper>.launches`. The plain versions
are `masked_linear_fwd_reference`, `masked_linear_bwd_reference` (the
residual VJP, `masked_linear_vjp_residual`) and, per backward kernel,
`kerple_dense_bwd_dq` / `_dkv` / `_dt` of `masked_linear_coeffs.py`.
`fused_masked_linear_attention` is the differentiable op. T is read in
fp32: a bf16 T is upcast by the wrapper and dT is rounded back to T's
dtype, which is the JAX arithmetic (the Pallas bodies' `s * t` promotes).
The JAX `block_q` / `block_kv` / `interpret` arguments are TPU tiling and
have no counterpart: the kernels choose their own tiles.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ._build import dtype_suffix, launch, load, on_cpu
from .masked_linear_coeffs import (
    _check_bwd_inputs,
    _check_inputs,
    kerple_bwd_residuals,
    kerple_dense_bwd_dkv,
    kerple_dense_bwd_dq,
    kerple_dense_bwd_dt,
    kerple_dense_forward,
    masked_linear_vjp_residual,
)

_FWD_SOURCE = "masked_linear_fwd"
_BWD_SOURCE = "masked_linear_bwd"
# the backward of `fused_masked_linear_attention`: the kernels, or the
# residual formula in PyTorch; 'auto' means 'pallas' (the JAX package's
# byte budget for this choice was set from its own accelerator's memory)
BWD_MODES = ("pallas", "jnp_residual", "auto")
_T_DTYPES = (torch.float32, torch.bfloat16)


# ─── plain versions ─────────────────────────────────────────────────────

def masked_linear_fwd_reference(q_prime: torch.Tensor, k_prime: torch.Tensor,
                                v: torch.Tensor, t: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel (T read in fp32).

    Returns:
        (out [B, H, N, D] in v's dtype, den [B, H, N] fp32).
    """
    return kerple_dense_forward(q_prime, k_prime, v, t.float())


def masked_linear_bwd_reference(q_prime, k_prime, v, t, den, out, g):
    """Plain version of the backward: the residual VJP
    (`masked_linear_vjp_residual`) with T read in fp32.

    Returns:
        (dq', dk', dv in the input dtypes, dT [H, N, N] in t's dtype).
    """
    dq, dk, dv, dt = masked_linear_vjp_residual(q_prime, k_prime, v, t.float(),
                                                den, out, g)
    return dq, dk, dv, dt.to(t.dtype)


# ─── input checks and launches ──────────────────────────────────────────

def _check_t(t: torch.Tensor, H: int, N: int, device: torch.device,
             dtypes=_T_DTYPES) -> None:
    if t.shape != (H, N, N):
        raise ValueError(f"T must be [H, N, N] = [{H}, {N}, {N}], got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"T must be one of {dtypes}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"T lies on {t.device}, the other inputs on {device}")
    if not t.is_contiguous():
        raise ValueError("T must be contiguous")


@functools.cache
def _fwd_fns():
    lib = load(_FWD_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.mlt_fwd_bf16, lib.mlt_fwd_f32):
        fn.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        fn.restype = i32
    lib.mlt_error_string.argtypes = [i32]
    lib.mlt_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_fns():
    lib = load(_BWD_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for suffix in ("bf16", "f32"):
        getattr(lib, f"mlt_bwd_dq_{suffix}").argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        getattr(lib, f"mlt_bwd_dkv_{suffix}").argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        getattr(lib, f"mlt_bwd_dt_{suffix}").argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        for kind in ("dq", "dkv", "dt"):
            getattr(lib, f"mlt_bwd_{kind}_{suffix}").restype = i32
    lib.mlt_bwd_error_string.argtypes = [i32]
    lib.mlt_bwd_error_string.restype = ctypes.c_char_p
    return lib


# ─── forward ────────────────────────────────────────────────────────────

def masked_linear_fwd(q_prime: torch.Tensor, k_prime: torch.Tensor,
                      v: torch.Tensor, t: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Toeplitz-masked linear attention forward from a materialised T.
    Replaces `_masked_linear_kernel`.

    Args:
        q_prime, k_prime: [B, H, N, F] non-negative features.
        v: [B, H, N, D]; q', k' and v share a dtype (bfloat16 or float32).
        t: [H, N, N] positive mask, fp32 (or bf16, upcast here).
        All contiguous and on one device.
    Returns:
        (out [B, H, N, D] in v's dtype, den [B, H, N] fp32).
    Raises:
        ValueError / TypeError on malformed inputs, RuntimeError when the
        kernel launch is refused.
    """
    _check_inputs(q_prime, k_prime, v)
    B, H, N, F_ = q_prime.shape
    _check_t(t, H, N, q_prime.device)
    if on_cpu(q_prime):
        return masked_linear_fwd_reference(q_prime, k_prime, v, t)
    lib = _fwd_fns()
    out = torch.empty_like(v)
    den = torch.empty((B, H, N), dtype=torch.float32, device=v.device)
    launch(lib.mlt_error_string, "masked_linear_fwd",
           getattr(lib, f"mlt_fwd_{dtype_suffix(v.dtype)}"), v.device,
           q_prime, k_prime, v, t.float(), out, den, B, H, N, F_, v.shape[-1])
    masked_linear_fwd.launches += 1
    return out, den


masked_linear_fwd.launches = 0


# ─── backward kernels ───────────────────────────────────────────────────

def masked_linear_bwd_dq(gn, s, v, k_prime, t):
    """dq' = round(dW*T) k' ([B, H, N, F] in k's dtype) from gn, s
    (`kerple_bwd_residuals`), v, k' and T [H, N, N] fp32. Replaces
    `_dq_kernel`."""
    _check_bwd_inputs(gn, s, v, k_prime)
    B, H, N, F_ = k_prime.shape
    _check_t(t, H, N, v.device, (torch.float32,))
    if on_cpu(v):
        return kerple_dense_bwd_dq(gn, s, v, k_prime, t)
    lib = _bwd_fns()
    dq = torch.empty_like(k_prime)
    launch(lib.mlt_bwd_error_string, "masked_linear_bwd_dq",
           getattr(lib, f"mlt_bwd_dq_{dtype_suffix(v.dtype)}"), v.device,
           gn, s, v, k_prime, t, dq, B, H, N, F_, v.shape[-1])
    masked_linear_bwd_dq.launches += 1
    return dq


def masked_linear_bwd_dkv(gn, s, v, q_prime, k_prime, t):
    """(dk' = round(dW*T)^T q', dv = round(A*T)^T gn) in the input dtype,
    T [H, N, N] fp32. Replaces `_dkv_kernel`."""
    _check_bwd_inputs(gn, s, v, k_prime, q_prime)
    B, H, N, F_ = k_prime.shape
    _check_t(t, H, N, v.device, (torch.float32,))
    if on_cpu(v):
        return kerple_dense_bwd_dkv(gn, s, v, q_prime, k_prime, t)
    lib = _bwd_fns()
    dk = torch.empty_like(k_prime)
    dv = torch.empty_like(v)
    launch(lib.mlt_bwd_error_string, "masked_linear_bwd_dkv",
           getattr(lib, f"mlt_bwd_dkv_{dtype_suffix(v.dtype)}"), v.device,
           gn, s, v, q_prime, k_prime, t, dk, dv, B, H, N, F_, v.shape[-1])
    masked_linear_bwd_dkv.launches += 1
    return dk, dv


def masked_linear_bwd_dt(gn, s, v, q_prime, k_prime):
    """dT = sum_b dW*A, [H, N, N] fp32, summed over the batch in order (no
    atomics). Replaces `_dt_kernel`."""
    _check_bwd_inputs(gn, s, v, k_prime, q_prime)
    B, H, N, F_ = k_prime.shape
    if on_cpu(v):
        return kerple_dense_bwd_dt(gn, s, v, q_prime, k_prime)
    lib = _bwd_fns()
    dt = torch.empty((H, N, N), dtype=torch.float32, device=v.device)
    launch(lib.mlt_bwd_error_string, "masked_linear_bwd_dt",
           getattr(lib, f"mlt_bwd_dt_{dtype_suffix(v.dtype)}"), v.device,
           gn, s, v, q_prime, k_prime, dt, B, H, N, F_, v.shape[-1])
    masked_linear_bwd_dt.launches += 1
    return dt


for _fn in (masked_linear_bwd_dq, masked_linear_bwd_dkv, masked_linear_bwd_dt):
    _fn.launches = 0
del _fn


def masked_linear_bwd(q_prime, k_prime, v, t, den, out, g, need_dt: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor]]:
    """Backward of `masked_linear_fwd` from its saved (den, out): the
    residuals gn, s (`kerple_bwd_residuals`), then the dq, dkv and (when
    `need_dt`) dT kernels; CPU tensors take each kernel's plain version.

    Args:
        q_prime, k_prime, v, t: the forward's inputs.
        den [B, H, N] fp32, out [B, H, N, D]: the forward's outputs.
        g: [B, H, N, D] cotangent of out, in v's dtype, contiguous.
        need_dt: compute dT; False returns None in its place.
    Returns:
        (dq', dk', dv in the input dtypes, dT [H, N, N] in t's dtype or None).
    """
    _check_inputs(q_prime, k_prime, v)
    B, H, N, _ = q_prime.shape
    _check_t(t, H, N, q_prime.device)
    for name, x in (("out", out), ("g", g)):
        if x.shape != v.shape or x.dtype != v.dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {v.dtype} tensor "
                             f"of v's shape {tuple(v.shape)}")
    if den.shape != v.shape[:3] or den.dtype != torch.float32:
        raise ValueError("den must be [B, H, N] float32")
    gn, s = kerple_bwd_residuals(den, out, g)
    t32 = t.float()
    dq = masked_linear_bwd_dq(gn, s, v, k_prime, t32)
    dk, dv = masked_linear_bwd_dkv(gn, s, v, q_prime, k_prime, t32)
    dt = masked_linear_bwd_dt(gn, s, v, q_prime, k_prime).to(t.dtype) if need_dt else None
    return dq, dk, dv, dt


# ─── the differentiable op ──────────────────────────────────────────────

class _FusedMaskedLinear(torch.autograd.Function):
    """Forward kernel; backward from the saved (den, out), as `_fml_fwd` /
    `_fml_bwd`: the backward kernels, or the residual formula."""

    @staticmethod
    def forward(ctx, q_prime, k_prime, v, t, bwd_mode):
        out, den = masked_linear_fwd(q_prime, k_prime, v, t)
        ctx.bwd_mode = bwd_mode
        ctx.save_for_backward(q_prime, k_prime, v, t, den, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        saved = (*ctx.saved_tensors, g.contiguous())
        need_dt = ctx.needs_input_grad[3]
        if ctx.bwd_mode == "jnp_residual":
            dq, dk, dv, dt = masked_linear_bwd_reference(*saved)
            return dq, dk, dv, dt if need_dt else None, None
        return (*masked_linear_bwd(*saved, need_dt=need_dt), None)


def fused_masked_linear_attention(q_prime: torch.Tensor, k_prime: torch.Tensor,
                                  v: torch.Tensor, t: torch.Tensor,
                                  bwd_mode: str = "auto") -> torch.Tensor:
    """Differentiable Toeplitz-masked linear attention over a materialised
    T: out_i = sum_j T[i,j] (q'_i.k'_j) v_j / (sum_j T[i,j] (q'_i.k'_j) + eps).

    Args:
        q_prime, k_prime: [B, H, N, F]; v: [B, H, N, D]; t: [H, N, N].
        bwd_mode: 'pallas' runs the backward kernels (dT only when T needs
            a gradient); 'jnp_residual' the residual formula in PyTorch
            (`masked_linear_vjp_residual`, on any device); 'auto' means
            'pallas'. The JAX package takes this choice from its module
            global `MASKED_LINEAR_BWD_MODE`.
    Returns:
        [B, H, N, D] in v's dtype.
    """
    if bwd_mode not in BWD_MODES:
        raise ValueError(f"bwd_mode must be one of {BWD_MODES}, got {bwd_mode!r}")
    return _FusedMaskedLinear.apply(q_prime, k_prime, v, t,
                                    "pallas" if bwd_mode == "auto" else bwd_mode)
