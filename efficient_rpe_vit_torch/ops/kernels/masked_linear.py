"""Toeplitz-masked linear attention over a materialised T [H, N, N], forward
and backward.

    W = (q' k'^T) * T,  out = W v / (W 1 + eps),  den = W 1

Counterpart of `efficient_rpe_vit_tpu/ops/pallas/attention_kernels.py::
fused_masked_linear_attention` (`_masked_linear_fwd_impl`,
`_masked_linear_kernel`) and of `ops/pallas/masked_linear_bwd.py::
masked_linear_bwd` (`_dq_kernel`, `_dkv_kernel`, `_dt_kernel`). The forward
is hand-written CUDA C++ for sm_90a in `csrc/masked_linear_fwd.cu`, the
backward three kernels in `csrc/masked_linear_bwd.cu`. In bf16 (at even
F <= 272, D <= 64: `mma_takes`) the forward, dq and dkv are the coefficient
kernels' register-resident mainloops (`masked_linear_coeffs.py`) with T's
tiles in place of the coefficient window, so T may be any [H, N, N]
matrix, and dT = sum_b dW*A sums the batch in groups into a scratch of
partial sums that a second kernel adds in order; fp32 and the other shapes
take the staged first versions.

Every kernel has a wrapper that checks its inputs, takes the plain version
for CPU tensors and launches the kernel for CUDA tensors (never falling
back), and counts its launches in `<wrapper>.launches`. The plain versions
are `masked_linear_fwd_reference`, `masked_linear_bwd_reference` (the
residual VJP, `masked_linear_vjp_residual`) and, per backward kernel,
`kerple_dense_bwd_dq` / `_dkv` / `_dt` of `masked_linear_coeffs.py`.
`fused_masked_linear_attention` is the differentiable op. `launch_info`
reports what a launch runs on the card; `dt_batch_groups` and
`dt_scratch_floats` mirror the dT kernel's batch groups and the scratch of
their partial sums that the dT wrapper allocates. T is read in
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

from ._build import LAUNCH_INFO_KEYS  # noqa: F401 (re-exported: what launch_info reports)
from ._build import dtype_suffix, launch, launch_info_buffer, launch_info_dict, load, on_cpu
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
# residual formula in PyTorch; 'auto' is `masked_linear_bwd_mode`'s choice
BWD_MODES = ("pallas", "jnp_residual", "auto")
# 'auto' keeps the residual backward only below this N (and the byte
# budget). The backward kernels win every row measured (PERF.md §6
# "Dispatch on the H100", rows M; NVIDIA H100 80GB HBM3, 700.00 W): the
# dq + dkv kernels against the residual backward 3.5x at B=256 H=2 N=197
# F=44 D=16, 5.8x at B=8 H=2 N=1024, 4.2x at B=32 H=4 N=512 F=128 D=64,
# 4.2x at B=4 H=12 N=4097 F=266 D=64 (chip_smoke.py phase 3f), and whole
# gradients through `fused_masked_linear_attention` 1.43x / 1.66x / 1.51x
# at the first three (experiments/pallas_ab.py). No row has the residual
# backward ahead, so the kernels take every N.
MASKED_LINEAR_BWD_CROSSOVER_N = 0
_T_DTYPES = (torch.float32, torch.bfloat16)

# dT's batch groups, as `dt_groups` in csrc/masked_linear_bwd.cu computes
# them for a bf16 launch its mma.sync kernel takes: blocks of DT_TILE =
# (query rows, key/value rows) per head and batch group, run in waves of
# (blocks per SM) x DT_SMS; at most DT_SCRATCH_CAP fp32 partial sums
# (32 MiB) when there is more than one group
DT_TILE = (128, 64)
DT_SMS = 132
DT_SCRATCH_CAP = 8 << 20


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


def mma_takes(f: int, d: int, dtype: torch.dtype) -> bool:
    """Whether a launch at feature count f and value dim d in `dtype` runs
    the register-resident mma.sync kernels (the sources' `*_mma_takes`
    rule: bf16 at even f <= 272, d <= 64); the staged kernels run the rest."""
    return dtype == torch.bfloat16 and f <= 272 and f % 2 == 0 and d <= 64


def dt_batch_groups(B: int, H: int, N: int, F: int, D: int, dtype: torch.dtype) -> int:
    """The batch groups a dT launch at [B, H, N, F, D] in `dtype` splits the
    batch into (1 for the staged kernel, which sums it in one block): of
    the counts that leave no group empty (groups of ceil(B / groups)
    elements), the fewest that minimise waves x elements per group, a wave
    being (blocks per SM: 2 for the narrow F <= 64, D <= 16 kernel, else 1)
    x DT_SMS blocks and a block summing its group's elements one after
    another; at most DT_SCRATCH_CAP partial sums. Mirrors `dt_groups` in
    csrc/masked_linear_bwd.cu (chip_smoke.py holds the two equal on the
    card)."""
    if not mma_takes(F, D, dtype):
        return 1
    rows, cols = DT_TILE
    blocks = -(-N // rows) * -(-N // cols) * H
    slots = (2 if F <= 64 and D <= 16 else 1) * DT_SMS
    best, best_cost = 1, -(-blocks // slots) * B
    for groups in range(2, B + 1):
        if groups * H * N * N > DT_SCRATCH_CAP:
            break
        per = -(-B // groups)
        if -(-B // per) != groups:  # a group would be empty
            continue
        cost = -(-(blocks * groups) // slots) * per
        if cost < best_cost:
            best, best_cost = groups, cost
    return best


def dt_scratch_floats(B: int, H: int, N: int, F: int, D: int, dtype: torch.dtype) -> int:
    """fp32 values of the scratch a dT launch needs: the partial sums
    [groups, H, N, N] of its batch groups where there is more than one, else
    0 (dT is written directly)."""
    groups = dt_batch_groups(B, H, N, F, D, dtype)
    return groups * H * N * N if groups > 1 else 0


@functools.cache
def _fwd_fns():
    lib = load(_FWD_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.mlt_fwd_bf16, lib.mlt_fwd_f32):
        fn.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        fn.restype = i32
    lib.mlt_fwd_launch_info.argtypes = [i32] * 4 + [ptr]
    lib.mlt_fwd_launch_info.restype = i32
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
        getattr(lib, f"mlt_bwd_dt_{suffix}").argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
        for kind in ("dq", "dkv", "dt"):
            getattr(lib, f"mlt_bwd_{kind}_{suffix}").restype = i32
    lib.mlt_bwd_dt_scratch_floats.argtypes = [i32] * 6
    lib.mlt_bwd_dt_scratch_floats.restype = ctypes.c_longlong
    lib.mlt_bwd_dt_groups.argtypes = [i32] * 6
    lib.mlt_bwd_dt_groups.restype = i32
    lib.mlt_bwd_launch_info.argtypes = [i32] * 5 + [ptr]
    lib.mlt_bwd_launch_info.restype = i32
    lib.mlt_bwd_error_string.argtypes = [i32]
    lib.mlt_bwd_error_string.restype = ctypes.c_char_p
    return lib


_BWD_KINDS = {"masked_linear_bwd_dq": 0, "masked_linear_bwd_dkv": 1, "masked_linear_bwd_dt": 2}


def launch_info(kernel: str, n: int, f: int, d: int, dtype: torch.dtype) -> dict:
    """What a launch of the forward ("masked_linear_fwd") or of the backward
    kernel `kernel` ("masked_linear_bwd_dq", "..._dkv" or "..._dt") at
    sequence length n, feature count f and value dim d in `dtype` runs on
    this card, asked of the built library: rows per block (per tile for a
    staged kernel), threads, dynamic shared memory bytes, resident blocks
    per SM, registers and local (spilled) bytes per thread under
    `LAUNCH_INFO_KEYS`, and under "kernel" which kernel runs ("mma.sync" by
    `mma_takes`, else "staged"). Needs a GPU: raises RuntimeError without
    one."""
    if kernel != _FWD_SOURCE and kernel not in _BWD_KINDS:
        raise ValueError(f"unknown materialised-T kernel {kernel!r}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"unsupported dtype {dtype}: bfloat16 or float32")
    if n <= 0 or f <= 0 or d <= 0:
        raise ValueError(f"need n, f, d > 0, got n={n}, f={f}, d={d}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{kernel} launch info needs a GPU: no CUDA device is available")
    info = launch_info_buffer()
    is_bf16 = int(dtype == torch.bfloat16)
    if kernel == _FWD_SOURCE:
        lib = _fwd_fns()
        err, errors = lib.mlt_fwd_launch_info(n, f, d, is_bf16, info), lib.mlt_error_string
    else:
        lib = _bwd_fns()
        err = lib.mlt_bwd_launch_info(_BWD_KINDS[kernel], n, f, d, is_bf16, info)
        errors = lib.mlt_bwd_error_string
    if err != 0:
        raise RuntimeError(f"{kernel} launch info at n={n} f={f} d={d}: CUDA error "
                           f"{err} ({errors(err).decode()})")
    return launch_info_dict(info)


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
    """dT = sum_b dW*A, [H, N, N] fp32, summed over the batch in a fixed
    order (no atomics): the bf16 mma.sync kernel sums each batch group in
    order into a scratch of partial sums allocated here (`dt_scratch_floats`
    as the built library counts it), then the groups in order. Replaces
    `_dt_kernel`."""
    _check_bwd_inputs(gn, s, v, k_prime, q_prime)
    B, H, N, F_ = k_prime.shape
    D = v.shape[-1]
    if on_cpu(v):
        return kerple_dense_bwd_dt(gn, s, v, q_prime, k_prime)
    lib = _bwd_fns()
    dt = torch.empty((H, N, N), dtype=torch.float32, device=v.device)
    floats = lib.mlt_bwd_dt_scratch_floats(B, H, N, F_, D, int(v.dtype == torch.bfloat16))
    scratch = torch.empty(floats, dtype=torch.float32, device=v.device) if floats > 0 else None
    launch(lib.mlt_bwd_error_string, "masked_linear_bwd_dt",
           getattr(lib, f"mlt_bwd_dt_{dtype_suffix(v.dtype)}"), v.device,
           gn, s, v, q_prime, k_prime, dt, scratch, B, H, N, F_, D)
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


def masked_linear_bwd_mode(b, h, n) -> str:
    """The backward 'auto' takes at [b, h, n, *]: the kernels ('pallas') at
    n >= MASKED_LINEAR_BWD_CROSSOVER_N (the time crossover) or once the
    residual backward's ~5 live [b, h, n, n] fp32 temporaries pass
    `attention_core.KERPLE_DENSE_MEMORY_BUDGET`, the residual formula
    ('jnp_residual') below both. The byte form is the JAX package's
    `_masked_linear_bwd_wants_pallas`, which has no time crossover (the
    residual backward below the budget at every N); under a symbolic batch
    (`torch.export`) the count is inconclusive and counts as below budget,
    as in JAX."""
    from ..attention_core import KERPLE_DENSE_MEMORY_BUDGET, _concrete_bytes

    past = _concrete_bytes(5 * b * h * n * n * 4, 0) > KERPLE_DENSE_MEMORY_BUDGET
    return "pallas" if n >= MASKED_LINEAR_BWD_CROSSOVER_N or past else "jnp_residual"


def fused_masked_linear_attention(q_prime: torch.Tensor, k_prime: torch.Tensor,
                                  v: torch.Tensor, t: torch.Tensor,
                                  bwd_mode: str = "auto") -> torch.Tensor:
    """Differentiable Toeplitz-masked linear attention over a materialised
    T: out_i = sum_j T[i,j] (q'_i.k'_j) v_j / (sum_j T[i,j] (q'_i.k'_j) + eps).

    Args:
        q_prime, k_prime: [B, H, N, F]; v: [B, H, N, D]; t: [H, N, N].
        bwd_mode: 'pallas' runs the backward kernels (dT only when T needs
            a gradient); 'jnp_residual' the residual formula in PyTorch
            (`masked_linear_vjp_residual`, on any device); 'auto' the
            choice of `masked_linear_bwd_mode`. The JAX package takes this
            choice from its module global `MASKED_LINEAR_BWD_MODE`.
    Returns:
        [B, H, N, D] in v's dtype.
    """
    if bwd_mode not in BWD_MODES:
        raise ValueError(f"bwd_mode must be one of {BWD_MODES}, got {bwd_mode!r}")
    if bwd_mode == "auto":
        bwd_mode = masked_linear_bwd_mode(*q_prime.shape[:3])
    return _FusedMaskedLinear.apply(q_prime, k_prime, v, t, bwd_mode)
