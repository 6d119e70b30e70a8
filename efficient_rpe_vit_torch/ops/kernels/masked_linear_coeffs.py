"""Coeffs-native Toeplitz-masked linear attention (KERPLE), forward and
backward, and its forward with the feature map fused in.

    out_i = sum_j c[j-i+N-1] (q'_i.k'_j) v_j / (den_i + eps),
    den_i = sum_j c[j-i+N-1] (q'_i.k'_j)

Counterpart of `efficient_rpe_vit_tpu/ops/pallas/masked_linear_coeffs.py`:
the forward `_fwd_kernel` is hand-written CUDA C++ for sm_90a in
`csrc/masked_linear_coeffs_fwd.cu`; the backward `_bwd_impl` (`_dq_kernel`,
`_dkv_kernel`, `_dc_kernel` and the `_scatter_windows` epilogue) is four
kernels in `csrc/masked_linear_coeffs_bwd.cu` (the bf16 forward, dq, dkv
and dc kernels are register-resident on mma.sync, dc with a batch-sum
kernel behind it); the fused-phi forward `_fused_phi_fwd_kernel` (q' =
phi(q), k' = phi(k) computed per tile from the raw q, k and Omega) is
`csrc/kerple_fused_phi_fwd.cu`, in bf16 register-resident on the unfused
forward's stage. `launch_info` reports what a launch runs. Each builds its
Toeplitz tiles from a window of the coefficient vector, so no [H, N, N]
tensor exists on the kernel path.

Every kernel has a wrapper that checks its inputs, takes the plain version
for CPU tensors and launches the kernel for CUDA tensors (never falling
back), and counts its launches in `<wrapper>.launches`. The plain versions
(`*_reference`) sit beside them. The two forward wrappers call custom ops
of the same names in the `efficient_rpe_vit` namespace (`_library.py`),
whose CPU, CUDA and fake implementations are the plain version, the
launch and a shape-only one, so `torch.export` keeps each as one node of
an exported graph. `masked_linear_attention_coeffs` and
`kerple_attention_fused_phi` are the differentiable ops:
`torch.autograd.Function`s over the forward wrappers whose backward is
`masked_linear_attention_coeffs_bwd` (for the fused op, after phi is
recomputed outside the kernel, and followed by phi's VJP).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..feature_maps import phi_positive, phi_relu
from ..fft_toeplitz import toeplitz_diag_sums, toeplitz_from_coeffs
from ._build import LAUNCH_INFO_KEYS  # noqa: F401 (re-exported: what launch_info reports)
from ._build import dtype_suffix, launch, launch_info_buffer, launch_info_dict, load, on_cpu
from ._library import define

EPS = 1e-6  # denominator stabiliser, as in the JAX package

_SOURCE = "masked_linear_coeffs_fwd"
_BWD_SOURCE = "masked_linear_coeffs_bwd"
_FUSED_SOURCE = "kerple_fused_phi_fwd"
_DTYPES = (torch.bfloat16, torch.float32)
# feature maps the fused-phi kernel computes
FUSED_FEATURE_KINDS = ("favor_plus", "relu")
# rows per q / kv tile of the dc kernel (64 for bf16; 32 for fp32 so that
# the F = 266 dkv block fits in shared memory), whose windows are
# [H, n_t, n_t, 2 * tile - 1] with n_t = ceil(N / tile); dq and dkv use the
# same tile wherever it fits and a smaller one at large F
BWD_TILE: Dict[torch.dtype, int] = {torch.bfloat16: 64, torch.float32: 32}


# ─── plain versions ─────────────────────────────────────────────────────

def kerple_dense_forward(q_prime: torch.Tensor, k_prime: torch.Tensor,
                         v: torch.Tensor, t: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward from a materialised Toeplitz matrix t [H, N, N], with the
    kernel's precision rule: scores and weights in fp32, weights rounded to
    v's dtype for the value product (fp32 accumulation), den in fp32.

    Returns:
        (out [B, H, N, D] in v's dtype, den [B, H, N] fp32).
    """
    w = torch.einsum("bhif,bhjf->bhij", q_prime.float(), k_prime.float()) * t
    num = torch.einsum("bhij,bhjd->bhid", w.to(v.dtype).float(), v.float())
    den = w.sum(dim=-1)
    return (num / (den[..., None] + EPS)).to(v.dtype), den


def masked_linear_attention_coeffs_reference(
        q_prime: torch.Tensor, k_prime: torch.Tensor, v: torch.Tensor,
        coeffs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel.

    Returns:
        (out [B, H, N, D] in v's dtype, den [B, H, N] fp32).
    """
    t = toeplitz_from_coeffs(coeffs.float(), q_prime.shape[2])  # [H, N, N]
    return kerple_dense_forward(q_prime, k_prime, v, t)


def kerple_bwd_residuals(den: torch.Tensor, out: torch.Tensor,
                         g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """gn = g / (den + eps) rounded to g's dtype, and s = sum(g * out) / (den
    + eps) with the product and its sum in g's dtype, divided in fp32 (the
    JAX `_bwd_impl` rule: gn at the cotangent dtype keeps every gn product
    in that dtype; s stays fp32, it is only used elementwise)."""
    gn = (g.float() / (den[..., None] + EPS)).to(g.dtype)
    s = (g * out).sum(dim=-1) / (den + EPS)
    return gn, s


def masked_linear_vjp_residual(q_prime, k_prime, v, t, den, out, g):
    """VJP of Toeplitz-masked linear attention from the saved (den, out)
    residuals, without recomputing the forward:

        dW = gn v^T - s, dA = dW*T, dT = sum_b dW*A,
        dq' = dA k', dk' = dA^T q', dv = (A*T)^T gn.

    Counterpart of `efficient_rpe_vit_tpu/ops/attention_core.py::
    masked_linear_vjp_residual`, with its precision rule: every product
    operand in the input dtype (dA and A*T rounded to it), fp32
    accumulation, dT in fp32.

    Returns:
        (dq' [B,H,N,F], dk' [B,H,N,F], dv [B,H,N,D] in the input dtypes,
        dT [H,N,N] in t's dtype).
    """
    gn, s = kerple_bwd_residuals(den, out, g)
    a = torch.einsum("bhif,bhjf->bhij", q_prime.float(), k_prime.float())
    dw = torch.einsum("bhid,bhjd->bhij", gn.float(), v.float()) - s[..., None]
    da = (dw * t).to(q_prime.dtype).float()
    dt = (dw * a).sum(dim=0)
    dq = torch.einsum("bhij,bhjf->bhif", da, k_prime.float()).to(q_prime.dtype)
    dk = torch.einsum("bhij,bhif->bhjf", da, q_prime.float()).to(k_prime.dtype)
    dv = torch.einsum("bhij,bhid->bhjd", (a * t).to(gn.dtype).float(),
                      gn.float()).to(v.dtype)
    return dq, dk, dv, dt.to(t.dtype)


def masked_linear_attention_coeffs_bwd_reference(
        q_prime, k_prime, v, coeffs, den, out, g):
    """Plain version of the backward: the residual VJP, then dcoeffs as the
    diagonal sums of dT.

    Returns:
        (dq' , dk', dv in the input dtypes, dcoeffs [H, 2N-1] fp32).
    """
    t = toeplitz_from_coeffs(coeffs.float(), q_prime.shape[2])
    dq, dk, dv, dt = masked_linear_vjp_residual(q_prime, k_prime, v, t, den,
                                                out, g)
    return dq, dk, dv, toeplitz_diag_sums(dt)


def _dw(gn, s, v):
    """dW = gn v^T - s, fp32 [B, H, N, N]."""
    return torch.einsum("bhid,bhjd->bhij", gn.float(), v.float()) - s[..., None]


def kerple_dense_bwd_dq(gn, s, v, k_prime, t):
    """dq' = round(dW*T) k' from a materialised T [H, N, N] (fp32)."""
    da = (_dw(gn, s, v) * t).to(k_prime.dtype).float()
    return torch.einsum("bhij,bhjf->bhif", da, k_prime.float()).to(k_prime.dtype)


def kerple_dense_bwd_dkv(gn, s, v, q_prime, k_prime, t):
    """dk' = round(dW*T)^T q', dv = round(A*T)^T gn from a materialised T."""
    da = (_dw(gn, s, v) * t).to(q_prime.dtype).float()
    dk = torch.einsum("bhij,bhif->bhjf", da, q_prime.float()).to(k_prime.dtype)
    a = torch.einsum("bhif,bhjf->bhij", q_prime.float(), k_prime.float())
    dv = torch.einsum("bhij,bhid->bhjd", (a * t).to(gn.dtype).float(),
                      gn.float()).to(v.dtype)
    return dk, dv


def kerple_dense_bwd_dt(gn, s, v, q_prime, k_prime):
    """dT = sum_b dW*A, [H, N, N] fp32 (not multiplied by T)."""
    a = torch.einsum("bhif,bhjf->bhij", q_prime.float(), k_prime.float())
    return (_dw(gn, s, v) * a).sum(dim=0)


def masked_linear_attention_coeffs_bwd_dq_reference(gn, s, v, k_prime, coeffs):
    """Plain version of the dq kernel: dq' = round(dW*T) k'."""
    return kerple_dense_bwd_dq(gn, s, v, k_prime,
                               toeplitz_from_coeffs(coeffs.float(), k_prime.shape[2]))


def masked_linear_attention_coeffs_bwd_dkv_reference(gn, s, v, q_prime,
                                                     k_prime, coeffs):
    """Plain version of the dkv kernel: dk' = round(dW*T)^T q',
    dv = round(A*T)^T gn."""
    return kerple_dense_bwd_dkv(gn, s, v, q_prime, k_prime,
                                toeplitz_from_coeffs(coeffs.float(), k_prime.shape[2]))


def masked_linear_attention_coeffs_bwd_dc_reference(gn, s, v, q_prime, k_prime):
    """Plain version of the dc kernel: the diagonal sums of every
    [tile, tile] block of dT = sum_b dW*A, [H, n_t, n_t, 2*tile-1] fp32 with
    window index m = b - a + tile - 1."""
    tile = BWD_TILE[q_prime.dtype]
    dt = kerple_dense_bwd_dt(gn, s, v, q_prime, k_prime)  # [H, N, N]
    H, n = dt.shape[0], dt.shape[-1]
    n_t = -(-n // tile)
    pad = n_t * tile - n
    blocks = F.pad(dt, (0, pad, 0, pad)).reshape(H, n_t, tile, n_t, tile)
    return toeplitz_diag_sums(blocks.transpose(2, 3))


def masked_linear_attention_coeffs_bwd_dc_reduce_reference(windows, n: int):
    """Plain version of the reduce kernel: add every tile pair's window into
    dcoeffs [H, 2n-1] at offset base = (jk - iq) * tile + n - tile."""
    H, n_t, _, win = windows.shape
    tile = (win + 1) // 2
    buf = windows.new_zeros(H, (2 * n_t - 2) * tile + win)
    for iq in range(n_t):
        for jk in range(n_t):
            o = (jk - iq + n_t - 1) * tile
            buf[:, o:o + win] += windows[:, iq, jk]
    start = n_t * tile - n
    return buf[:, start:start + 2 * n - 1]


def fused_phi_reference(x: torch.Tensor, omega: torch.Tensor,
                        feature_kind: str) -> torch.Tensor:
    """phi(x) [B, H, N, F] in x's dtype by the fused kernel's rules (the JAX
    `_phi_tile`), which differ from `phi_positive` / `phi_relu`: Omega is
    rounded to x's dtype before u = x Omega (fp32 accumulation), ||x||^2/2
    comes from fp32 x, the row max runs over the F real lanes, the scale is
    1/sqrt(F), and phi is rounded to x's dtype."""
    F_ = omega.shape[-1]
    u = torch.matmul(x.float(), omega.to(x.dtype).float())
    if feature_kind == "relu":
        phi = torch.relu(u) * (1.0 / F_ ** 0.5)
    else:
        x32 = x.float()
        norm_half = (x32 * x32).sum(dim=-1, keepdim=True) * 0.5
        phi = torch.exp(u - u.amax(dim=-1, keepdim=True) - norm_half) * (1.0 / F_ ** 0.5)
    return phi.to(x.dtype)


def kerple_attention_fused_phi_fwd_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, omega: torch.Tensor,
        coeffs: torch.Tensor, feature_kind: str = "favor_plus"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused-phi forward kernel: `fused_phi_reference`
    of q and k, then the unfused forward's rules (S = q'k'^T in fp32, W =
    S*T, W rounded to v's dtype for the value product, den in fp32).

    Returns:
        (out [B, H, N, Dv] in v's dtype, den [B, H, N] fp32).
    """
    return masked_linear_attention_coeffs_reference(
        fused_phi_reference(q, omega, feature_kind),
        fused_phi_reference(k, omega, feature_kind), v, coeffs)


# ─── input checks and launches ──────────────────────────────────────────

def _check_inputs(q_prime, k_prime, v, coeffs=None) -> None:
    """Inputs of the forward: q' and k' [B, H, N, F] and v [B, H, N, D] in
    one dtype and, when given, coeffs [H, 2N-1] in fp32, all contiguous and
    on one device."""
    tensors = {"q_prime": q_prime, "k_prime": k_prime, "v": v,
               **({} if coeffs is None else {"coeffs": coeffs})}
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    if q_prime.dim() != 4 or v.dim() != 4:
        raise ValueError("q_prime, k_prime and v must be [B, H, N, *]")
    B, H, N, _ = q_prime.shape
    if k_prime.shape != q_prime.shape:
        raise ValueError(f"k_prime {tuple(k_prime.shape)} != q_prime "
                         f"{tuple(q_prime.shape)}")
    if v.shape[:3] != (B, H, N):
        raise ValueError(f"v {tuple(v.shape)} does not match q_prime "
                         f"{tuple(q_prime.shape)} in [B, H, N]")
    if coeffs is not None and coeffs.shape != (H, 2 * N - 1):
        raise ValueError(f"coeffs must be [H, 2N-1] = [{H}, {2 * N - 1}], "
                         f"got {tuple(coeffs.shape)}")
    if not (q_prime.dtype == k_prime.dtype == v.dtype):
        raise TypeError(f"q_prime, k_prime and v must share a dtype, got "
                        f"{q_prime.dtype}, {k_prime.dtype}, {v.dtype}")
    if q_prime.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q_prime.dtype}: bfloat16 or "
                        "float32")
    if coeffs is not None and coeffs.dtype != torch.float32:
        raise TypeError(f"coeffs must be float32, got {coeffs.dtype}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_bwd_inputs(gn, s, v, k_prime, q_prime=None, coeffs=None) -> None:
    """Inputs of the backward kernels: gn and v [B, H, N, D], q' and k'
    [B, H, N, F] in one dtype, s [B, H, N] and coeffs [H, 2N-1] in fp32, all
    contiguous and on one device."""
    if v.dim() != 4:
        raise ValueError("v must be [B, H, N, D]")
    B, H, N, _ = v.shape
    feats = {"k_prime": k_prime, **({} if q_prime is None else {"q_prime": q_prime})}
    tensors = {"gn": gn, "s": s, "v": v, **feats,
               **({} if coeffs is None else {"coeffs": coeffs})}
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    if gn.shape != v.shape:
        raise ValueError(f"gn {tuple(gn.shape)} != v {tuple(v.shape)}")
    if s.shape != (B, H, N):
        raise ValueError(f"s must be [B, H, N] = {(B, H, N)}, got {tuple(s.shape)}")
    for name, t in feats.items():
        if t.dim() != 4 or t.shape[:3] != (B, H, N) or t.shape != k_prime.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match v "
                             f"{tuple(v.shape)} in [B, H, N]")
    if coeffs is not None and coeffs.shape != (H, 2 * N - 1):
        raise ValueError(f"coeffs must be [H, 2N-1] = [{H}, {2 * N - 1}], "
                         f"got {tuple(coeffs.shape)}")
    if len({gn.dtype, v.dtype, *(t.dtype for t in feats.values())}) != 1:
        raise TypeError("gn, v, q_prime and k_prime must share a dtype")
    if v.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {v.dtype}: bfloat16 or float32")
    for name, t in (("s", s), ("coeffs", coeffs)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_fused_inputs(q, k, v, omega, coeffs, feature_kind) -> None:
    """Inputs of the fused-phi forward: q, k [B, H, N, D] and v [B, H, N, Dv]
    in one dtype, omega [H, D, F] and coeffs [H, 2N-1] in fp32, all
    contiguous and on one device."""
    if feature_kind not in FUSED_FEATURE_KINDS:
        raise ValueError(f"feature_kind must be one of {FUSED_FEATURE_KINDS}, "
                         f"got {feature_kind!r}")
    tensors = {"q": q, "k": k, "v": v, "omega": omega, "coeffs": coeffs}
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    if q.dim() != 4 or v.dim() != 4 or omega.dim() != 3:
        raise ValueError("q, k and v must be [B, H, N, *], omega [H, D, F]")
    B, H, N, D = q.shape
    if k.shape != q.shape:
        raise ValueError(f"k {tuple(k.shape)} != q {tuple(q.shape)}")
    if v.shape[:3] != (B, H, N):
        raise ValueError(f"v {tuple(v.shape)} does not match q {tuple(q.shape)} "
                         "in [B, H, N]")
    if omega.shape[:2] != (H, D):
        raise ValueError(f"omega must be [H, D, F] with [H, D] = [{H}, {D}], "
                         f"got {tuple(omega.shape)}")
    if coeffs.shape != (H, 2 * N - 1):
        raise ValueError(f"coeffs must be [H, 2N-1] = [{H}, {2 * N - 1}], "
                         f"got {tuple(coeffs.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}: bfloat16 or float32")
    for name, t in (("omega", omega), ("coeffs", coeffs)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _kernel_fns():
    lib = load(_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.mlc_fwd_bf16, lib.mlc_fwd_f32):
        fn.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        fn.restype = i32
    lib.mlc_fwd_launch_info.argtypes = [i32] * 4 + [ptr]
    lib.mlc_fwd_launch_info.restype = i32
    lib.mlc_error_string.argtypes = [i32]
    lib.mlc_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_kernel_fns():
    lib = load(_BWD_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for suffix in ("bf16", "f32"):
        getattr(lib, f"mlc_bwd_dq_{suffix}").argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        getattr(lib, f"mlc_bwd_dkv_{suffix}").argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        getattr(lib, f"mlc_bwd_dc_{suffix}").argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
        for kind in ("dq", "dkv", "dc"):
            getattr(lib, f"mlc_bwd_{kind}_{suffix}").restype = i32
    lib.mlc_bwd_dc_reduce.argtypes = [ptr, ptr, i32, i32, i32, ptr]
    lib.mlc_bwd_dc_reduce.restype = i32
    lib.mlc_bwd_dc_scratch_floats.argtypes = [i32] * 6
    lib.mlc_bwd_dc_scratch_floats.restype = ctypes.c_longlong
    lib.mlc_bwd_tile.argtypes = [i32]
    lib.mlc_bwd_tile.restype = i32
    lib.mlc_bwd_launch_info.argtypes = [i32] * 5 + [ptr]
    lib.mlc_bwd_launch_info.restype = i32
    lib.mlc_bwd_error_string.argtypes = [i32]
    lib.mlc_bwd_error_string.restype = ctypes.c_char_p
    for dtype, tile in BWD_TILE.items():
        built = lib.mlc_bwd_tile(int(dtype == torch.bfloat16))
        if built != tile:
            raise RuntimeError(f"{_BWD_SOURCE}.cu tiles {dtype} by {built} "
                               f"rows, the wrapper expects {tile}")
    return lib


_BWD_KINDS = {"masked_linear_coeffs_bwd_dq": 0, "masked_linear_coeffs_bwd_dkv": 1,
              "masked_linear_coeffs_bwd_dc": 2}


def launch_info(kernel: str, n: int, f: int, d: int, dtype: torch.dtype) -> dict:
    """What a launch of the forward ("masked_linear_coeffs_fwd"), of the
    backward kernel `kernel` ("masked_linear_coeffs_bwd_dq", "..._dkv" or
    "..._dc") or of the fused-phi forward ("kerple_fused_phi_fwd"; d is then
    the head dim of q, k and v) at sequence length n, feature count f and
    value dim d runs on this card, asked of the built library:
    rows per block or tile, threads, dynamic shared memory bytes, resident
    blocks per SM, registers and local (spilled) bytes per thread under
    `LAUNCH_INFO_KEYS`, and under "kernel" which kernel runs ("mma.sync",
    the register-resident forward, dq, dkv, dc or fused-phi kernel, or
    "staged"). Needs a GPU."""
    if kernel not in (_SOURCE, _FUSED_SOURCE) and kernel not in _BWD_KINDS:
        raise ValueError(f"unknown KERPLE kernel {kernel!r}")
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype}: bfloat16 or float32")
    if n <= 0 or f <= 0 or d <= 0:
        raise ValueError(f"need n, f, d > 0, got n={n}, f={f}, d={d}")
    info = launch_info_buffer()
    is_bf16 = int(dtype == torch.bfloat16)
    if kernel == _SOURCE:
        lib = _kernel_fns()
        err, errors = lib.mlc_fwd_launch_info(n, f, d, is_bf16, info), lib.mlc_error_string
    elif kernel == _FUSED_SOURCE:
        lib = _fused_kernel_fns()
        err, errors = lib.kfp_fwd_launch_info(n, f, d, is_bf16, info), lib.kfp_error_string
    else:
        lib = _bwd_kernel_fns()
        err = lib.mlc_bwd_launch_info(_BWD_KINDS[kernel], n, f, d, is_bf16, info)
        errors = lib.mlc_bwd_error_string
    if err != 0:
        raise RuntimeError(f"{kernel} launch info at n={n} f={f} d={d}: CUDA error "
                           f"{err} ({errors(err).decode()})")
    return launch_info_dict(info)


@functools.cache
def _fused_kernel_fns():
    lib = load(_FUSED_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.kfp_fwd_bf16, lib.kfp_fwd_f32):
        fn.argtypes = [ptr] * 7 + [i32] * 7 + [ctypes.c_float, ptr]
        fn.restype = i32
    lib.kfp_fwd_launch_info.argtypes = [i32] * 4 + [ptr]
    lib.kfp_fwd_launch_info.restype = i32
    lib.kfp_error_string.argtypes = [i32]
    lib.kfp_error_string.restype = ctypes.c_char_p
    return lib


# ─── forward ────────────────────────────────────────────────────────────

def _fwd_cuda(q_prime, k_prime, v, coeffs):
    _check_inputs(q_prime, k_prime, v, coeffs)
    B, H, N, F_ = q_prime.shape
    D = v.shape[-1]
    lib = _kernel_fns()
    out = torch.empty_like(v)
    den = torch.empty((B, H, N), dtype=torch.float32, device=v.device)
    launch(lib.mlc_error_string, "masked_linear_coeffs_fwd",
           getattr(lib, f"mlc_fwd_{dtype_suffix(v.dtype)}"), v.device,
           q_prime, k_prime, v, coeffs, out, den, B, H, N, F_, D)
    masked_linear_attention_coeffs_fwd.launches += 1
    return out, den


def _fwd_cpu(q_prime, k_prime, v, coeffs):
    _check_inputs(q_prime, k_prime, v, coeffs)
    return masked_linear_attention_coeffs_reference(q_prime, k_prime, v, coeffs)


def _fwd_fake(q_prime, k_prime, v, coeffs):
    _check_inputs(q_prime, k_prime, v, coeffs)
    on_cpu(q_prime)  # meta tensors land here: refused like any other device
    return torch.empty_like(v), v.new_empty(v.shape[:3], dtype=torch.float32)


_fwd_op = define("masked_linear_attention_coeffs_fwd",
                 "(Tensor q_prime, Tensor k_prime, Tensor v, Tensor coeffs)"
                 " -> (Tensor, Tensor)", _fwd_cpu, _fwd_cuda, _fwd_fake)


def masked_linear_attention_coeffs_fwd(
        q_prime: torch.Tensor, k_prime: torch.Tensor, v: torch.Tensor,
        coeffs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """KERPLE attention forward straight from the coefficient vector: the
    custom op `efficient_rpe_vit::masked_linear_attention_coeffs_fwd`.

    Args:
        q_prime, k_prime: [B, H, N, F] non-negative features.
        v: [B, H, N, D].
        coeffs: [H, 2N-1] fp32 positive Toeplitz coefficients.
        q_prime, k_prime and v share a dtype (bfloat16 or float32); all
        four are contiguous and on one device. On the GPU the kernel also
        needs D <= 128 and an F whose tiles fit in shared memory (at
        D=64, F up to ~740 in bf16 and ~840 in fp32, which takes 32-row
        tiles above F ~380); the launch is refused otherwise.
    Returns:
        (out [B, H, N, D] in v's dtype, den [B, H, N] fp32).
    Raises:
        ValueError / TypeError on malformed inputs, RuntimeError when the
        kernel launch is refused.
    """
    return _fwd_op(q_prime, k_prime, v, coeffs)


masked_linear_attention_coeffs_fwd.launches = 0


def _fused_fwd_cuda(q, k, v, omega, coeffs, feature_kind):
    _check_fused_inputs(q, k, v, omega, coeffs, feature_kind)
    B, H, N, D = q.shape
    F_ = omega.shape[-1]
    lib = _fused_kernel_fns()
    out = torch.empty_like(v)
    den = torch.empty((B, H, N), dtype=torch.float32, device=v.device)
    launch(lib.kfp_error_string, "kerple_fused_phi_fwd",
           getattr(lib, f"kfp_fwd_{dtype_suffix(v.dtype)}"), v.device,
           q, k, v, omega, coeffs, out, den, B, H, N, D, v.shape[-1], F_,
           int(feature_kind == "relu"), 1.0 / F_ ** 0.5)
    kerple_attention_fused_phi_fwd.launches += 1
    return out, den


def _fused_fwd_cpu(q, k, v, omega, coeffs, feature_kind):
    _check_fused_inputs(q, k, v, omega, coeffs, feature_kind)
    return kerple_attention_fused_phi_fwd_reference(q, k, v, omega, coeffs,
                                                    feature_kind)


def _fused_fwd_fake(q, k, v, omega, coeffs, feature_kind):
    _check_fused_inputs(q, k, v, omega, coeffs, feature_kind)
    on_cpu(q)  # meta tensors land here: refused like any other device
    return torch.empty_like(v), v.new_empty(v.shape[:3], dtype=torch.float32)


_fused_fwd_op = define("kerple_attention_fused_phi_fwd",
                       "(Tensor q, Tensor k, Tensor v, Tensor omega, Tensor coeffs,"
                       " str feature_kind) -> (Tensor, Tensor)",
                       _fused_fwd_cpu, _fused_fwd_cuda, _fused_fwd_fake)


def kerple_attention_fused_phi_fwd(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, omega: torch.Tensor,
        coeffs: torch.Tensor, feature_kind: str = "favor_plus"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KERPLE attention forward from the raw q and k: phi (FAVOR+ or ReLU
    features, `fused_phi_reference`'s rules) is computed per tile inside the
    kernel and never stored. Replaces `_fused_phi_fwd_kernel`; the custom op
    `efficient_rpe_vit::kerple_attention_fused_phi_fwd`.

    Args:
        q, k: [B, H, N, D], L2-normalised (the KERPLE contract).
        v: [B, H, N, Dv]; q, k and v share a dtype (bfloat16 or float32).
        omega: [H, D, F] fp32 random features.
        coeffs: [H, 2N-1] fp32 positive Toeplitz coefficients.
        feature_kind: 'favor_plus' or 'relu'.
        All contiguous and on one device. On the GPU the kernel needs its
        tiles, Omega included, to fit in shared memory (at F=266, D and Dv
        up to 64); the launch is refused otherwise.
    Returns:
        (out [B, H, N, Dv] in v's dtype, den [B, H, N] fp32).
    Raises:
        ValueError / TypeError on malformed inputs, RuntimeError when the
        kernel launch is refused.
    """
    return _fused_fwd_op(q, k, v, omega, coeffs, feature_kind)


kerple_attention_fused_phi_fwd.launches = 0


# ─── backward kernels ───────────────────────────────────────────────────

def masked_linear_attention_coeffs_bwd_dq(gn, s, v, k_prime, coeffs):
    """dq' = round(dW*T) k' ([B, H, N, F] in k's dtype) from gn, s
    (`kerple_bwd_residuals`), v, k' and coeffs. Replaces `_dq_kernel`."""
    _check_bwd_inputs(gn, s, v, k_prime, coeffs=coeffs)
    if on_cpu(v):
        return masked_linear_attention_coeffs_bwd_dq_reference(
            gn, s, v, k_prime, coeffs)
    B, H, N, F_ = k_prime.shape
    lib = _bwd_kernel_fns()
    dq = torch.empty_like(k_prime)
    launch(lib.mlc_bwd_error_string, "masked_linear_coeffs_bwd_dq",
           getattr(lib, f"mlc_bwd_dq_{dtype_suffix(v.dtype)}"), v.device,
           gn, s, v, k_prime, coeffs, dq, B, H, N, F_, v.shape[-1])
    masked_linear_attention_coeffs_bwd_dq.launches += 1
    return dq


def masked_linear_attention_coeffs_bwd_dkv(gn, s, v, q_prime, k_prime, coeffs):
    """(dk' = round(dW*T)^T q', dv = round(A*T)^T gn) in the input dtype.
    Replaces `_dkv_kernel`."""
    _check_bwd_inputs(gn, s, v, k_prime, q_prime, coeffs)
    if on_cpu(v):
        return masked_linear_attention_coeffs_bwd_dkv_reference(
            gn, s, v, q_prime, k_prime, coeffs)
    B, H, N, F_ = k_prime.shape
    lib = _bwd_kernel_fns()
    dk = torch.empty_like(k_prime)
    dv = torch.empty_like(v)
    launch(lib.mlc_bwd_error_string, "masked_linear_coeffs_bwd_dkv",
           getattr(lib, f"mlc_bwd_dkv_{dtype_suffix(v.dtype)}"), v.device,
           gn, s, v, q_prime, k_prime, coeffs, dk, dv, B, H, N, F_, v.shape[-1])
    masked_linear_attention_coeffs_bwd_dkv.launches += 1
    return dk, dv


def masked_linear_attention_coeffs_bwd_dc(gn, s, v, q_prime, k_prime):
    """Per tile pair, the diagonal sums of sum_b dW*A: windows
    [H, n_t, n_t, 2*tile-1] fp32 (tile = BWD_TILE[dtype]). Replaces
    `_dc_kernel`. The bf16 kernel at even F <= 272, D <= 64 folds each batch
    element's tile pairs into a scratch [B, H, n_t, n_t, 2*tile-1] fp32,
    allocated here, which a second kernel sums over the batch in order."""
    _check_bwd_inputs(gn, s, v, k_prime, q_prime)
    if on_cpu(v):
        return masked_linear_attention_coeffs_bwd_dc_reference(
            gn, s, v, q_prime, k_prime)
    B, H, N, F_ = k_prime.shape
    D = v.shape[-1]
    tile = BWD_TILE[v.dtype]
    n_t = -(-N // tile)
    lib = _bwd_kernel_fns()
    windows = torch.empty((H, n_t, n_t, 2 * tile - 1), dtype=torch.float32,
                          device=v.device)
    floats = lib.mlc_bwd_dc_scratch_floats(B, H, N, F_, D,
                                           int(v.dtype == torch.bfloat16))
    scratch = torch.empty(floats, dtype=torch.float32, device=v.device) \
        if floats > 0 else None
    launch(lib.mlc_bwd_error_string, "masked_linear_coeffs_bwd_dc",
           getattr(lib, f"mlc_bwd_dc_{dtype_suffix(v.dtype)}"), v.device,
           gn, s, v, q_prime, k_prime, windows, scratch, B, H, N, F_, D)
    masked_linear_attention_coeffs_bwd_dc.launches += 1
    return windows


def masked_linear_attention_coeffs_bwd_dc_reduce(windows: torch.Tensor,
                                                 n: int) -> torch.Tensor:
    """Windows [H, n_t, n_t, 2*tile-1] -> dcoeffs [H, 2n-1] fp32, summed in
    a fixed order (no atomics). Replaces `_scatter_windows`."""
    if windows.dim() != 4 or windows.shape[1] != windows.shape[2] \
            or windows.shape[3] % 2 != 1:
        raise ValueError(f"windows must be [H, n_t, n_t, 2*tile-1], got "
                         f"{tuple(windows.shape)}")
    H, n_t, _, win = windows.shape
    tile = (win + 1) // 2
    if n_t != -(-n // tile):
        raise ValueError(f"{n_t} tiles of {tile} rows do not cover n={n}")
    if windows.dtype != torch.float32 or not windows.is_contiguous():
        raise ValueError("windows must be contiguous float32")
    if on_cpu(windows):
        return masked_linear_attention_coeffs_bwd_dc_reduce_reference(windows, n)
    lib = _bwd_kernel_fns()
    dcoeffs = torch.empty((H, 2 * n - 1), dtype=torch.float32,
                          device=windows.device)
    launch(lib.mlc_bwd_error_string, "masked_linear_coeffs_bwd_dc_reduce",
           lib.mlc_bwd_dc_reduce, windows.device, windows, dcoeffs, H, n, tile)
    masked_linear_attention_coeffs_bwd_dc_reduce.launches += 1
    return dcoeffs


for _fn in (masked_linear_attention_coeffs_bwd_dq,
            masked_linear_attention_coeffs_bwd_dkv,
            masked_linear_attention_coeffs_bwd_dc,
            masked_linear_attention_coeffs_bwd_dc_reduce):
    _fn.launches = 0
del _fn


def masked_linear_attention_coeffs_bwd(q_prime, k_prime, v, coeffs, den, out, g):
    """Backward of the KERPLE forward from its saved (den, out).

    Args:
        q_prime, k_prime, v, coeffs: the forward's inputs.
        den [B, H, N] fp32, out [B, H, N, D]: the forward's outputs.
        g: [B, H, N, D] cotangent of out, in v's dtype, contiguous.
    Returns:
        (dq', dk', dv in the input dtypes, dcoeffs [H, 2N-1] fp32).
        CPU tensors take the plain version; CUDA tensors launch the dq, dkv,
        dc and reduce kernels.
    """
    _check_inputs(q_prime, k_prime, v, coeffs)
    for name, t in (("out", out), ("g", g)):
        if t.shape != v.shape or t.dtype != v.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {v.dtype} tensor "
                             f"of v's shape {tuple(v.shape)}")
    if den.shape != v.shape[:3] or den.dtype != torch.float32:
        raise ValueError("den must be [B, H, N] float32")
    if on_cpu(v):
        return masked_linear_attention_coeffs_bwd_reference(
            q_prime, k_prime, v, coeffs, den, out, g)
    gn, s = kerple_bwd_residuals(den, out, g)
    dq = masked_linear_attention_coeffs_bwd_dq(gn, s, v, k_prime, coeffs)
    dk, dv = masked_linear_attention_coeffs_bwd_dkv(gn, s, v, q_prime,
                                                    k_prime, coeffs)
    windows = masked_linear_attention_coeffs_bwd_dc(gn, s, v, q_prime, k_prime)
    dcoeffs = masked_linear_attention_coeffs_bwd_dc_reduce(windows, v.shape[2])
    return dq, dk, dv, dcoeffs


# ─── the differentiable op ──────────────────────────────────────────────

class _MaskedLinearCoeffs(torch.autograd.Function):
    """Forward kernel; backward kernels from the saved (den, out)."""

    @staticmethod
    def forward(ctx, q_prime, k_prime, v, coeffs):
        out, den = _fwd_op(q_prime, k_prime, v, coeffs)
        ctx.save_for_backward(q_prime, k_prime, v, coeffs, den, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # the cotangent arrives through the head merge's transpose
        return masked_linear_attention_coeffs_bwd(*ctx.saved_tensors,
                                                  g.contiguous())


def masked_linear_attention_coeffs(q_prime: torch.Tensor,
                                   k_prime: torch.Tensor, v: torch.Tensor,
                                   coeffs: torch.Tensor) -> torch.Tensor:
    """Differentiable KERPLE attention, [B, H, N, D] in v's dtype; its
    backward is `masked_linear_attention_coeffs_bwd`.

    Without autograd (inference mode, no_grad, or no input that needs a
    gradient) autograd records no node and drops what the forward saved, so
    this is one forward launch and keeps nothing.
    """
    return _MaskedLinearCoeffs.apply(q_prime, k_prime, v, coeffs)


class _KerpleFusedPhi(torch.autograd.Function):
    """Fused-phi forward kernel; backward as the JAX `_kafp_bwd`: phi of q
    and k recomputed with the unfused feature maps, the backward kernels
    from the forward's (den, out), then phi's VJP to q, k and Omega."""

    @staticmethod
    def forward(ctx, q, k, v, omega, coeffs, feature_kind):
        out, den = _fused_fwd_op(q, k, v, omega, coeffs, feature_kind)
        ctx.feature_kind = feature_kind
        ctx.save_for_backward(q, k, v, omega, coeffs, den, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, omega, coeffs, den, out = ctx.saved_tensors
        phi = phi_relu if ctx.feature_kind == "relu" else phi_positive
        need_q, need_k, _, need_om = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            qd = q.detach().requires_grad_(need_q)
            kd = k.detach().requires_grad_(need_k)
            om = omega.detach().requires_grad_(need_om)
            q_prime, k_prime = phi(qd, om), phi(kd, om)
        # the cotangent arrives through the head merge's transpose
        dqp, dkp, dv, dcoeffs = masked_linear_attention_coeffs_bwd(
            q_prime.detach(), k_prime.detach(), v, coeffs, den, out, g.contiguous())
        leaves = [t for t, need in ((qd, need_q), (kd, need_k), (om, need_om)) if need]
        pulled = iter(())
        if leaves:
            outs = [(t, d) for t, d in ((q_prime, dqp), (k_prime, dkp)) if t.requires_grad]
            pulled = iter(torch.autograd.grad([t for t, _ in outs], leaves,
                                              [d for _, d in outs], allow_unused=True))
        dq, dk, dom = (next(pulled) if need else None for need in (need_q, need_k, need_om))
        return dq, dk, dv, dom, dcoeffs, None


def kerple_attention_fused_phi(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, omega: torch.Tensor,
                               coeffs: torch.Tensor,
                               feature_kind: str = "favor_plus") -> torch.Tensor:
    """Differentiable KERPLE attention with phi fused into the forward
    kernel (`kerple_attention_fused_phi_fwd`), [B, H, N, Dv] in v's dtype.

    The backward recomputes phi(q), phi(k) with `phi_positive` /
    `phi_relu` (Omega in fp32, ||x||^2 in the input dtype, as the JAX
    `_phi_xla`), runs `masked_linear_attention_coeffs_bwd` from the fused
    forward's den and out, and pulls dq', dk' back through phi to q, k and
    Omega (dOmega only when Omega requires a gradient). Nothing of phi is
    saved. Without autograd (inference mode, no_grad, or no input that
    needs a gradient) this is one forward launch and keeps nothing.
    """
    return _KerpleFusedPhi.apply(q, k, v, omega, coeffs, feature_kind)
