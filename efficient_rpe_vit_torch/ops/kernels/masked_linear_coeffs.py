"""Coeffs-native Toeplitz-masked linear attention (KERPLE) forward.

    out_i = sum_j c[j-i+N-1] (q'_i.k'_j) v_j / (den_i + eps),
    den_i = sum_j c[j-i+N-1] (q'_i.k'_j)

Counterpart of `efficient_rpe_vit_tpu/ops/pallas/masked_linear_coeffs.py`
(`_fwd_kernel`). The kernel is hand-written CUDA C++ for sm_90a in
`csrc/masked_linear_coeffs_fwd.cu`; it builds each Toeplitz tile from a
window of the coefficient vector, so no [H, N, N] tensor exists.

The wrapper checks its inputs, then takes the plain version for CPU
tensors and launches the kernel for CUDA tensors (never falling back).
`masked_linear_attention_coeffs_fwd.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..fft_toeplitz import toeplitz_from_coeffs
from ._build import load

EPS = 1e-6  # denominator stabiliser, as in the JAX package

_SOURCE = "masked_linear_coeffs_fwd"
_DTYPES = (torch.bfloat16, torch.float32)


def masked_linear_attention_coeffs_reference(
        q_prime: torch.Tensor, k_prime: torch.Tensor, v: torch.Tensor,
        coeffs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel, with the same precision rule: scores and
    weights in fp32, weights rounded to v's dtype for the value product
    (fp32 accumulation), den in fp32.

    Returns:
        (out [B, H, N, D] in v's dtype, den [B, H, N] fp32).
    """
    n = q_prime.shape[2]
    t = toeplitz_from_coeffs(coeffs.float(), n)  # [H, N, N]
    w = torch.einsum("bhif,bhjf->bhij", q_prime.float(), k_prime.float()) * t
    num = torch.einsum("bhij,bhjd->bhid", w.to(v.dtype).float(), v.float())
    den = w.sum(dim=-1)
    return (num / (den[..., None] + EPS)).to(v.dtype), den


def _check_inputs(q_prime, k_prime, v, coeffs) -> None:
    tensors = {"q_prime": q_prime, "k_prime": k_prime, "v": v,
               "coeffs": coeffs}
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
    if coeffs.shape != (H, 2 * N - 1):
        raise ValueError(f"coeffs must be [H, 2N-1] = [{H}, {2 * N - 1}], "
                         f"got {tuple(coeffs.shape)}")
    if not (q_prime.dtype == k_prime.dtype == v.dtype):
        raise TypeError(f"q_prime, k_prime and v must share a dtype, got "
                        f"{q_prime.dtype}, {k_prime.dtype}, {v.dtype}")
    if q_prime.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q_prime.dtype}: bfloat16 or "
                        "float32")
    if coeffs.dtype != torch.float32:
        raise TypeError(f"coeffs must be float32, got {coeffs.dtype}")
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
    lib.mlc_error_string.argtypes = [i32]
    lib.mlc_error_string.restype = ctypes.c_char_p
    return lib


def masked_linear_attention_coeffs_fwd(
        q_prime: torch.Tensor, k_prime: torch.Tensor, v: torch.Tensor,
        coeffs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """KERPLE attention forward straight from the coefficient vector.

    Args:
        q_prime, k_prime: [B, H, N, F] non-negative features.
        v: [B, H, N, D].
        coeffs: [H, 2N-1] fp32 positive Toeplitz coefficients.
        q_prime, k_prime and v share a dtype (bfloat16 or float32); all
        four are contiguous and on one device. On the GPU the kernel also
        needs D <= 128 and an F whose tiles fit in shared memory (at
        D=64, F up to ~750 in bf16, ~380 in fp32); the launch is refused
        otherwise.
    Returns:
        (out [B, H, N, D] in v's dtype, den [B, H, N] fp32).
    Raises:
        ValueError / TypeError on malformed inputs, RuntimeError when the
        kernel launch is refused.
    """
    _check_inputs(q_prime, k_prime, v, coeffs)
    if q_prime.device.type == "cpu":
        return masked_linear_attention_coeffs_reference(
            q_prime, k_prime, v, coeffs)
    if q_prime.device.type != "cuda":
        raise ValueError(f"unsupported device {q_prime.device}")
    B, H, N, F = q_prime.shape
    D = v.shape[-1]
    lib = _kernel_fns()
    out = torch.empty_like(v)
    den = torch.empty((B, H, N), dtype=torch.float32, device=v.device)
    fn = lib.mlc_fwd_bf16 if q_prime.dtype == torch.bfloat16 else lib.mlc_fwd_f32
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = fn(q_prime.data_ptr(), k_prime.data_ptr(), v.data_ptr(),
                 coeffs.data_ptr(), out.data_ptr(), den.data_ptr(),
                 B, H, N, F, D, stream)
    if err != 0:
        raise RuntimeError(
            f"masked_linear_coeffs_fwd launch refused at F={F}, D={D}: CUDA "
            f"error {err} ({lib.mlc_error_string(err).decode()})")
    masked_linear_attention_coeffs_fwd.launches += 1
    return out, den


masked_linear_attention_coeffs_fwd.launches = 0


def masked_linear_attention_coeffs(q_prime: torch.Tensor,
                                   k_prime: torch.Tensor, v: torch.Tensor,
                                   coeffs: torch.Tensor) -> torch.Tensor:
    """`masked_linear_attention_coeffs_fwd` without the denominator:
    [B, H, N, D] in v's dtype."""
    return masked_linear_attention_coeffs_fwd(q_prime, k_prime, v, coeffs)[0]
