"""Flash softmax attention, forward and backward.

    S = scale * q k^T,  P = softmax(S),  out = P v

Counterpart of `efficient_rpe_vit_tpu/ops/pallas/attention_kernels.py`
(`_flash_kernel`, `_flash_fwd_impl`, `flash_softmax_attention`, the
dropout hash, `canonical_mask`) and `.../pallas/flash_bwd.py`
(`flash_attention_bwd`). The forward is hand-written CUDA C++ for sm_90a in
`csrc/flash_attention_fwd.cu`: an online softmax that keeps the [N, N]
scores on chip and saves the row log-sum-exp. The backward is three kernels
in `csrc/flash_attention_bwd.cu`: a fused single pass per (batch, head)
where it fits (bf16 at N <= 208 holds every key/value row of the head in
one block and finishes each query tile's dq there; elsewhere a head's whole
dq row sits in shared memory), and the dq / dkv two-pass split elsewhere.
Both take an optional keep-mask and apply
attention-probability dropout inside the kernel, from a counter hash of
(seed, b, h, i, j) that is the JAX package's bit for bit.

They also take SAM's decomposed relative-position bias (`rel_pos`): the
keys lie on a kh x kw grid (key j in grid row j // kw, column j % kw, N =
kh kw), and with rows rel_h [B, H, N, kh], rel_w [B, H, N, kw] (fp32) the
scores are

    S[i, j] = scale * q_i . k_j + rel_h[i, j // kw] + rel_w[i, j % kw]

summed in fp32 in that order. The backward then also returns d rel_h and
d rel_w, the sums of dS (rounded to the input dtype, as the products take
it) over each grid row and each grid column of the keys. On the card the
bias runs in bf16 on the forward and the dq / dkv kernels built with it
(never the fused pass), at head dims staged to 80 (SAM ViT-H's), on grids
with kw = 64 or with both sides at most 16 (`rel_mode`).

Every kernel has a wrapper that checks its inputs, takes the plain version
(`*_reference`) for CPU tensors and launches the kernel for CUDA tensors
(never falling back), and counts its launches in `<wrapper>.launches`.
The forward wrapper calls the custom op `efficient_rpe_vit::
flash_attention_fwd` (`_library.py`), whose CPU, CUDA and fake
implementations are the plain version, the launch and a shape-only one, so
`torch.export` keeps it as one node of an exported graph.
`flash_softmax_attention` is the differentiable op: a
`torch.autograd.Function` over the forward op whose backward is
`flash_attention_bwd`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ._build import LAUNCH_INFO_KEYS  # noqa: F401 (re-exported: what launch_info reports)
from ._build import dtype_suffix, launch, launch_info_buffer, launch_info_dict, load, on_cpu
from ._library import define

# the finite mask value of the forward (JAX: -0.7 * float32 max); the
# backward masks with -inf
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
MAX_D = 128  # largest head dim the kernels take

_FWD_SOURCE = "flash_attention_fwd"
_BWD_SOURCE = "flash_attention_bwd"
_DTYPES = (torch.bfloat16, torch.float32)

# ─── the dropout hash ───────────────────────────────────────────────────
# splitmix32 finalisers on wrapping 32-bit arithmetic, as
# `attention_kernels.py:118-174`: the keep decision of cell (b, h, i, j) is a
# pure function of (seed, b, h, i, j) in global indices. Here every value is
# an int64 holding 32 bits, so shifts are logical and products are reduced
# mod 2^32 without overflowing int64.

_M32 = 0xFFFF_FFFF
_SEED_B = 0x9E3779B1
_SEED_H = 0x7F4A7C15
_ROW_C = 0x9E3779B9
_COL_C = 0x6C62272E


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), in 16-bit halves of c."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    """uint32 round((1 - rate) * 2^32): a cell is kept when its hash is
    below it (unsigned)."""
    t = int(round((1.0 - float(rate)) * 4294967296.0))
    return min(max(t, 0), _M32)


def seed_operand(seed, device) -> torch.Tensor:
    """The dropout seed as the kernels read it: one int32 on `device`.
    Python and numpy ints, and int32 / int64 / uint32 tensors of one
    element, keep their low 32 bits (a uint32 seed >= 2^31 is bit-cast, as
    the JAX package's `_seed_operand` does); an int32 tensor already on
    `device` is used as it is, without a copy or a host sync."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1:
            raise ValueError(f"dropout_seed must hold one value, got shape "
                             f"{tuple(seed.shape)}")
        if seed.dtype == torch.int32:
            return seed.reshape(1).to(device)
        if seed.dtype not in (torch.int64, torch.uint32):
            raise TypeError(f"dropout_seed must be an integer tensor, got {seed.dtype}")
        s = seed.reshape(1).to(torch.int64) & _M32
        return ((s ^ 0x8000_0000) - 0x8000_0000).to(torch.int32).to(device)
    value = int(seed) & _M32
    return torch.tensor([value - (1 << 32) if value >= 1 << 31 else value],
                        dtype=torch.int32, device=device)


def dropout_keep(seed: torch.Tensor, b, h, rows, cols, rate: float) -> torch.Tensor:
    """Keep-mask of attention cells, True = keep, P(keep) = 1 - rate.

    Args:
        seed: the seed's 32 bits in an int64 tensor (`seed_operand(...)
            .long() & 0xFFFFFFFF`).
        b, h, rows, cols: broadcast-compatible int64 tensors of global batch,
            head, query and key indices.
        rate: drop probability in [0, 1).
    """
    hb = _mix32((seed + _mul32(b, _SEED_B) + _mul32(h, _SEED_H)) & _M32)
    x = _mix32((_mul32(rows, _ROW_C) + hb) & _M32)
    x = _mix32((x + _mul32(cols, _COL_C)) & _M32)
    return x < keep_threshold(rate)


def _seed_bits(seed, device) -> torch.Tensor:
    return seed_operand(seed, device).to(torch.int64) & _M32


def dropout_keep_dense(seed, B: int, H: int, n_rows: int, n_cols: int,
                       rate: float, device=None) -> torch.Tensor:
    """[B, H, n_rows, n_cols] keep-mask identical to the kernels', the
    counterpart of the JAX package's `dropout_keep_dense`. `device` defaults
    to the seed's (CPU for a Python int)."""
    if device is None:
        device = seed.device if isinstance(seed, torch.Tensor) else "cpu"
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    return dropout_keep(_seed_bits(seed, device), ar(B)[:, None, None, None],
                        ar(H)[None, :, None, None], ar(n_rows)[None, None, :, None],
                        ar(n_cols)[None, None, None, :], rate)


def canonical_mask(mask: torch.Tensor, B: int, H: int) -> Tuple[torch.Tensor, int]:
    """[B, N, N] / [B, 1, N, N] / [B, H, N, N] -> ([B, Hm, N, N], Hm)."""
    if mask.dim() == 3:
        mask = mask[:, None]
    if mask.dim() != 4:
        raise ValueError(f"mask must be [B, N, N] or [B, 1|H, N, N], got "
                         f"{tuple(mask.shape)}")
    Hm = mask.shape[1]
    if Hm not in (1, H):
        raise ValueError(f"mask head dim must be 1 or {H}, got {Hm}")
    if mask.shape[0] != B:
        raise ValueError(f"mask batch dim must be {B}, got {mask.shape[0]}")
    return mask, Hm


# ─── input checks ───────────────────────────────────────────────────────

def _check(q, k, v, *, rest=(), rows=()) -> None:
    """q, k, v (and `rest`, e.g. g) [B, H, N, D] in one dtype (bfloat16 or
    float32); `rows` (lse, delta) [B, H, N] fp32; all contiguous and on one
    device; CUDA tensors need D <= MAX_D."""
    tensors = {"q": q, "k": k, "v": v, **dict(rest), **dict(rows)}
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, N, D], got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v), *rest):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != q {tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}: bfloat16 or float32")
    for name, t in rows:
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be [B, H, N] float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not on_cpu(q) and q.shape[-1] > MAX_D:
        raise ValueError(f"the flash kernels take head dims up to {MAX_D}, "
                         f"got {q.shape[-1]}")


def _extras(q, mask, dropout_rate, dropout_seed):
    """(mask [B, Hm, N, N] bool contiguous or None, Hm, seed int32 [1] on
    q's device or None, rate) from the user's mask and dropout arguments."""
    B, H, N, _ = q.shape
    Hm = 1
    if mask is not None:
        mask, Hm = canonical_mask(mask, B, H)
        if mask.shape[2:] != (N, N):
            raise ValueError(f"mask must end in [N, N] = [{N}, {N}], got "
                             f"{tuple(mask.shape)}")
        if mask.device != q.device:
            raise ValueError(f"mask lies on {mask.device}, q on {q.device}")
        mask = (mask != 0).contiguous()
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    seed = None
    if rate > 0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        if isinstance(dropout_seed, torch.Tensor) and dropout_seed.device != q.device:
            raise ValueError(f"dropout_seed lies on {dropout_seed.device}, q on {q.device}")
        seed = seed_operand(dropout_seed, q.device)
    return mask, Hm, seed, rate


# ─── plain versions ─────────────────────────────────────────────────────
# Dense [H, N, N] formulas, one batch element at a time (so that the long-N
# shapes fit beside the kernels on the card), rounding where the kernels
# round: scores and sums in fp32, probabilities and dS rounded to the input
# dtype before their second product.

def _keep_b(seed_bits, b: int, H: int, N: int, rate: float) -> torch.Tensor:
    """[H, N, N] keep-mask of batch element b."""
    ar = functools.partial(torch.arange, dtype=torch.int64, device=seed_bits.device)
    return dropout_keep(seed_bits, torch.tensor(b, device=seed_bits.device),
                        ar(H)[:, None, None], ar(N)[None, :, None],
                        ar(N)[None, None, :], rate)


def _check_rel(q, rel_pos):
    """(rel_h, rel_w) as the kernels take them, or None: [B, H, N, kh] and
    [B, H, N, kw] fp32, contiguous, on q's device, with kh kw = N."""
    if rel_pos is None:
        return None
    rel_h, rel_w = rel_pos
    B, H, N, _ = q.shape
    for name, t in (("rel_h", rel_h), ("rel_w", rel_w)):
        if t.dim() != 4 or tuple(t.shape[:3]) != (B, H, N):
            raise ValueError(f"{name} must be [B, H, N, side] = [{B}, {H}, {N}, side], "
                             f"got {tuple(t.shape)}")
        if t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {q.device}")
    if rel_h.shape[-1] * rel_w.shape[-1] != N:
        raise ValueError(f"the key grid {rel_h.shape[-1]} x {rel_w.shape[-1]} does not "
                         f"hold N = {N} keys")
    return rel_h, rel_w


def _add_rel(s: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor) -> torch.Tensor:
    """[H, N, N] scores plus rel_h [H, N, kh] on each key's grid row, then
    rel_w [H, N, kw] on its grid column."""
    H, N, _ = s.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    s = s.view(H, N, kh, kw) + rel_h[..., :, None]
    return (s + rel_w[..., None, :]).view(H, N, N)


def flash_softmax_attention_reference(q, k, v, scale: float, mask=None,
                                      dropout_rate: float = 0.0,
                                      dropout_seed=None, rel_pos=None):
    """Plain version of the forward kernel.

    Returns:
        (out [B, H, N, D] in v's dtype, lse [B, H, N] fp32).
    """
    mask, _, seed, rate = _extras(q, mask, dropout_rate, dropout_seed)
    rel = _check_rel(q, rel_pos)
    B, H, N, _ = q.shape
    outs, lses = [], []
    for b in range(B):
        s = torch.einsum("hnd,hmd->hnm", q[b].float(), k[b].float()) * scale
        if rel is not None:
            s = _add_rel(s, rel[0][b], rel[1][b])
        if mask is not None:
            s = s.masked_fill(~mask[b], MASK_VALUE)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        l = p.sum(dim=-1)
        if rate > 0:
            keep = _keep_b(seed.long() & _M32, b, H, N, rate)
            p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
        acc = torch.einsum("hnm,hmd->hnd", p.to(v.dtype).float(), v[b].float())
        l_inv = torch.where(l == 0, 1.0, 1.0 / l)
        outs.append((acc * l_inv[..., None]).to(v.dtype))
        lses.append(torch.where(l == 0, MASK_VALUE,
                                m + torch.log(l.clamp_min(1e-37))))
    return torch.stack(outs), torch.stack(lses)


def flash_bwd_reference(q, k, v, g, lse, delta, scale: float, mask=None,
                        dropout_rate: float = 0.0, dropout_seed=None, rel_pos=None):
    """Plain version of the backward kernels, from lse and delta =
    sum(g * out) (fp32, [B, H, N]).

    Returns:
        (dq, dk, dv) in q's dtype; with rel_pos also d rel_h, d rel_w
        (fp32).
    """
    mask, _, seed, rate = _extras(q, mask, dropout_rate, dropout_seed)
    rel = _check_rel(q, rel_pos)
    B, H, N, _ = q.shape
    dt = q.dtype
    grads = []
    for b in range(B):
        qb, kb = q[b].float(), k[b].float()
        gb = g[b].float()
        s = torch.einsum("hnd,hmd->hnm", qb, kb) * scale
        if rel is not None:
            s = _add_rel(s, rel[0][b], rel[1][b])
        if mask is not None:
            s = s.masked_fill(~mask[b], float("-inf"))
        p = torch.exp(s - lse[b][..., None])
        dp = torch.einsum("hnd,hmd->hnm", gb, v[b].float())
        pe = p
        if rate > 0:
            keep = _keep_b(seed.long() & _M32, b, H, N, rate)
            inv_keep = 1.0 / (1.0 - rate)
            pe = torch.where(keep, p * inv_keep, 0.0)
            dp = torch.where(keep, dp * inv_keep, 0.0)
        ds = (p * (dp - delta[b][..., None])).to(dt).float()
        dv = torch.einsum("hnm,hnd->hmd", pe.to(dt).float(), gb)
        dk = torch.einsum("hnm,hnd->hmd", ds, qb) * scale
        dq = torch.einsum("hnm,hmd->hnd", ds, kb) * scale
        grads.append((dq.to(dt), dk.to(dt), dv.to(dt)))
        if rel is not None:
            cells = ds.view(H, N, rel[0].shape[-1], rel[1].shape[-1])
            grads[-1] += (cells.sum(-1), cells.sum(-2))
    return tuple(torch.stack(t) for t in zip(*grads))


def flash_delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """delta = sum(g * out) over the head dim, fp32 [B, H, N] (the JAX
    `flash_attention_bwd` computes it in XLA before its kernels)."""
    return (g.float() * out.float()).sum(dim=-1)


def flash_attention_bwd_reference(q, k, v, out, lse, g, scale: float,
                                  mask=None, dropout_rate: float = 0.0,
                                  dropout_seed=None):
    """Plain version of the whole backward from the forward's (out, lse).

    Returns:
        (dq, dk, dv) in q's dtype.
    """
    return flash_bwd_reference(q, k, v, g, lse, flash_delta(out, g), scale,
                               mask, dropout_rate, dropout_seed)


# ─── kernels ────────────────────────────────────────────────────────────

_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# after the pointers: B, H, N, D, mask_heads, scale, has_dropout,
# threshold, inv_keep, stream
_SCALARS = [_I32] * 5 + [ctypes.c_float, _I32, ctypes.c_uint, ctypes.c_float, _PTR]
# the bias launchers': B, H, N, D, kh, kw, mask_heads, then as _SCALARS
_REL_SCALARS = [_I32] * 2 + _SCALARS


@functools.cache
def _fwd_lib():
    lib = load(_FWD_SOURCE)
    for fn in (lib.flash_fwd_bf16, lib.flash_fwd_f32):
        fn.argtypes = [_PTR] * 7 + _SCALARS
        fn.restype = _I32
    lib.flash_fwd_launch_info.argtypes = [_I32] * 3 + [_PTR]
    lib.flash_fwd_launch_info.restype = _I32
    lib.flash_fwd_rel_bf16.argtypes = [_PTR] * 9 + _REL_SCALARS
    lib.flash_fwd_rel_bf16.restype = _I32
    lib.flash_fwd_rel_launch_info.argtypes = [_I32] * 4 + [_PTR]
    lib.flash_fwd_rel_launch_info.restype = _I32
    lib.flash_rel_mode.argtypes = [_I32] * 4
    lib.flash_rel_mode.restype = _I32
    lib.flash_fwd_error_string.argtypes = [_I32]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib():
    lib = load(_BWD_SOURCE)
    for kind in ("dq", "dkv", "fused"):
        for suffix in ("bf16", "f32"):
            fn = getattr(lib, f"flash_bwd_{kind}_{suffix}")
            fn.argtypes = [_PTR] * 11 + _SCALARS
            fn.restype = _I32
    lib.flash_bwd_fused_fits.argtypes = [_I32] * 3
    lib.flash_bwd_fused_fits.restype = _I32
    lib.flash_bwd_launch_info.argtypes = [_I32] * 4 + [_PTR]
    lib.flash_bwd_launch_info.restype = _I32
    lib.flash_bwd_dq_rel_bf16.argtypes = [_PTR] * 13 + _REL_SCALARS
    lib.flash_bwd_dkv_rel_bf16.argtypes = [_PTR] * 12 + _REL_SCALARS
    lib.flash_bwd_dq_rel_bf16.restype = lib.flash_bwd_dkv_rel_bf16.restype = _I32
    lib.flash_bwd_rel_launch_info.argtypes = [_I32] * 5 + [_PTR]
    lib.flash_bwd_rel_launch_info.restype = _I32
    lib.flash_bwd_error_string.argtypes = [_I32]
    lib.flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _scalars(q, Hm, scale, rate, rel=None):
    """The launchers' trailing arguments before the stream (the bias
    launchers' with `rel`, its grid's sides after D)."""
    B, H, N, D = q.shape
    grid = () if rel is None else (rel[0].shape[-1], rel[1].shape[-1])
    return (B, H, N, D, *grid, Hm, float(scale), int(rate > 0),
            keep_threshold(rate) if rate > 0 else 0,
            1.0 / (1.0 - rate))


def rel_mode(n: int, d: int, kh: int, kw: int) -> int:
    """How the bf16 kernels take the bias on a kh x kw grid of n keys at
    head dim d: 1 (kw = 64: a grid row per 64-key span), 2 (kh, kw <= 16:
    one-hot products), 0 where they refuse it; asked of the built library,
    so it needs the card's build."""
    return int(_fwd_lib().flash_rel_mode(n, d, kh, kw))


def fused_fits(n: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the fused backward pass runs at (n, d): where the staged
    fused kernel's shared memory (a head's dq row plus its tiles) fits one
    block on this card, which covers the bf16 mma.sync fused kernel's range
    (N <= 208); asked of the kernel source (`flash_bwd_fused_fits`), so it
    needs the built library."""
    return bool(_bwd_lib().flash_bwd_fused_fits(n, d, int(dtype == torch.bfloat16)))


_BWD_KINDS = {"flash_bwd_dq": 0, "flash_bwd_dkv": 1, "flash_bwd_fused": 2}


def launch_info(kernel: str, n: int, d: int, dtype: torch.dtype, rel_grid=None) -> dict:
    """What a launch of `kernel` ("flash_fwd", "flash_bwd_dq",
    "flash_bwd_dkv" or "flash_bwd_fused") at sequence length n and head dim
    d runs on this card, asked of the built library: rows per block (0 for
    the fused pass, one block per head), threads, dynamic shared memory
    bytes, resident blocks per SM, registers and local (spilled) bytes per
    thread, under `LAUNCH_INFO_KEYS`, and under "kernel" which kernel runs
    ("mma.sync", the register-resident one, or "staged"). With rel_grid =
    (kh, kw), the bf16 kernel with the relative-position bias on that key
    grid (not the fused pass). Needs a GPU."""
    if kernel != "flash_fwd" and kernel not in _BWD_KINDS:
        raise ValueError(f"unknown flash kernel {kernel!r}")
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype}: bfloat16 or float32")
    if n <= 0 or not 0 < d <= MAX_D:
        raise ValueError(f"need n > 0 and 0 < d <= {MAX_D}, got n={n}, d={d}")
    info = launch_info_buffer()
    is_bf16 = int(dtype == torch.bfloat16)
    if rel_grid is not None:
        if not is_bf16 or kernel == "flash_bwd_fused":
            raise ValueError("the bias runs on the bf16 forward, dq and dkv kernels only")
        if kernel == "flash_fwd":
            lib = _fwd_lib()
            err = lib.flash_fwd_rel_launch_info(n, d, *rel_grid, info)
            errors = lib.flash_fwd_error_string
        else:
            lib = _bwd_lib()
            err = lib.flash_bwd_rel_launch_info(_BWD_KINDS[kernel], n, d, *rel_grid, info)
            errors = lib.flash_bwd_error_string
    elif kernel == "flash_fwd":
        lib = _fwd_lib()
        err, errors = lib.flash_fwd_launch_info(n, d, is_bf16, info), lib.flash_fwd_error_string
    else:
        lib = _bwd_lib()
        err = lib.flash_bwd_launch_info(_BWD_KINDS[kernel], n, d, is_bf16, info)
        errors = lib.flash_bwd_error_string
    if err != 0:
        raise RuntimeError(f"{kernel} launch info at n={n} d={d}: CUDA error {err} "
                           f"({errors(err).decode()})")
    return launch_info_dict(info)


def _check_extras(q, mask, seed) -> int:
    """The op's mask ([B, 1|H, N, N] bool, contiguous) and seed (int32 [1])
    as `_extras` gives them, on q's device; returns the mask's head count."""
    for name, t, dtype in (("mask", mask, torch.bool), ("seed", seed, torch.int32)):
        if t is None:
            continue
        if t.device != q.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {q.device}")
    if mask is None:
        return 1
    B, H, N, _ = q.shape
    if mask.dim() != 4 or mask.shape[0] != B or mask.shape[1] not in (1, H) \
            or mask.shape[2:] != (N, N):
        raise ValueError(f"mask must be [B, 1|H, N, N] = [{B}, 1|{H}, {N}, {N}], "
                         f"got {tuple(mask.shape)}")
    return mask.shape[1]


def _rel_pair(rel_h, rel_w):
    if (rel_h is None) != (rel_w is None):
        raise ValueError("rel_h and rel_w come together")
    return None if rel_h is None else (rel_h, rel_w)


def _check_rel_cuda(q, rel) -> None:
    """The bias kernels' own limits: bf16, and a head dim and key grid that
    `rel_mode` takes."""
    if q.dtype != torch.bfloat16:
        raise ValueError("the relative-position bias runs on the bf16 kernels only")
    _, _, N, D = q.shape
    kh, kw = rel[0].shape[-1], rel[1].shape[-1]
    if rel_mode(N, D, kh, kw) == 0:
        raise ValueError(f"the bias kernels take head dims 65 to 80 and key grids "
                         f"with kw = 64 or kh, kw <= 16; got D = {D}, {kh} x {kw}")


def _fwd_cuda(q, k, v, mask, seed, scale, dropout_rate, rel_h=None, rel_w=None):
    _check(q, k, v)
    Hm = _check_extras(q, mask, seed)
    rel = _check_rel(q, _rel_pair(rel_h, rel_w))
    if dropout_rate > 0 and seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    lib = _fwd_lib()
    out = torch.empty_like(v)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if rel is None:
        launch(lib.flash_fwd_error_string, "flash_fwd",
               getattr(lib, f"flash_fwd_{dtype_suffix(q.dtype)}"), q.device,
               q, k, v, mask, seed, out, lse, *_scalars(q, Hm, scale, dropout_rate))
    else:
        _check_rel_cuda(q, rel)
        launch(lib.flash_fwd_error_string, "flash_fwd_rel", lib.flash_fwd_rel_bf16, q.device,
               q, k, v, *rel, mask, seed, out, lse, *_scalars(q, Hm, scale, dropout_rate, rel))
    flash_attention_fwd.launches += 1
    return out, lse


def _fwd_cpu(q, k, v, mask, seed, scale, dropout_rate, rel_h=None, rel_w=None):
    _check(q, k, v)
    _check_extras(q, mask, seed)
    return flash_softmax_attention_reference(q, k, v, scale, mask, dropout_rate, seed,
                                             _rel_pair(rel_h, rel_w))


def _fwd_fake(q, k, v, mask, seed, scale, dropout_rate, rel_h=None, rel_w=None):
    _check(q, k, v)  # refuses meta tensors, which land here, like any other device
    _check_extras(q, mask, seed)
    _check_rel(q, _rel_pair(rel_h, rel_w))
    return torch.empty_like(v), q.new_empty(q.shape[:3], dtype=torch.float32)


_fwd_op = define("flash_attention_fwd",
                 "(Tensor q, Tensor k, Tensor v, Tensor? mask, Tensor? seed, float scale,"
                 " float dropout_rate, Tensor? rel_h=None, Tensor? rel_w=None)"
                 " -> (Tensor, Tensor)", _fwd_cpu, _fwd_cuda, _fwd_fake)


def flash_attention_fwd(q, k, v, scale: float, mask=None,
                        dropout_rate: float = 0.0, dropout_seed=None, rel_pos=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention forward with the row log-sum-exp. Replaces
    `_flash_kernel`; the custom op `efficient_rpe_vit::flash_attention_fwd`
    after the mask and seed are put in the form it takes (`_extras`).

    Args:
        q, k, v: [B, H, N, D], one dtype (bfloat16 or float32), contiguous,
            on one device; on the GPU D <= 128.
        scale: applied to q.k before the softmax.
        mask: optional [B, N, N] / [B, 1, N, N] / [B, H, N, N]; zeros are
            masked out (a row needs one kept cell).
        dropout_rate: attention-probability drop rate in [0, 1).
        dropout_seed: required when dropout_rate > 0: an int or a one-value
            integer tensor (`seed_operand`).
        rel_pos: optional (rel_h [B, H, N, kh], rel_w [B, H, N, kw]) fp32,
            the decomposed relative-position bias on a kh x kw key grid.
    Returns:
        (out [B, H, N, D] in v's dtype, lse [B, H, N] fp32).
    Raises:
        ValueError / TypeError on malformed inputs, RuntimeError when the
        kernel launch is refused.
    """
    mask, _, seed, rate = _extras(q, mask, dropout_rate, dropout_seed)
    rel = _check_rel(q, rel_pos) or (None, None)
    return _fwd_op(q, k, v, mask, seed, float(scale), rate, *rel)


def _bwd_launch(kind: str, q, k, v, g, lse, delta, scale, mask, dropout_rate,
                dropout_seed, dq=None, dk=None, dv=None) -> None:
    mask, Hm, seed, rate = _extras(q, mask, dropout_rate, dropout_seed)
    lib = _bwd_lib()
    launch(lib.flash_bwd_error_string, f"flash_bwd_{kind}",
           getattr(lib, f"flash_bwd_{kind}_{dtype_suffix(q.dtype)}"), q.device,
           q, k, v, g, lse, delta, mask, seed, dq, dk, dv,
           *_scalars(q, Hm, scale, rate))


def _bwd_rel_launch(kind: str, q, k, v, g, lse, delta, scale, mask, dropout_rate,
                    dropout_seed, rel, *outputs) -> None:
    """The dq (outputs dq, drel_h, drel_w) or dkv (dk, dv) bias kernel."""
    _check_rel_cuda(q, rel)
    mask, Hm, seed, rate = _extras(q, mask, dropout_rate, dropout_seed)
    lib = _bwd_lib()
    launch(lib.flash_bwd_error_string, f"flash_bwd_{kind}_rel",
           getattr(lib, f"flash_bwd_{kind}_rel_bf16"), q.device,
           q, k, v, g, lse, delta, *rel, mask, seed, *outputs,
           *_scalars(q, Hm, scale, rate, rel))


def flash_attention_bwd_fused(q, k, v, g, lse, delta, scale: float, mask=None,
                              dropout_rate: float = 0.0, dropout_seed=None):
    """(dq, dk, dv) in one pass per (batch, head), dq finished on chip
    without atomics: the launch is refused where `fused_fits` is false
    (`launch_info` says which fused kernel runs). Replaces
    `_flash_bwd_fused_kernel`. Arguments as `flash_attention_fwd`, plus the
    cotangent g [B, H, N, D] and lse, delta [B, H, N] fp32."""
    _check(q, k, v, rest=[("g", g)], rows=[("lse", lse), ("delta", delta)])
    if on_cpu(q):
        return flash_bwd_reference(q, k, v, g, lse, delta, scale, mask,
                                   dropout_rate, dropout_seed)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _bwd_launch("fused", q, k, v, g, lse, delta, scale, mask, dropout_rate,
                dropout_seed, dq, dk, dv)
    flash_attention_bwd_fused.launches += 1
    return dq, dk, dv


def flash_attention_bwd_dq(q, k, v, g, lse, delta, scale: float, mask=None,
                           dropout_rate: float = 0.0, dropout_seed=None, rel_pos=None):
    """dq alone (the two-pass split's first pass); with rel_pos (dq,
    d rel_h, d rel_w). Replaces `_flash_dq_kernel`."""
    _check(q, k, v, rest=[("g", g)], rows=[("lse", lse), ("delta", delta)])
    rel = _check_rel(q, rel_pos)
    if on_cpu(q):
        grads = flash_bwd_reference(q, k, v, g, lse, delta, scale, mask,
                                    dropout_rate, dropout_seed, rel)
        return grads[0] if rel is None else (grads[0], *grads[3:])
    dq = torch.empty_like(q)
    if rel is None:
        _bwd_launch("dq", q, k, v, g, lse, delta, scale, mask, dropout_rate,
                    dropout_seed, dq=dq)
        out = dq
    else:
        out = (dq, *(torch.empty_like(t) for t in rel))
        _bwd_rel_launch("dq", q, k, v, g, lse, delta, scale, mask, dropout_rate,
                        dropout_seed, rel, *out)
    flash_attention_bwd_dq.launches += 1
    return out


def flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale: float, mask=None,
                            dropout_rate: float = 0.0, dropout_seed=None, rel_pos=None):
    """(dk, dv) (the two-pass split's second pass). Replaces
    `_flash_dkv_kernel`."""
    _check(q, k, v, rest=[("g", g)], rows=[("lse", lse), ("delta", delta)])
    rel = _check_rel(q, rel_pos)
    if on_cpu(q):
        return flash_bwd_reference(q, k, v, g, lse, delta, scale, mask,
                                   dropout_rate, dropout_seed, rel)[1:3]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if rel is None:
        _bwd_launch("dkv", q, k, v, g, lse, delta, scale, mask, dropout_rate,
                    dropout_seed, dk=dk, dv=dv)
    else:
        _bwd_rel_launch("dkv", q, k, v, g, lse, delta, scale, mask, dropout_rate,
                        dropout_seed, rel, dk, dv)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


for _fn in (flash_attention_fwd, flash_attention_bwd_fused,
            flash_attention_bwd_dq, flash_attention_bwd_dkv):
    _fn.launches = 0
del _fn


def flash_attention_bwd(q, k, v, out, lse, g, scale: float, mask=None,
                        dropout_rate: float = 0.0, dropout_seed=None,
                        fused: Optional[bool] = None, rel_pos=None):
    """Backward of the flash forward from its saved (out, lse).

    Args:
        q, k, v, scale, mask, dropout_rate, dropout_seed, rel_pos: the
            forward's.
        out [B, H, N, D], lse [B, H, N] fp32: the forward's outputs.
        g: [B, H, N, D] cotangent of out, in q's dtype, contiguous.
        fused: True forces the fused kernel, False the dq / dkv two-pass
            split; None picks fused where it fits (`fused_fits`). With
            rel_pos the split always runs (the fused pass has no bias).
    Returns:
        (dq, dk, dv) in q's dtype, with rel_pos also d rel_h, d rel_w
        (fp32). CPU tensors take the plain version.
    """
    _check(q, k, v, rest=[("out", out), ("g", g)], rows=[("lse", lse)])
    delta = flash_delta(out, g)
    args = (q, k, v, g, lse, delta, scale, mask, dropout_rate, dropout_seed)
    rel = _check_rel(q, rel_pos)
    if on_cpu(q):
        return flash_bwd_reference(*args, rel)
    if rel is not None:
        if fused:
            raise ValueError("the fused backward takes no relative-position bias")
        dq, drel_h, drel_w = flash_attention_bwd_dq(*args, rel)
        return (dq, *flash_attention_bwd_dkv(*args, rel), drel_h, drel_w)
    if fused is None:
        fused = fused_fits(q.shape[2], q.shape[3], q.dtype)
    if fused:
        return flash_attention_bwd_fused(*args)
    return flash_attention_bwd_dq(*args), *flash_attention_bwd_dkv(*args)


# ─── the differentiable op ──────────────────────────────────────────────

class _FlashSoftmax(torch.autograd.Function):
    """Forward kernel; backward kernels from the saved (out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed, scale, rate, rel_h, rel_w):
        out, lse = _fwd_op(q, k, v, mask, seed, scale, rate, rel_h, rel_w)
        ctx.save_for_backward(q, k, v, out, lse, mask, seed, rel_h, rel_w)
        ctx.scale, ctx.rate = scale, rate
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse, mask, seed, rel_h, rel_w = ctx.saved_tensors
        # the cotangent arrives through the head merge's transpose
        grads = flash_attention_bwd(q, k, v, out, lse, g.contiguous(), ctx.scale, mask,
                                    ctx.rate, seed, rel_pos=_rel_pair(rel_h, rel_w))
        return (*grads[:3], None, None, None, None, *(grads[3:] or (None, None)))


def flash_softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float, mask: Optional[torch.Tensor] = None,
                            dropout_rate: float = 0.0,
                            dropout_seed=None, rel_pos=None) -> torch.Tensor:
    """Differentiable softmax(scale * q k^T + bias) v on the flash kernels,
    [B, H, N, D] in v's dtype; the mask and the seed get no gradient, the
    optional relative-position rows rel_pos = (rel_h, rel_w) do (see the
    module's note; they are cast to fp32 here). q, k and v are made
    contiguous here (the head split gives transposed views).

    Without autograd (inference mode, no_grad, or no input that needs a
    gradient) autograd records no node and drops what the forward saved, so
    this is one forward launch and keeps nothing.
    """
    q, k, v = (t.contiguous() for t in (q, k, v))
    mask, _, seed, rate = _extras(q, mask, dropout_rate, dropout_seed)
    rel = (None, None) if rel_pos is None else tuple(t.float().contiguous() for t in rel_pos)
    return _FlashSoftmax.apply(q, k, v, mask, seed, float(scale), rate, *rel)
