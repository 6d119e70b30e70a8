#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # what CI runs: build, check, serve, train
    python3 chip_smoke.py --profile  # also trace one served batch and one train step of each model

Phases, each printed as it runs; any failure exits non-zero:
  1. environment: versions, the card's name and power limit, TF32 off;
  2. build: every CUDA source under efficient_rpe_vit_torch/csrc, with nvcc,
     all at once;
  3. KERPLE kernels (forward; 3b: backward dq, dkv, dc, dc_reduce) against
     their plain PyTorch versions on the card at the serving and training
     shapes and at ragged shapes, in bf16 and fp32, timed (calls replayed
     from a CUDA graph, so without the wrapper's host work) beside their
     bounds;
  3c. flash kernels (softmax forward; backward fused, dq, dkv) against their
     plain versions in bf16 and fp32 at the serving, training and ragged
     shapes, with [B,1,N,N] and [B,H,N,N] masks and with dropout (whose
     keep-mask must equal dropout_keep_dense bit for bit), the backward
     fused and two-pass where the fused kernel fits, by its own choice
     (two-pass) at D=128 and at N=4097;
     timed beside their bounds and beside scaled_dot_product_attention;
  4. serve KERPLE: ViT-B/16 performer_favor_most_general (bf16, random
     weights from a seed) answers 4 requests of 32 images through
     `make_eval_step`; launch counts, logits against the same model on the
     plain (dense) KERPLE path, bitwise run to run, ms per batch;
  5. train KERPLE: the same model takes 5 steps of batch 64 through
     `create_train_state` / `make_train_step`; launch counts per step,
     finite gradients for every parameter, step-1 gradients against the
     dense KERPLE path and bitwise across two runs, finite losses beside the
     dense path's, and ms per step for both;
  6. serve baseline: ViT-B/16 `baseline` (softmax attention) as phase 4 on
     the flash forward (48 launches), against the dense softmax arm;
  7. train baseline at N=197: as phase 5 at batch 64; per step 12 flash_fwd
     and 12 flash_bwd_fused launches and no two-pass launch;
  8. long-N train: `baseline` on 1024x1024 images (N=4097), batch 4,
     attention and output dropout 0.1: step 1 twice (bitwise gradients), one
     warm-up step, two timed; per step 12 flash_fwd, 12 flash_bwd_dq and 12
     flash_bwd_dkv launches and no fused launch; finite gradients and
     losses, ms per step and peak memory (no dense arm: it would hold 12
     blocks of [4, 12, 4097, 4097] fp32; phase 3c checks this shape at the
     op level).
The line before the last lists every kernel as JSON, one row per kernel and
main path; the last line is {"ok": true, "device": {...}}. Without a GPU, or
without the rest of the repository beside it, the script fails before
printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM data-sheet peaks (dense): the bound of a kernel is the larger of
# bytes / memory rate and operations / compute rate for its input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # tensor core bf16, fp32 FMA

# kernel vs plain version: |kernel - plain| <= atol + rtol * |plain|.
# fp32: only the summation order differs (~1e-6 relative at F=266).
# bf16: outputs are rounded to bf16 (2^-8 relative); a weight whose fp32
# value lands on the other side of a bf16 rounding boundary may differ by
# one ulp, so allow ~2.5 ulps of the output plus a small absolute floor.
# den is fp32 in both versions: only the summation order differs.
OUT_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-3)}
DEN_RTOL = 1e-4

# served logits, kernel vs dense path, both bf16: the two paths round
# different fp32 sums to bf16 in each of 12 blocks; allow 5% of the logit
# range, and require >= 99% top-1 agreement.
LOGIT_REL_TOL = 5e-2
MIN_TOP1_AGREEMENT = 0.99

# backward kernels vs their plain versions: max |kernel - plain| <= tol *
# max |plain| per output. fp32: summation order only. bf16: dA and A*T are
# rounded to bf16 from fp32 sums taken in another order, so an element may
# round the other way (one bf16 ulp, 2^-8 relative) before the products.
# dcoeffs and the dc windows are fp32 sums of fp32 products in both dtypes.
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DCOEFF_TOL = {"float32": 1e-4, "bfloat16": 1e-2}

# flash kernels vs their plain versions, max |kernel - plain| <= tol *
# max |plain| for out, dq, dk, dv: fp32 differs in summation order (and the
# online softmax's rescaling) only. bf16: the kernel rounds p = exp(s - m)
# against the running row max of its 64-column tiles, the plain version
# against the final max, so a probability may round one bf16 ulp the other
# way before the value product; likewise dS. lse is fp32 from fp32 sums in
# both: absolute tolerance.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_ATOL = 1e-4

# train step-1 gradients, kernel path vs dense path (same weights, bf16):
# ||g_kernel - g_dense|| / ||g_dense|| per parameter tensor.
GRAD_REL_TOL = 5e-2

VITB = dict(image_size=224, patch_size=16, in_channels=3, num_classes=1000,
            dim=768, depth=12, heads=12, mlp_dim=3072, dropout=0.0,
            compute_dtype="bfloat16", batch_size=32)
REQUESTS = 4
TRAIN_BATCH = 64
TRAIN_STEPS = 5
TIMED_STEPS = 5
# long-N training: 1024x1024 images at patch 16 (N = 64^2 + 1 = 4097), the
# JAX package's reference-default dropout 0.1
LONGN = dict(VITB, image_size=1024, dropout=0.1, batch_size=4)
LONGN_N = (LONGN["image_size"] // LONGN["patch_size"]) ** 2 + 1
LONGN_STEPS = 2   # step 1 (bitwise against a first run), then a warm-up step
LONGN_TIMED = 2
# (B, H, N, F, D): the ViT-B/16 training shape, ragged shapes, the JAX
# package's kernel-test shape
BWD_SHAPES = [(TRAIN_BATCH, 12, 197, 266, 64), (4, 12, 17, 266, 64),
              (4, 12, 130, 266, 64), (2, 2, 197, 44, 16)]
BWD_KERNELS = ("masked_linear_coeffs_bwd_dq", "masked_linear_coeffs_bwd_dkv",
               "masked_linear_coeffs_bwd_dc", "masked_linear_coeffs_bwd_dc_reduce")
# flash cases (B, H, N, D, mask, dropout rate): the serving and training
# shapes, ragged shapes, the JAX package's kernel-test shape, both mask
# layouts, dropout alone and with a mask, the largest head dim
FLASH_CASES = [(VITB["batch_size"], 12, 197, 64, None, 0.0),
               (TRAIN_BATCH, 12, 197, 64, None, 0.0),
               (4, 12, 17, 64, None, 0.0), (4, 12, 130, 64, None, 0.0),
               (2, 2, 197, 16, None, 0.0),
               (4, 12, 197, 64, "B1NN", 0.0), (4, 12, 197, 64, "BHNN", 0.0),
               (4, 12, 197, 64, None, 0.1), (4, 12, 197, 64, "BHNN", 0.1),
               (2, 2, 197, 128, None, 0.0)]
FLASH_LONGN = (LONGN["batch_size"], 12, LONGN_N, 64, None, LONGN["dropout"])

# --profile sums device time by these groups of kernel names, first match wins
PROFILE_GROUPS = [
    ("KERPLE kernels (this repo)", lambda k: "mlc_" in k),
    ("flash attention kernels (this repo)", lambda k: "flash_fwd_kernel" in k or "flash_bwd_" in k),
    ("fp32 GEMMs (phi projection x@Omega, fwd and bwd)", lambda k: "f32f32" in k or "sgemm" in k),
    ("bf16 GEMMs (cuBLAS)", lambda k: "nvjet" in k or "gemm" in k),
    ("optimizer (multi-tensor apply)", lambda k: "multi_tensor" in k),
    ("copies and casts", lambda k: "copy" in k),
    ("reductions", lambda k: "reduce" in k),
    ("other elementwise", lambda k: "elementwise" in k),
    ("other", lambda k: True),
]


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int = 20) -> float:
    """Mean device time of one kernel call: `iters` calls captured in one
    CUDA graph, so the wrapper's host work (checks, allocation, ctypes) is
    outside the timed replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = time_ms(graph.replay, iters=5, warmup=1) / iters
    del graph
    return ms


def kerple_bound(B, H, N, F, D, dtype: str):
    """(bound_ms, bound_by) for one KERPLE forward: inputs read once,
    outputs written once; S = q'k'^T and W v products plus the
    mask/rowsum/divide elementwise work."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * (2 * B * H * N * F + 2 * B * H * N * D) \
        + 4 * (H * (2 * N - 1) + B * H * N)
    ops = 2 * B * H * N * N * (F + D) + 3 * B * H * N * N + B * H * N * D
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kerple_bwd_bounds(B, H, N, F, D, dtype: str, tile: int):
    """{kernel: (bound_ms, bound_by)} for the four backward kernels with
    `tile`-row tiles (the wrapper's BWD_TILE): each input read once (gn, v,
    q', k' in the input dtype; s, coeffs, windows in fp32), each output
    written once; the products M = gn v^T, A = q'k'^T and the
    accumulations, plus the elementwise mask / subtract / multiply work.
    The reduce is fp32 adds, outside the tensor cores."""
    elt = 2 if dtype == "bfloat16" else 4
    bhn, nn = B * H * N, B * H * N * N
    n_t = -(-N // tile)
    win_bytes = 4 * H * n_t * n_t * (2 * tile - 1)
    coef_bytes, s_bytes = 4 * H * (2 * N - 1), 4 * bhn
    peak = PEAK_OPS_PER_S[dtype]
    work = {
        "masked_linear_coeffs_bwd_dq": (
            elt * bhn * (D + D + F + F) + s_bytes + coef_bytes,
            2 * nn * (D + F) + 3 * nn, peak),
        "masked_linear_coeffs_bwd_dkv": (
            elt * bhn * (D + D + F + F + F + D) + s_bytes + coef_bytes,
            2 * nn * (2 * F + 2 * D) + 5 * nn, peak),
        "masked_linear_coeffs_bwd_dc": (
            elt * bhn * (D + D + F + F) + s_bytes + win_bytes,
            2 * nn * (F + D) + 3 * nn + H * n_t * n_t * tile * tile, peak),
        "masked_linear_coeffs_bwd_dc_reduce": (
            win_bytes + coef_bytes, H * n_t * n_t * (2 * tile - 1),
            PEAK_OPS_PER_S["float32"]),
    }
    out = {}
    for name, (nbytes, ops, rate) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def _max_rel(got, want) -> float:
    """max |got - want| / max |want| over the tensor."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def check_bwd_kernels(mlc):
    """Phase 3b: the four backward kernels, one by one and through the
    backward wrapper, against their plain versions on the card."""
    results = {}
    for B, H, N, F, D in BWD_SHAPES:
        for name, dtype in (("bfloat16", torch.bfloat16),
                            ("float32", torch.float32)):
            g = torch.Generator(device="cuda").manual_seed(N * 1000 + F + 7)
            q = (torch.randn(B, H, N, F, generator=g, device="cuda").abs() * 0.1).to(dtype)
            k = (torch.randn(B, H, N, F, generator=g, device="cuda").abs() * 0.1).to(dtype)
            v = torch.randn(B, H, N, D, generator=g, device="cuda").to(dtype)
            c = torch.exp(torch.randn(H, 2 * N - 1, generator=g, device="cuda") * 0.02)
            cot = torch.randn(B, H, N, D, generator=g, device="cuda").to(dtype)
            out, den = mlc.masked_linear_attention_coeffs_reference(q, k, v, c)
            gn, s = mlc.kerple_bwd_residuals(den, out, cot)
            windows = mlc.masked_linear_attention_coeffs_bwd_dc(gn, s, v, q, k)
            runs = {
                "masked_linear_coeffs_bwd_dq": (
                    lambda: mlc.masked_linear_attention_coeffs_bwd_dq(gn, s, v, k, c),
                    lambda: mlc.masked_linear_attention_coeffs_bwd_dq_reference(gn, s, v, k, c),
                    BWD_TOL[name]),
                "masked_linear_coeffs_bwd_dkv": (
                    lambda: mlc.masked_linear_attention_coeffs_bwd_dkv(gn, s, v, q, k, c),
                    lambda: mlc.masked_linear_attention_coeffs_bwd_dkv_reference(gn, s, v, q, k, c),
                    BWD_TOL[name]),
                "masked_linear_coeffs_bwd_dc": (
                    lambda: mlc.masked_linear_attention_coeffs_bwd_dc(gn, s, v, q, k),
                    lambda: mlc.masked_linear_attention_coeffs_bwd_dc_reference(gn, s, v, q, k),
                    DCOEFF_TOL[name]),
                # the reduce is held against its plain version on the same windows
                "masked_linear_coeffs_bwd_dc_reduce": (
                    lambda: mlc.masked_linear_attention_coeffs_bwd_dc_reduce(windows, N),
                    lambda: mlc.masked_linear_attention_coeffs_bwd_dc_reduce_reference(windows, N),
                    DCOEFF_TOL[name]),
            }
            shape = f"B{B} H{H} N{N} F{F} D{D} {name}"
            for kname, (kernel_fn, plain_fn, tol) in runs.items():
                got, want = kernel_fn(), plain_fn()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                rels = [_max_rel(a, b) for a, b in zip(got, want)]
                errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
                finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
                log("kernel", f"{kname} {shape}: max|err|/max|plain| "
                    f"{', '.join(f'{r:.3e}' for r in rels)} (tol {tol}), finite {finite}")
                if not (finite and max(rels) <= tol):
                    raise AssertionError(f"{kname} disagrees with its plain version at {shape}")
                if (B, H, N, F, D) == BWD_SHAPES[0] and name == "bfloat16":
                    ms = kernel_ms(kernel_fn)
                    plain_ms = time_ms(plain_fn, iters=5, warmup=1)
                    bound_ms, bound_by = kerple_bwd_bounds(
                        B, H, N, F, D, name, mlc.BWD_TILE[dtype])[kname]
                    log("kernel", f"{kname} {shape}: kernel {ms:.4f} ms, plain "
                        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                        f"kernel/bound {ms / bound_ms:.2f}x")
                    results[kname] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                                          bound_ms=bound_ms, bound_by=bound_by)
            # the whole backward, as autograd calls it, against the plain backward
            got = mlc.masked_linear_attention_coeffs_bwd(q, k, v, c, den, out, cot)
            want = mlc.masked_linear_attention_coeffs_bwd_reference(q, k, v, c, den, out, cot)
            tols = (BWD_TOL[name],) * 3 + (DCOEFF_TOL[name],)
            rels = [_max_rel(a, b) for a, b in zip(got, want)]
            log("kernel", f"masked_linear_attention_coeffs_bwd {shape}: (dq', dk', dv, "
                f"dcoeffs) max|err|/max|plain| {', '.join(f'{r:.3e}' for r in rels)}")
            if any(r > t for r, t in zip(rels, tols)):
                raise AssertionError(f"the backward disagrees with its plain version at {shape}")
    return results


def check_kernels(mlc):
    """Phase 3: the KERPLE forward kernel against its plain version on the card."""
    shapes = [
        # (B, H, N, F, D): the ViT-B/16 serving shape first
        (32, 12, 197, 266, 64),
        (TRAIN_BATCH, 12, 197, 266, 64),  # the training shape
        (4, 12, 17, 266, 64),    # one ragged q/kv tile
        (4, 12, 130, 266, 64),   # three tiles, the last ragged
        (2, 2, 197, 44, 16),     # the JAX package's kernel-test shape
    ]
    results = {}
    for B, H, N, F, D in shapes:
        for name, dtype in (("bfloat16", torch.bfloat16),
                            ("float32", torch.float32)):
            g = torch.Generator(device="cuda").manual_seed(N * 1000 + F)
            q = (torch.randn(B, H, N, F, generator=g, device="cuda").abs() * 0.1).to(dtype)
            k = (torch.randn(B, H, N, F, generator=g, device="cuda").abs() * 0.1).to(dtype)
            v = torch.randn(B, H, N, D, generator=g, device="cuda").to(dtype)
            c = torch.exp(torch.randn(H, 2 * N - 1, generator=g, device="cuda") * 0.02)
            out, den = mlc.masked_linear_attention_coeffs_fwd(q, k, v, c)
            torch.cuda.synchronize()
            ref_out, ref_den = mlc.masked_linear_attention_coeffs_reference(q, k, v, c)
            rtol, atol = OUT_TOL[name]
            err = (out.float() - ref_out.float()).abs()
            ok_out = bool((err <= atol + rtol * ref_out.float().abs()).all())
            den_rel = ((den - ref_den).abs() / ref_den.abs().clamp_min(1e-30)).max().item()
            finite = bool(torch.isfinite(out.float()).all())
            shape = f"B{B} H{H} N{N} F{F} D{D} {name}"
            log("kernel", f"masked_linear_coeffs_fwd {shape}: max|out err| "
                f"{err.max().item():.3e} (rtol {rtol}, atol {atol}), max den "
                f"rel err {den_rel:.3e} (rtol {DEN_RTOL}), finite {finite}")
            if not (ok_out and den_rel <= DEN_RTOL and finite):
                raise AssertionError(f"kernel disagrees with its plain version at {shape}")
            # timed at the serving shape (both dtypes) and the training shape (bf16)
            if (B, H, N, F, D) in shapes[:2] and (name == "bfloat16" or B != TRAIN_BATCH):
                ms = kernel_ms(lambda: mlc.masked_linear_attention_coeffs_fwd(q, k, v, c))
                plain_ms = time_ms(lambda: mlc.masked_linear_attention_coeffs_reference(q, k, v, c))
                bound_ms, bound_by = kerple_bound(B, H, N, F, D, name)
                log("kernel", f"masked_linear_coeffs_fwd {shape}: kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                    f"kernel/bound {ms / bound_ms:.2f}x")
                results[(name, B)] = dict(max_abs_err=err.max().item(), ms=ms,
                                          plain_ms=plain_ms, bound_ms=bound_ms,
                                          bound_by=bound_by)
    return results


def flash_bound(B, H, N, D, dtype: str):
    """(bound_ms, bound_by) for one flash forward: q, k, v read once, out
    and lse written once; the two products S = q k^T and P v (the softmax's
    exp, max and sums, and the dropout hash, are not counted)."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * 4 * B * H * N * D + 4 * B * H * N
    ops = 2 * 2 * B * H * N * N * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_bwd_bounds(B, H, N, D, dtype: str):
    """{kernel: (bound_ms, bound_by)} for the flash backward kernels: each
    reads q, k, v, g in the input dtype and lse, delta in fp32 once and
    writes its gradients once; products of 2 B H N^2 D operations each:
    S, dP, dv, dk, dq for the fused pass, S, dP, dq for the dq pass, S,
    dP, dv, dk for the dkv pass."""
    elt = 2 if dtype == "bfloat16" else 4
    bhnd, rows = B * H * N * D, 8 * B * H * N
    product = 2 * B * H * N * N * D
    out = {}
    for name, n_out, n_products in (("flash_bwd_fused", 3, 5), ("flash_bwd_dq", 1, 3),
                                    ("flash_bwd_dkv", 2, 4)):
        t_bytes = (elt * bhnd * (4 + n_out) + rows) / HBM_BYTES_PER_S
        t_ops = n_products * product / PEAK_OPS_PER_S[dtype]
        out[name] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def _flash_inputs(B, H, N, D, mask_kind, rate, dtype):
    """q, k, v, cotangent, mask (diagonal kept) and seed for a flash case."""
    g = torch.Generator(device="cuda").manual_seed(N * 100 + D + B)
    q, k, v, cot = (torch.randn(B, H, N, D, generator=g, device="cuda").to(dtype)
                    for _ in range(4))
    mask = None
    if mask_kind is not None:
        hm = 1 if mask_kind == "B1NN" else H
        mask = torch.rand(B, hm, N, N, generator=g, device="cuda") > 0.3
        mask |= torch.eye(N, dtype=torch.bool, device="cuda")  # every row keeps a cell
    seed = torch.tensor([12345], dtype=torch.int32, device="cuda") if rate else None
    return q, k, v, cot, mask, seed


def _sdpa_ms(q, k, v, cot):
    """(forward ms, backward ms) of scaled_dot_product_attention at these
    inputs, from CUDA-graph replays; the backward is the replay of forward
    and backward together less the forward's."""
    fwd_ms = kernel_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg)
        return torch.autograd.grad(out, (qg, kg, vg), cot)

    return fwd_ms, kernel_ms(fwd_bwd) - fwd_ms


def check_flash_keep_mask(fa):
    """The dropout keep-mask the kernels use, read out of their results, is
    dropout_keep_dense's bit for bit. With q = k = 0 every probability is
    1/N, so out[:, :, i, j - c0] = P'[i, j] / l for one-hot values v_j =
    e_(j - c0) over a window of D = 64 columns, and dv[:, :, j, i - c0] =
    P'[i, j] for one-hot cotangents g_i = e_(i - c0) over 64 rows: nonzero
    exactly where the cell is kept. Forward, fused and dkv passes."""
    B, H, N, D, rate = 2, 3, 197, 64, 0.1
    seed = torch.tensor([-7], dtype=torch.int32, device="cuda")
    want = fa.dropout_keep_dense(seed, B, H, N, N, rate)
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        zeros = torch.zeros(B, H, N, D, dtype=dtype, device="cuda")
        got = {"fwd": torch.zeros(B, H, N, N, dtype=torch.bool, device="cuda")}
        got["fused"], got["dkv"] = torch.zeros_like(got["fwd"]), torch.zeros_like(got["fwd"])
        out0, lse0 = fa.flash_attention_fwd(zeros, zeros, zeros, 1.0, None, rate, seed)
        for c0 in range(0, N, D):
            w = min(D, N - c0)
            onehot = torch.zeros(N, D, dtype=dtype, device="cuda")
            onehot[c0:c0 + w, :w] = torch.eye(w, dtype=dtype, device="cuda")
            onehot = onehot.expand(B, H, N, D).contiguous()
            out, _ = fa.flash_attention_fwd(zeros, zeros, onehot, 1.0, None, rate, seed)
            got["fwd"][..., c0:c0 + w] = out[..., :w] != 0
            # rows c0..c0+w of P' through dv = P'^T g
            delta = fa.flash_delta(out0, onehot)
            dv = fa.flash_attention_bwd_fused(zeros, zeros, zeros, onehot, lse0, delta, 1.0,
                                              None, rate, seed)[2]
            got["fused"][..., c0:c0 + w, :] = (dv[..., :w] != 0).transpose(-1, -2)
            dv = fa.flash_attention_bwd_dkv(zeros, zeros, zeros, onehot, lse0, delta, 1.0,
                                            None, rate, seed)[1]
            got["dkv"][..., c0:c0 + w, :] = (dv[..., :w] != 0).transpose(-1, -2)
        torch.cuda.synchronize()
        for kernel, mask in got.items():
            differ = int((mask != want).sum())
            log("kernel", f"dropout keep-mask of {kernel} B{B} H{H} N{N} rate {rate} {name}: "
                f"{differ} of {mask.numel()} cells differ from dropout_keep_dense "
                f"(kept share {mask.float().mean().item():.4f})")
            if differ:
                raise AssertionError(f"{kernel} drops other cells than dropout_keep_dense")


def check_flash_kernels(fa):
    """Phase 3c: the four flash kernels against their plain versions on the
    card. Returns {(kernel, path): row} for the main paths' shapes."""
    check_flash_keep_mask(fa)
    results = {}
    cases = [(c, name, dtype) for c in FLASH_CASES for name, dtype in
             (("bfloat16", torch.bfloat16), ("float32", torch.float32))]
    cases.append((FLASH_LONGN, "bfloat16", torch.bfloat16))
    wrappers = flash_wrappers(fa)
    for (B, H, N, D, mask_kind, rate), name, dtype in cases:
        q, k, v, cot, mask, seed = _flash_inputs(B, H, N, D, mask_kind, rate, dtype)
        scale = D ** -0.5
        shape = f"B{B} H{H} N{N} D{D} mask {mask_kind} dropout {rate} {name}"
        tol = FLASH_TOL[name]
        out, lse = fa.flash_attention_fwd(q, k, v, scale, mask, rate, seed)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_softmax_attention_reference(q, k, v, scale, mask, rate, seed)
        rel = _max_rel(out, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all())
        log("kernel", f"flash_fwd {shape}: out max|err|/max|plain| {rel:.3e} (tol {tol}), "
            f"lse max|err| {lse_err:.3e} (tol {LSE_ATOL}), finite {finite}")
        if not (finite and rel <= tol and lse_err <= LSE_ATOL):
            raise AssertionError(f"flash_fwd disagrees with its plain version at {shape}")
        fwd_err = (out.float() - ref_out.float()).abs().max().item()

        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, cot, scale, mask, rate, seed)
        long_n = (B, H, N, D, mask_kind, rate) == FLASH_LONGN
        # both strategies forced where the fused kernel fits, else its own choice
        fits = fa.fused_fits(N, D, dtype)
        bwd_errs = {}  # fused choice -> max|err| of (dq, dk, dv)
        for fused in ((True, False) if fits else (None,)):
            before = counts(wrappers)
            got = fa.flash_attention_bwd(q, k, v, out, lse, cot, scale, mask, rate, seed,
                                         fused=fused)
            torch.cuda.synchronize()
            ran = {n: c - before[n] for n, c in counts(wrappers).items() if c != before[n]}
            rels = [_max_rel(a, b) for a, b in zip(got, want)]
            finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
            log("kernel", f"flash backward (fused={fused}, launched {ran}) {shape}: (dq, dk, dv) "
                f"max|err|/max|plain| {', '.join(f'{r:.3e}' for r in rels)} (tol {tol}), "
                f"finite {finite}")
            if not (finite and max(rels) <= tol):
                raise AssertionError(f"the flash backward disagrees with its plain version at {shape}")
            bwd_errs[fused] = [(a.float() - b.float()).abs().max().item()
                               for a, b in zip(got, want)]
            if not fits and set(ran) != {"flash_bwd_dq", "flash_bwd_dkv"}:
                raise AssertionError(f"at N={N} D={D} the backward should take the "
                                     f"two-pass split, ran {ran}")
        # timed at the main paths' shapes: serve (B=32) and train (B=64)
        # without dropout, long-N training with dropout 0.1
        path = {(VITB["batch_size"], 197): "baseline_serve",
                (TRAIN_BATCH, 197): "baseline_train",
                (FLASH_LONGN[0], LONGN_N): "baseline_longn_train"}.get((B, N))
        if name != "bfloat16" or mask_kind is not None or path is None:
            continue
        plain_iters = 1 if long_n else 5
        delta = fa.flash_delta(out, cot)
        lib_fwd, lib_bwd = _sdpa_ms(q, k, v, cot)
        log("kernel", f"scaled_dot_product_attention {shape.replace(f'dropout {rate}', 'dropout 0.0')}: "
            f"forward {lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms")
        bwd_bounds = flash_bwd_bounds(B, H, N, D, name)
        bwd_args = (q, k, v, cot, lse, delta, scale, None, rate, seed)
        timed = {"flash_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, scale, None, rate, seed),
            lambda: fa.flash_softmax_attention_reference(q, k, v, scale, None, rate, seed),
            flash_bound(B, H, N, D, name), lib_fwd, fwd_err)}
        if path == "baseline_train":
            timed["flash_bwd_fused"] = (
                lambda: fa.flash_attention_bwd_fused(*bwd_args),
                lambda: fa.flash_bwd_reference(*bwd_args),
                bwd_bounds["flash_bwd_fused"], lib_bwd, max(bwd_errs[True]))
        if path == "baseline_longn_train":
            timed["flash_bwd_dq"] = (
                lambda: fa.flash_attention_bwd_dq(*bwd_args),
                lambda: fa.flash_bwd_reference(*bwd_args)[0],
                bwd_bounds["flash_bwd_dq"], lib_bwd, bwd_errs[None][0])
            timed["flash_bwd_dkv"] = (
                lambda: fa.flash_attention_bwd_dkv(*bwd_args),
                lambda: fa.flash_bwd_reference(*bwd_args)[1:],
                bwd_bounds["flash_bwd_dkv"], lib_bwd, max(bwd_errs[None][1:]))
            no_drop = kernel_ms(lambda: fa.flash_attention_fwd(q, k, v, scale))
            log("kernel", f"flash_fwd {shape.replace(f'dropout {rate}', 'dropout 0.0')}: kernel "
                f"{no_drop:.4f} ms (the dropout hash's share is the difference)")
        for kname, (kernel_fn, plain_fn, (bound_ms, bound_by), library_ms, err) in timed.items():
            ms = kernel_ms(kernel_fn)
            plain_ms = time_ms(plain_fn, iters=plain_iters, warmup=0 if long_n else 1)
            log("kernel", f"{kname} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                f"kernel/bound {ms / bound_ms:.2f}x")
            results[(kname, path)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                          bound_ms=bound_ms, bound_by=bound_by,
                                          library_ms=library_ms)
    return results


# ─── the models' main paths ─────────────────────────────────────────────

def kerple_wrappers(mlc):
    return {"masked_linear_coeffs_fwd": mlc.masked_linear_attention_coeffs_fwd,
            "masked_linear_coeffs_bwd_dq": mlc.masked_linear_attention_coeffs_bwd_dq,
            "masked_linear_coeffs_bwd_dkv": mlc.masked_linear_attention_coeffs_bwd_dkv,
            "masked_linear_coeffs_bwd_dc": mlc.masked_linear_attention_coeffs_bwd_dc,
            "masked_linear_coeffs_bwd_dc_reduce":
                mlc.masked_linear_attention_coeffs_bwd_dc_reduce}


def flash_wrappers(fa):
    return {"flash_fwd": fa.flash_attention_fwd,
            "flash_bwd_fused": fa.flash_attention_bwd_fused,
            "flash_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_bwd_dkv": fa.flash_attention_bwd_dkv}


def counts(wrappers):
    return {name: fn.launches for name, fn in wrappers.items()}


def zero_counts(wrappers) -> None:
    for fn in wrappers.values():
        fn.launches = 0


def serve(phase: str, name: str, arms, wrappers, card: str, profile: bool):
    """ViT-B/16 `name` answers REQUESTS batches through make_eval_step on
    the kernel arm, checked against the dense arm from the same weights.
    `arms` maps "kernel" and "dense" to create_model keyword arguments; the
    first of `wrappers` is the forward kernel, launched once per block per
    forward, and no other may launch. Returns the forward's launch count in
    that run."""
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.train import make_eval_step

    cfg = mnist_config(**VITB)
    t0 = time.perf_counter()
    model = create_model(name, cfg, device="cuda",
                         generator=torch.Generator().manual_seed(0), **arms["kernel"])
    dense = create_model(name, cfg, device="cuda",
                         generator=torch.Generator().manual_seed(0), **arms["dense"])
    dense.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    log(phase, f"ViT-B/16 {name} bf16, {n_params} params, "
        f"built in {time.perf_counter() - t0:.1f} s (set-up)")
    step = make_eval_step(model)
    step_dense = make_eval_step(dense)

    g = torch.Generator(device="cuda").manual_seed(1)
    B = VITB["batch_size"]
    requests = [
        (torch.randn(B, 224, 224, 3, generator=g, device="cuda"),
         torch.randint(0, VITB["num_classes"], (B,), generator=g, device="cuda"))
        for _ in range(REQUESTS)
    ]

    # the main path: counts from 0, read right after
    zero_counts(wrappers)
    answers = [step(x, y) for x, y in requests]
    torch.cuda.synchronize()
    launches = counts(wrappers)
    fwd = next(iter(wrappers))
    expected = {n: VITB["depth"] * REQUESTS if n == fwd else 0 for n in wrappers}
    log(phase, f"{REQUESTS} requests x {B} images answered; kernel launches {launches} "
        f"(expected {expected}: one forward per block per request)")
    if launches != expected:
        raise AssertionError(f"kernels launched {launches}, expected {expected}")
    for loss, correct, preds in answers:
        if not (torch.isfinite(loss) and preds.shape == (B,)):
            raise AssertionError("served a non-finite loss or malformed predictions")

    # correctness: the same weights on the dense arm
    with torch.inference_mode():
        got = torch.cat([model(x) for x, _ in requests])
        want = torch.cat([dense(x) for x, _ in requests])
    dense_preds = torch.cat([step_dense(x, y)[2] for x, y in requests])
    served_preds = torch.cat([p for _, _, p in answers])
    if got.shape != (B * REQUESTS, VITB["num_classes"]) or not torch.isfinite(got).all():
        raise AssertionError(f"logits malformed or non-finite: {tuple(got.shape)}")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    agree = (served_preds == dense_preds).float().mean().item()
    spread = got.std(dim=0).mean().item()
    top2 = want.topk(2, dim=-1).values
    gaps = top2[:, 0] - top2[:, 1]
    log(phase, f"logits vs dense arm: max|diff|/max|logit| {rel:.3e} "
        f"(tol {LOGIT_REL_TOL}), top-1 agreement {agree:.4f} "
        f"(min {MIN_TOP1_AGREEMENT}), mean per-class std over images {spread:.3e}, "
        f"median top-2 gap {gaps.median().item():.3e}")
    for i in (served_preds != dense_preds).nonzero().flatten().tolist():
        log(phase, f"image {i}: top-1 differs; dense top-2 gap {gaps[i].item():.3e}, "
            f"max|diff| of its logits {(got[i] - want[i]).abs().max().item():.3e}")
    if rel > LOGIT_REL_TOL or agree < MIN_TOP1_AGREEMENT:
        raise AssertionError("served logits disagree with the dense arm")
    with torch.inference_mode():
        if not torch.equal(model(requests[0][0]), got[:B]):
            raise AssertionError("served logits changed between two runs")
    log(phase, "served logits are bitwise identical run to run")

    # throughput: host clock around synchronised steps, after warm-up
    for label, fn in (("kernel", step), ("dense", step_dense)):
        for x, y in requests[:2]:
            fn(x, y)
        torch.cuda.synchronize()
        iters = 10
        t0 = time.perf_counter()
        for i in range(iters):
            x, y = requests[i % REQUESTS]
            fn(x, y)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(phase, f"{name} {label} arm: forward {dt / iters * 1e3:.3f} ms/batch "
            f"of {B}, {B * iters / dt:.1f} images/s on {card}")

    if profile:
        profile_step(f"one served batch of {name}", lambda: step(*requests[0]), card)
    return launches[fwd]


def train(phase: str, name: str, cfg_fields, arms, wrappers, per_step, steps: int,
          timed: int, card: str, profile: bool):
    """ViT-B/16 `name` trains `steps` steps through create_train_state /
    make_train_step on the kernel arm, and on the dense arm from the same
    weights where `arms` has one. `per_step` is each wrapper's expected
    launches in one step. Returns the launch counts of the kernel arm's
    main-path run."""
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.train import create_train_state, make_train_step

    torch.cuda.reset_peak_memory_stats()
    cfg = mnist_config(**cfg_fields)
    batch = cfg_fields["batch_size"]
    t0 = time.perf_counter()
    models = {arm: create_model(name, cfg, device="cuda",
                                generator=torch.Generator().manual_seed(0), **kw)
              for arm, kw in arms.items()}
    initial = {k: v.clone() for k, v in models["kernel"].state_dict().items()}
    steps_of = {arm: make_train_step(m) for arm, m in models.items()}
    g = torch.Generator(device="cuda").manual_seed(2)
    size = cfg_fields["image_size"]
    x = torch.randn(batch, size, size, cfg_fields["in_channels"], generator=g, device="cuda")
    y = torch.randint(0, cfg_fields["num_classes"], (batch,), generator=g, device="cuda")
    seq_len = (size // cfg_fields["patch_size"]) ** 2 + 1
    log(phase, f"ViT-B/16 {name} bf16, {size}x{size} images (N={seq_len}), batch {batch}, dropout "
        f"{cfg_fields['dropout']}, optimizer {cfg.train.optimizer} / {cfg.train.scheduler} lr "
        f"{cfg.train.learning_rate}; {len(models)} model(s) built in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")

    def fresh(arm):
        """The arm's model reset to the initial weights, with a new state."""
        models[arm].load_state_dict(initial)
        return create_train_state(models[arm], cfg, steps_per_epoch=100)

    def one_step(arm, state):
        state, loss, _ = steps_of[arm](state, x, y, torch.Generator(device="cuda").manual_seed(3))
        return state, loss

    def grads(arm):
        missing = [n for n, p in models[arm].named_parameters() if p.grad is None]
        if missing:
            raise AssertionError(f"{arm} arm: no gradient reached {missing}")
        return {n: p.grad.detach().clone() for n, p in models[arm].named_parameters()}

    # step 1 on the kernel arm: launch counts, finite gradients
    zero_counts(wrappers)
    one_step("kernel", fresh("kernel"))
    torch.cuda.synchronize()
    got = counts(wrappers)
    log(phase, f"kernel launches in one train step: {got} (expected {per_step})")
    if got != per_step:
        raise AssertionError(f"expected {per_step} launches per step, got {got}")
    g1 = grads("kernel")
    bad = [n for n, t in g1.items() if not bool(torch.isfinite(t).all())]
    if bad:
        raise AssertionError(f"non-finite gradients: {bad}")
    log(phase, f"all {len(g1)} parameter tensors have finite gradients")

    # the main path's run: `steps` steps from the same weights, whose first
    # step must give bitwise the same gradients
    zero_counts(wrappers)
    state, loss = one_step("kernel", fresh("kernel"))
    differ = [n for n, t in grads("kernel").items() if not torch.equal(t, g1[n])]
    if differ:
        raise AssertionError(f"step-1 gradients differ between two runs: {differ}")
    log(phase, "step-1 gradients are bitwise identical across two runs")
    losses = [loss]
    for _ in range(steps - 1):
        state, loss = one_step("kernel", state)
        losses.append(loss)
    torch.cuda.synchronize()
    launches = counts(wrappers)
    expected = {n: c * steps for n, c in per_step.items()}
    log(phase, f"{steps} steps: kernel launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"expected {expected} launches, got {launches}")

    states = {"kernel": state}
    if "dense" in models:
        state_d, loss_d = one_step("dense", fresh("dense"))
        gd = grads("dense")
        rel = {n: ((g1[n].float() - gd[n].float()).norm()
                   / gd[n].float().norm().clamp_min(1e-30)).item() for n in g1}
        worst = max(rel, key=rel.get)
        for n in sorted(rel):
            if "rel_pos_bias" in n or "attention.qkv" in n:
                log(phase, f"  grad {n}: ||kernel - dense|| / ||dense|| {rel[n]:.3e}")
        log(phase, f"step-1 gradients vs dense arm: worst tensor {worst} at "
            f"{rel[worst]:.3e} (tol {GRAD_REL_TOL}); median "
            f"{sorted(rel.values())[len(rel) // 2]:.3e}")
        if rel[worst] > GRAD_REL_TOL:
            raise AssertionError(f"gradient of {worst} disagrees with the dense arm")
        losses_d = [loss_d]
        for _ in range(steps - 1):
            state_d, loss_d = one_step("dense", state_d)
            losses_d.append(loss_d)
        states["dense"] = state_d
        for i, (a, b) in enumerate(zip(losses, losses_d)):
            log(phase, f"step {i + 1}: loss kernel arm {a.item():.6f}, dense arm {b.item():.6f}")
        losses = losses + losses_d
    else:
        for i, a in enumerate(losses):
            log(phase, f"step {i + 1}: loss {a.item():.6f}")
    if not all(bool(torch.isfinite(v)) for v in losses):
        raise AssertionError("a training loss is not finite")

    # time per step: host clock around synchronised steps, after the warm-up above
    for arm in states:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            states[arm], _ = one_step(arm, states[arm])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / timed
        log(phase, f"{name} {arm} arm: {dt * 1e3:.3f} ms/step of {batch} (N={seq_len}), "
            f"{batch / dt:.1f} images/s on {card}")
    log(phase, f"peak device memory in this phase "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_step(f"one train step of {name} (N={seq_len})",
                     lambda: one_step("kernel", states["kernel"]), card)
    del models, states
    return launches


def profile_step(what: str, run, card: str) -> None:
    """Device time by kernel for one call of `run` (torch.profiler); only
    the device-side kernel events are summed, not the operators that
    launched them nor user-annotated ranges (the optimizer's step), which
    overlap the kernels inside them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev, e.count, e.key))
    total = sum(r[0] for r in rows)
    if total == 0:
        log("profile", "the profiler recorded no device time (not measured)")
        return
    log("profile", f"{what}: device busy {total:.1f} us of {wall_us:.1f} us wall "
        f"({100 * total / wall_us:.1f}%) on {card}")
    for dev, count, key in sorted(rows, reverse=True)[:16]:
        log("profile", f"{dev:10.1f} us {100 * dev / total:5.1f}% x{count:<4d} {key[:90]}")
    groups = {}
    for dev, count, key in rows:
        group = next(g for g, hit in PROFILE_GROUPS if hit(key))
        groups[group] = groups.get(group, 0.0) + dev
    for group, dev in sorted(groups.items(), key=lambda kv: -kv[1]):
        log("profile", f"group {group}: {dev:.1f} us ({100 * dev / total:.1f}%)")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="trace one served batch and one train step of each "
                             "model with torch.profiler")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from efficient_rpe_vit_torch.ops.kernels import _build
    from efficient_rpe_vit_torch.ops.kernels import flash_attention as fa
    from efficient_rpe_vit_torch.ops.kernels import masked_linear_coeffs as mlc

    # 1. environment
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("env", "TF32 off for matmuls and cuDNN: fp32 plain versions run in full fp32")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    log("build", f"{len(logs)} CUDA source(s) compiled in "
        f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR.relative_to(ROOT)}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{name}: {line.strip()}")

    # 3. kernels against their plain versions
    kernel = check_kernels(mlc)
    kernel_bwd = check_bwd_kernels(mlc)
    flash = check_flash_kernels(fa)

    # 4. serve and 5. train ViT-B/16 with KERPLE
    depth = VITB["depth"]
    kerple = kerple_wrappers(mlc)
    kerple_arms = {arm: {"rpe_config": {"method": method}}
                   for arm, method in (("kernel", "pallas"), ("dense", "dense"))}
    serve_launches = serve("serve", "performer_favor_most_general", kerple_arms, kerple,
                           card, args.profile)
    train_launches = train("train", "performer_favor_most_general",
                           dict(VITB, batch_size=TRAIN_BATCH), kerple_arms, kerple,
                           {n: depth for n in kerple}, TRAIN_STEPS, TIMED_STEPS, card,
                           args.profile)

    # 6. serve, 7. train and 8. train at long N the softmax baseline
    flash_k = flash_wrappers(fa)
    flash_arms = {arm: {"attention_config": {"method": method}}
                  for arm, method in (("kernel", "flash"), ("dense", "dense"))}
    base_serve = serve("serve-baseline", "baseline", flash_arms, flash_k, card, args.profile)
    base_train = train("train-baseline", "baseline", dict(VITB, batch_size=TRAIN_BATCH),
                       flash_arms, flash_k,
                       {"flash_fwd": depth, "flash_bwd_fused": depth,
                        "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
                       TRAIN_STEPS, TIMED_STEPS, card, args.profile)
    base_longn = train("longn-baseline", "baseline", LONGN,
                       {"kernel": flash_arms["kernel"]}, flash_k,
                       {"flash_fwd": depth, "flash_bwd_fused": 0,
                        "flash_bwd_dq": depth, "flash_bwd_dkv": depth},
                       LONGN_STEPS, LONGN_TIMED, card, args.profile)

    # one row per kernel and main path: its launches in that path's run, its
    # times at that path's shape
    pallas = "efficient_rpe_vit_tpu/ops/pallas"
    src = "efficient_rpe_vit_torch/csrc"
    mlc_tpu = f"{pallas}/masked_linear_coeffs.py"
    fwd = ("masked_linear_coeffs_fwd", f"{src}/masked_linear_coeffs_fwd.cu", f"{mlc_tpu}:140")
    rows = [(*fwd, "serve", kernel[("bfloat16", VITB["batch_size"])], serve_launches),
            (*fwd, "train", kernel[("bfloat16", TRAIN_BATCH)],
             train_launches["masked_linear_coeffs_fwd"])]
    for name, line in zip(BWD_KERNELS, (227, 258, 301, 343)):
        rows.append((name, f"{src}/masked_linear_coeffs_bwd.cu", f"{mlc_tpu}:{line}",
                     "train", kernel_bwd[name], train_launches[name]))
    flash_fwd = ("flash_fwd", f"{src}/flash_attention_fwd.cu",
                 f"{pallas}/attention_kernels.py:354")
    rows += [(*flash_fwd, "baseline_serve", flash[("flash_fwd", "baseline_serve")], base_serve),
             (*flash_fwd, "baseline_train", flash[("flash_fwd", "baseline_train")],
              base_train["flash_fwd"]),
             (*flash_fwd, "baseline_longn_train", flash[("flash_fwd", "baseline_longn_train")],
              base_longn["flash_fwd"])]
    for name, line, path, launches in (
            ("flash_bwd_fused", 197, "baseline_train", base_train),
            ("flash_bwd_dq", 71, "baseline_longn_train", base_longn),
            ("flash_bwd_dkv", 129, "baseline_longn_train", base_longn)):
        rows.append((name, f"{src}/flash_attention_bwd.cu", f"{pallas}/flash_bwd.py:{line}",
                     path, flash[(name, path)], launches[name]))
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "path": path,
        "launches": launches,
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row.get("library_ms"),
    } for name, source, replaces, path, row, launches in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
