#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # what CI runs: build, check, serve
    python3 chip_smoke.py --profile  # also trace one served batch

Phases, each printed as it runs; any failure exits non-zero:
  1. environment: versions, the card's name and power limit, TF32 off;
  2. build: every CUDA source under efficient_rpe_vit_torch/csrc, with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the serving shape and at ragged shapes, timed beside its bound;
  4. serve: ViT-B/16 performer_favor_most_general (bf16, random weights from
     a seed) answers 4 requests of 32 images through `make_eval_step`; the
     kernel launch counts of that run are checked, and the logits are held
     against the same model on the plain (dense) KERPLE path.
The line before the last lists every kernel as JSON; the last line is
{"ok": true, "device": {...}}. Without a GPU, or without the rest of the
repository beside it, the script fails before printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

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

# served logits, pallas vs dense path, both bf16: the two paths round
# different fp32 sums to bf16 in each of 12 blocks; allow 5% of the logit
# range, and require >= 99% top-1 agreement.
LOGIT_REL_TOL = 5e-2
MIN_TOP1_AGREEMENT = 0.99

VITB = dict(image_size=224, patch_size=16, in_channels=3, num_classes=1000,
            dim=768, depth=12, heads=12, mlp_dim=3072, dropout=0.0,
            compute_dtype="bfloat16", batch_size=32)
REQUESTS = 4


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


def check_kernels(mlc):
    """Phase 3: the KERPLE kernel against its plain version on the card."""
    shapes = [
        # (B, H, N, F, D): the ViT-B/16 serving shape first
        (32, 12, 197, 266, 64),
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
            if (B, H, N, F, D) == shapes[0]:
                ms = time_ms(lambda: mlc.masked_linear_attention_coeffs_fwd(q, k, v, c))
                plain_ms = time_ms(lambda: mlc.masked_linear_attention_coeffs_reference(q, k, v, c))
                bound_ms, bound_by = kerple_bound(B, H, N, F, D, name)
                log("kernel", f"masked_linear_coeffs_fwd {shape}: kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                    f"kernel/bound {ms / bound_ms:.2f}x")
                results[name] = dict(max_abs_err=err.max().item(), ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=bound_by)
    return results


def serve(mlc, card: str, profile: bool):
    """Phase 4: ViT-B/16 answers REQUESTS batches through make_eval_step.
    Returns the kernel's launch count in that run."""
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.train import make_eval_step

    cfg = mnist_config(**VITB)
    t0 = time.perf_counter()
    model = create_model("performer_favor_most_general", cfg,
                         rpe_config={"method": "pallas"}, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    dense = create_model("performer_favor_most_general", cfg,
                         rpe_config={"method": "dense"}, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    dense.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    log("serve", f"ViT-B/16 performer_favor_most_general bf16, {n_params} params, "
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
    mlc.masked_linear_attention_coeffs_fwd.launches = 0
    answers = [step(x, y) for x, y in requests]
    torch.cuda.synchronize()
    launches = mlc.masked_linear_attention_coeffs_fwd.launches
    expected = VITB["depth"] * REQUESTS
    log("serve", f"{REQUESTS} requests x {B} images answered; "
        f"masked_linear_coeffs_fwd launches {launches} (expected {expected}: "
        f"one per block per forward)")
    if launches != expected:
        raise AssertionError(f"kernel launched {launches} times, expected {expected}")
    for loss, correct, preds in answers:
        if not (torch.isfinite(loss) and preds.shape == (B,)):
            raise AssertionError("served a non-finite loss or malformed predictions")

    # correctness: the same weights on the plain KERPLE path
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
    log("serve", f"logits vs dense path: max|diff|/max|logit| {rel:.3e} "
        f"(tol {LOGIT_REL_TOL}), top-1 agreement {agree:.4f} "
        f"(min {MIN_TOP1_AGREEMENT}), mean per-class std over images {spread:.3e}, "
        f"median top-2 gap {gaps.median().item():.3e}")
    for i in (served_preds != dense_preds).nonzero().flatten().tolist():
        log("serve", f"image {i}: top-1 differs; dense top-2 gap {gaps[i].item():.3e}, "
            f"max|diff| of its logits {(got[i] - want[i]).abs().max().item():.3e}")
    if rel > LOGIT_REL_TOL or agree < MIN_TOP1_AGREEMENT:
        raise AssertionError("served logits disagree with the dense path")
    with torch.inference_mode():
        if not torch.equal(model(requests[0][0]), got[:B]):
            raise AssertionError("served logits changed between two runs")
    log("serve", "served logits are bitwise identical run to run")

    # throughput: host clock around synchronised steps, after warm-up
    for label, fn in (("pallas", step), ("dense", step_dense)):
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
        log("serve", f"{label} KERPLE path: forward {dt / iters * 1e3:.3f} ms/batch "
            f"of {B}, {B * iters / dt:.1f} images/s on {card}")

    if profile:
        profile_step(step, requests[0], card)
    return launches


def profile_step(step, request, card: str) -> None:
    """Device time by kernel for one served batch (torch.profiler); only
    the device-side kernel events are summed, not the operators that
    launched them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, y = request
    step(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
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
    log("profile", f"one batch: device busy {total:.1f} us of {wall_us:.1f} us wall "
        f"({100 * total / wall_us:.1f}%) on {card}")
    for dev, count, key in sorted(rows, reverse=True)[:12]:
        log("profile", f"{dev:10.1f} us {100 * dev / total:5.1f}% x{count:<4d} {key[:90]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="trace one served batch with torch.profiler")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from efficient_rpe_vit_torch.ops.kernels import _build
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

    # 4. serve ViT-B/16
    main_path_launches = serve(mlc, card, args.profile)

    row = kernel["bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "masked_linear_coeffs_fwd",
        "route": "cuda",
        "source": "efficient_rpe_vit_torch/csrc/masked_linear_coeffs_fwd.cu",
        "replaces": "efficient_rpe_vit_tpu/ops/pallas/masked_linear_coeffs.py:140",
        "launches": main_path_launches,
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
