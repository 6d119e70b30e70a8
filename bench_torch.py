#!/usr/bin/env python3
"""Training-throughput benchmark of the PyTorch port on one NVIDIA GPU.

    python3 bench_torch.py

The rows of the JAX package's `bench.py`, on the port:
  * `bench_headline`: performer_favor_most_general (FAVOR+ with KERPLE) at
    the reference's benchmarked configuration, mnist_config at patch 2
    (N = 197), batch 256, bf16, dropout 0.1; K = 25 train steps per
    `make_multi_step` call (one CUDA-graph replay), 2 warm-up and 8 timed
    calls. Images/s against the reference's 650 images/s (the midpoint of
    the 500-800 it reports on a GPU), MFU, and the host-clock ms per step
    of the replayed and of the eager `make_train_step` step at this shape;
  * `vitb_kerple` and `vitb_kerple_mxu`: the same model at ViT-B widths
    (dim 768, depth 12, 12 heads, mlp 3072, N = 197 from 28x28 at patch 2,
    bf16, batch 64, dropout 0), 20 eager `make_train_step` steps after 3,
    at F = 266 and at num_features="mxu" (F = 256).
FLOPs per step are counted from the shapes (`train_flops_per_step`: no
profiler sees the ctypes kernels) and MFU divides them by the dense bf16
peak of the card that ran, chosen by its name (`PEAK_BF16` of
`efficient_rpe_vit_torch/utils/timing.py`). Every row
carries the card's name and power limit as nvidia-smi prints them.

Output contract: exactly one JSON line on stdout, on every exit path
(normal completion, an exception, SIGTERM / SIGINT, the watchdog); progress
goes to stderr. There is no CPU fallback: without a GPU the line carries
"error" and no rate, and the exit code is 0.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_IMAGES_PER_SEC = 650.0  # the reference's 500-800 img/s midpoint, on a GPU
BATCH = 256
FUSED_K = 25
WARMUP_CALLS = 2
TIMED_CALLS = 8
EAGER_WARMUP, EAGER_STEPS = 3, 25
VITB_BATCH, VITB_WARMUP, VITB_STEPS = 64, 3, 20
WATCHDOG_S = 1500

# the line printed on exit, filled in as measurements land
RESULT = {"metric": "kerple_train_throughput_seq197_bs256",
          "unit": "images/sec/gpu", "backend": "unavailable"}
_EMITTED = False


def log(msg: str) -> None:
    print(f"[bench_torch {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def emit_and_exit(rc: int = 0) -> None:
    """Print the one JSON line (once) and exit without interpreter teardown."""
    global _EMITTED
    if not _EMITTED:
        _EMITTED = True
        sys.stdout.write(json.dumps(RESULT) + "\n")
        sys.stdout.flush()
    os._exit(rc)


def _on_signal(signum, frame):
    RESULT["partial"] = True
    RESULT["exit_reason"] = f"signal_{signum}"
    log(f"caught signal {signum}; emitting the best-known result")
    emit_and_exit(0)


def train_flops_per_step(model_cfg, num_features: int, batch: int) -> int:
    """FLOPs of one train step of performer_favor_most_general: the forward
    (2 per multiply-add) times 3, the backward counted as twice the
    forward. Per block: the fused QKV, phi's projections x @ Omega of q and
    k, the KERPLE products q' k'^T (N x N x F) and W v (N x N x D), the
    output projection and the two MLP GEMMs; plus the patch embedding and
    the head. Elementwise work is not counted."""
    m = model_cfg
    n, d, h = m.seq_len, m.dim, m.heads
    hd = d // h
    block = (2 * n * d * 3 * d
             + 2 * 2 * h * n * hd * num_features
             + 2 * h * n * n * num_features
             + 2 * h * n * n * hd
             + 2 * n * d * d
             + 2 * 2 * n * d * m.mlp_dim)
    forward = batch * (m.depth * block + 2 * m.num_patches * m.patch_dim * d
                       + 2 * d * m.num_classes)
    return 3 * forward


def _barrier(state, loss) -> float:
    """A host read of the loss that also depends on a parameter: it waits
    for the last step's backward and update, not only its forward."""
    leaf = next(state.model.parameters())
    return float(loss.float().sum() + 0.0 * leaf.detach().float().sum())


def _mfu(flops: int, seconds_per_step: float, peak):
    return None if peak is None else flops / seconds_per_step / peak


def bench_headline(torch, peak) -> None:
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.train import (create_train_state, make_multi_step,
                                               make_train_step)

    cfg = mnist_config(patch_size=2, batch_size=BATCH, compute_dtype="bfloat16")
    m = cfg.model
    model = create_model("performer_favor_most_general", cfg,
                         generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, steps_per_epoch=100)
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn(BATCH, m.image_size, m.image_size, m.in_channels, generator=g,
                         device="cuda")
    labels = torch.arange(BATCH, device="cuda") % m.num_classes
    images_k = images.expand(FUSED_K, *images.shape).contiguous()
    labels_k = labels.expand(FUSED_K, BATCH).contiguous()
    multi = make_multi_step(model)

    log(f"headline: warm-up ({WARMUP_CALLS} calls of {FUSED_K} steps: the first runs them "
        "eagerly and captures the graph)")
    for _ in range(WARMUP_CALLS):
        state, losses, _ = multi(state, images_k, labels_k, g)
    _barrier(state, losses)
    t0 = time.perf_counter()
    for _ in range(TIMED_CALLS):
        state, losses, _ = multi(state, images_k, labels_k, g)
    _barrier(state, losses)
    elapsed = time.perf_counter() - t0
    steps = FUSED_K * TIMED_CALLS
    images_per_sec = BATCH * steps / elapsed

    step = make_train_step(model)
    for _ in range(EAGER_WARMUP):
        state, loss, _ = step(state, images, labels, g)
    _barrier(state, loss)
    t0 = time.perf_counter()
    for _ in range(EAGER_STEPS):
        state, loss, _ = step(state, images, labels, g)
    _barrier(state, loss)
    eager_s = (time.perf_counter() - t0) / EAGER_STEPS

    num_features = model.transformer_blocks[0].attention.m
    flops = train_flops_per_step(m, num_features, BATCH)
    RESULT.update({
        "value": images_per_sec,
        "vs_baseline": images_per_sec / BASELINE_IMAGES_PER_SEC,
        "replay_step_ms": elapsed / steps * 1e3,
        "eager_step_ms": eager_s * 1e3,
        "eager_images_per_sec": BATCH / eager_s,
        "fused_k": FUSED_K,
        "attention_shape_bhnfd": [BATCH, m.heads, m.seq_len, num_features,
                                  m.dim // m.heads],
        "flops_per_step": flops,
        "mfu": _mfu(flops, elapsed / steps, peak),
    })
    log(f"headline: {images_per_sec:.1f} images/s replayed ({elapsed / steps * 1e3:.3f} "
        f"ms/step), eager {eager_s * 1e3:.3f} ms/step, "
        f"{RESULT['vs_baseline']:.2f}x the reference")


def bench_vitb_kerple(torch, peak, label: str, num_features=None, tag: str = "") -> None:
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.train import create_train_state, make_train_step

    cfg = mnist_config(image_size=28, patch_size=2, batch_size=VITB_BATCH, dim=768,
                       depth=12, heads=12, mlp_dim=3072, dropout=0.0,
                       compute_dtype="bfloat16")
    m = cfg.model
    attn_cfg = {"num_features": num_features} if num_features else None
    model = create_model("performer_favor_most_general", cfg, attention_config=attn_cfg,
                         generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, steps_per_epoch=100)
    step = make_train_step(model)
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn(VITB_BATCH, m.image_size, m.image_size, m.in_channels,
                         generator=g, device="cuda")
    labels = torch.arange(VITB_BATCH, device="cuda") % m.num_classes
    log(f"vitb{tag}: warm-up")
    for _ in range(VITB_WARMUP):
        state, loss, _ = step(state, images, labels, g)
    _barrier(state, loss)
    t0 = time.perf_counter()
    for _ in range(VITB_STEPS):
        state, loss, _ = step(state, images, labels, g)
    _barrier(state, loss)
    step_s = (time.perf_counter() - t0) / VITB_STEPS
    f = model.transformer_blocks[0].attention.m
    flops = train_flops_per_step(m, f, VITB_BATCH)
    row = {"metric": f"vitb_kerple_train_seq197_bs64_bf16{tag}",
           "images_per_sec": VITB_BATCH / step_s, "step_ms": step_s * 1e3,
           "num_features": f, "flops_per_step": flops,
           "mfu": _mfu(flops, step_s, peak), "card": label}
    RESULT[f"vitb_kerple{tag}"] = row
    log(f"vitb{tag}: {row['images_per_sec']:.1f} images/s, {row['step_ms']:.3f} ms/step, "
        f"MFU {row['mfu']}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        RESULT["error"] = ("no CUDA device is available; the benchmark has no CPU "
                           "fallback")
        log(RESULT["error"])
        emit_and_exit(0)
    from efficient_rpe_vit_torch.utils.timing import PEAK_BF16, device_label

    name = torch.cuda.get_device_name(0)
    label = device_label(torch.device("cuda"))
    peak = PEAK_BF16.get(name)
    RESULT.update({"backend": "cuda", "device": {"name": name, "card": label,
                                                 "count": torch.cuda.device_count()},
                   "peak_bf16_flops": peak, "torch": torch.__version__})
    log(f"{label}; torch {torch.__version__}; dense bf16 peak {peak}")
    for what, run in (("headline", lambda: bench_headline(torch, peak)),
                      ("vitb_kerple", lambda: bench_vitb_kerple(torch, peak, label)),
                      ("vitb_kerple_mxu", lambda: bench_vitb_kerple(
                          torch, peak, label, num_features="mxu", tag="_mxu"))):
        try:
            run()
        except Exception as e:  # the line must still be printed
            msg = f"{type(e).__name__}: {str(e)[:200]}"
            log(f"{what} FAILED: {msg}")
            if what == "headline":
                RESULT["error"] = f"headline: {msg}"
            else:
                RESULT[what] = {"error": msg}
    emit_and_exit(0)


if __name__ == "__main__":
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGALRM, _on_signal)
    signal.alarm(WATCHDOG_S)
    try:
        main()
    except Exception as e:  # never exit without the line
        log(f"fatal: {type(e).__name__}: {str(e)[:300]}")
        RESULT["error"] = f"fatal: {type(e).__name__}: {str(e)[:200]}"
        emit_and_exit(0)
