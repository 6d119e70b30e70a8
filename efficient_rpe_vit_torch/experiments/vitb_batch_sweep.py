#!/usr/bin/env python
"""Batch sweep of the ViT-B KERPLE MFU row, on one card.

Counterpart of `experiments/vitb_batch_sweep.py` (the JAX package's), with
its batches, protocol and JSON keys: `performer_favor_most_general` at
ViT-B widths (dim 768, depth 12, 12 heads, mlp 3072), N=197 (28x28 at
patch 2), bf16, dropout 0, the full train step (forward, backward, Adam)
at batch 64, 128 and 256 (20, 16 and 12 timed steps after one counted
step and 3 warm-ups), then K=8 steps per `make_multi_step` call (one
CUDA-graph replay of 8 steps; 2 warm-up calls, the first of which runs the
8 steps eagerly and captures them, then 3 timed calls) at the batch with
the most images/s, which is the batch with the best MFU (a step's FLOPs
grow with the batch in proportion). Each run is closed by one host read of
the loss that also depends on a parameter.

FLOPs as in `vitbase_bench.py`: the eager step counted by FlopCounterMode
(`flops_per_step_counted`) plus the kernels' analytic FLOPs
(`pallas_attention_flops`). Unlike the JAX sweep, whose N=197 KERPLE path
is plain XLA that its cost analysis counts whole, the port runs the KERPLE
kernels #1 and #2 at N=197 (`KERPLE_DENSE_CROSSOVER_N = 0`), whose FLOPs
no counter sees, so they are added. MFU divides by the dense bf16 peak of
the card that ran (`utils/timing.py` `PEAK_BF16`), null elsewhere. Each
row also holds its launches (`launches`: the whole row; per timed step,
which is 0 for the replays of the fused row) and the peak device memory
of its timed steps (of the fused row: from its warm-up on, since the
graph's memory is allocated when it is captured). A batch that fails (out
of memory) is a row with `error`. With `--out` the JSON is written there
after each row, so a killed run keeps its rows; it is printed at the end.

    python -m efficient_rpe_vit_torch.experiments.vitb_batch_sweep \\
        [--batches 64 128 256] [--out FILE]

It runs on the GPU unless `--device cpu` is given, and raises without one;
the first line printed is the card's name and power limit, progress goes
to stderr. `--width DIM DEPTH HEADS MLP` (default ViT-B's) is for the CPU
tests.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import ab_steps, vitbase_bench
from .ab_steps import chain_barrier

VARIANT = "performer_favor_most_general"
# (batch, timed steps)
BATCHES = [(64, 20), (128, 16), (256, 12)]
FUSED_K = 8
FUSED_STEPS = 24
WARMUP = 3


def log(msg):
    print(f"[sweep {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def bench_batch(batch: int, steps: int, fused_k=None, device=None, widths=None) -> dict:
    """One row in the JAX sweep's keys: eager steps at `batch`
    (`vitbase_bench.bench_one`'s protocol), or with `fused_k` K steps per
    make_multi_step call (max(2, steps // K) timed calls after 2)."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    if fused_k:
        r = _fused(batch, steps, fused_k, device, widths)
    else:
        log(f"B={batch}: a counted step, {WARMUP} warm-ups, {steps} timed steps...")
        r = vitbase_bench.bench_one(VARIANT, 28, 2, batch, steps, WARMUP, device=device,
                                    widths=widths)
    row = {
        "batch": batch,
        "fused_k": fused_k,
        "timed_steps": r["timed_steps"],
        "step_ms": round(r["step_ms"], 3),
        "images_per_sec": round(r["images_per_sec"], 1),
        "flops_per_step_counted": r["flops_per_step_counted"],
        "pallas_attention_flops": r.get("pallas_attention_flops", 0.0),
        "flops_per_step": r["flops_per_step"],
        "mfu": None if r["mfu"] is None else round(r["mfu"], 5),
        **{k: r[k] for k in ("launches", "launches_per_step", "peak_bytes_in_use")},
    }
    log(f"B={batch} fused_k={fused_k}: {row['step_ms']} ms/step, "
        f"{row['images_per_sec']} img/s, MFU {row['mfu']}")
    return row


def _fused(batch: int, steps: int, fused_k: int, device, widths) -> dict:
    """`vitbase_bench.timed_row` of `fused_k` steps per make_multi_step call
    (one CUDA-graph replay on the card) after the counted eager step."""
    from ..train import make_multi_step

    before = ab_steps.launch_counts()
    cfg, model, state, one_step, images, labels, generator = vitbase_bench.setup(
        VARIANT, 28, 2, batch, device=device, widths=widths)
    counted, state, loss = vitbase_bench.counted_step(one_step, state, images, labels,
                                                      generator)
    multi_step = make_multi_step(model, device=device)
    images_k = images.expand(fused_k, *images.shape).contiguous()
    labels_k = labels.expand(fused_k, batch).contiguous()
    calls = max(2, steps // fused_k)
    log(f"B={batch} fused K={fused_k}: warm-up (the first call runs the steps and "
        "captures them)...")
    if device.type == "cuda":  # the graph's memory is allocated at its capture
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(2):
        state, losses, _ = multi_step(state, images_k, labels_k, generator)
    chain_barrier(state, losses[-1])
    log(f"B={batch} fused: warm; timing {calls} calls x {fused_k}...")
    timed = ab_steps.launch_counts()
    t0 = time.perf_counter()
    for _ in range(calls):
        state, losses, _ = multi_step(state, images_k, labels_k, generator)
    chain_barrier(state, losses[-1])
    elapsed = time.perf_counter() - t0
    return vitbase_bench.timed_row(VARIANT, cfg.model, batch, calls * fused_k, elapsed,
                                   counted, None, device, ab_steps.launches_since(before),
                                   ab_steps.launches_since(timed))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON to this file")
    ap.add_argument("--batches", type=int, nargs="+", default=[b for b, _ in BATCHES],
                    choices=[b for b, _ in BATCHES], help="the batches to run (default: all)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU; default: the GPU (raises without one)")
    ab_steps.width_flag(ap)
    args = ap.parse_args(argv)
    device, card = ab_steps.start(args)
    w = ab_steps.widths(args)

    def dump(rows):
        if not args.out:
            return
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"backend": card, "rows": rows}, f, indent=1)

    rows = []
    for batch, steps in BATCHES:
        if batch not in args.batches:
            continue
        try:
            rows.append(bench_batch(batch, steps, device=device, widths=w))
        except Exception as e:  # the row records the failure, as the JAX sweep does
            log(f"B={batch} FAILED: {type(e).__name__}: {str(e)[:200]}")
            rows.append({"batch": batch, "error": f"{type(e).__name__}: {str(e)[:200]}"})
        finally:
            ab_steps.release()
        dump(rows)  # after each row, so that a killed run keeps its rows

    best = max((r for r in rows if "error" not in r), key=lambda r: r["images_per_sec"],
               default=None)
    if best is not None:
        try:
            rows.append(bench_batch(best["batch"], FUSED_STEPS, fused_k=FUSED_K, device=device,
                                    widths=w))
        except Exception as e:
            log(f"fused FAILED: {type(e).__name__}: {str(e)[:200]}")
            rows.append({"batch": best["batch"], "fused_k": FUSED_K,
                         "error": f"{type(e).__name__}: {str(e)[:200]}"})
        finally:
            ab_steps.release()
    dump(rows)
    result = {"backend": card, "rows": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
