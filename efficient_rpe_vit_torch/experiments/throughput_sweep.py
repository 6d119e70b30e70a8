#!/usr/bin/env python
"""Per-variant training throughput (images/s on one card) of all 11
variants: chained full train steps on CIFAR-10- or MNIST-shaped synthetic
inputs in bf16.

Counterpart of `experiments/throughput_sweep.py` (the JAX package's
sweep), with its variants, flags, protocol and JSON keys: the config's
model at `batch_size` and `compute_dtype="bfloat16"`, `make_train_step`
on normal inputs with labels arange(B) % classes, 5 warm-up steps, then
the median of 3 runs of `--steps` chained steps, each run closed by one
host read of the loss that also waits for the last update. In place of
the JAX backend name the JSON holds the card's name and power limit
(`card`, as nvidia-smi gives them).

    python -m efficient_rpe_vit_torch.experiments.throughput_sweep \\
        [--dataset cifar10] [--batch 256] [--steps 60] [--out sweep.json]

It runs on the GPU and raises without one; `bench_variant(...,
device="cpu")` runs one variant on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

VARIANTS = [
    "baseline", "baseline_circulant", "baseline_rope",
    "performer_favor", "performer_favor_most_general",
    "performer_favor_circulant", "performer_favor_rope",
    "performer_relu", "performer_relu_most_general",
    "performer_relu_circulant", "performer_relu_rope",
]
WARMUP = 5
RUNS = 3


def bench_variant(name: str, dataset: str, batch: int, steps: int, device=None):
    """(images/s, seconds per step) of `name`'s train step: the median of
    RUNS chains of `steps` steps after WARMUP steps."""
    from ..configs import cifar10_config, mnist_config
    from ..models import create_model
    from ..train import create_train_state, make_train_step
    from ..utils.device import resolve_device
    from .ab_steps import chain_barrier

    device = resolve_device(device)
    cfg = (mnist_config if dataset == "mnist" else cifar10_config)(
        batch_size=batch, compute_dtype="bfloat16")
    m = cfg.model
    model = create_model(name, cfg, device=device, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, steps_per_epoch=100)
    step = make_train_step(model, device=device)
    data = torch.Generator(device).manual_seed(0)
    images = torch.randn((batch, m.image_size, m.image_size, m.in_channels), generator=data,
                         device=device)
    labels = torch.arange(batch, device=device) % m.num_classes
    generator = torch.Generator(device).manual_seed(1)

    for _ in range(WARMUP):
        state, loss, _ = step(state, images, labels, generator)
    chain_barrier(state, loss)
    times = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss, _ = step(state, images, labels, generator)
        chain_barrier(state, loss)
        times.append((time.perf_counter() - t0) / steps)
    step_s = sorted(times)[RUNS // 2]
    return batch / step_s, step_s


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def sweep(dataset: str, batch: int, steps: int, card: str, device=None,
          verbose: bool = True):
    """Every variant's row: the JSON the sweep writes, `card` naming the
    device it ran on."""
    results = {"dataset": dataset, "batch": batch, "card": card,
               "protocol": "chained value-fetch, median of 3 x "
                           f"{steps} steps, bf16",
               "variants": {}}
    if verbose:
        print(f"| variant | img/s | ms/step | ({dataset}, bs {batch}, {card}) |")
        print("|---|---|---|---|")
    for name in VARIANTS:
        ips, step_s = bench_variant(name, dataset, batch, steps, device)
        results["variants"][name] = {
            "images_per_sec": round(ips, 1),
            "ms_per_step": round(step_s * 1e3, 3),
        }
        if verbose:
            print(f"| {name} | {ips:,.0f} | {step_s * 1e3:.2f} | |", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="cifar10", choices=["mnist", "cifar10"])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from ..utils.device import resolve_device

    resolve_device(None)  # the card, or the device error
    results = sweep(args.dataset, args.batch, args.steps, card_name())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        print(f"written to {args.out}")
    return results


if __name__ == "__main__":
    main()
