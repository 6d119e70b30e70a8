#!/usr/bin/env python
"""ViT-Base-scale training benchmark with an MFU per row, on one card.

Counterpart of `experiments/vitbase_bench.py` (the JAX package's), with its
shapes, variants, flags, protocol and JSON keys: the full train step
(forward, backward, Adam) at ViT-B widths (dim 768, 12 heads, head dim 64,
mlp 3072, depth 12), bf16, dropout 0, at N = 197 / 1025 / 4097 (28, 64 and
128 pixel images at patch 2) and batch 64 / 16 / 4, for

  * baseline                      softmax attention (`auto`: the flash
                                  kernels #6 and 7a at N=197, #6 and 7b past
                                  N=208),
  * performer_favor               FAVOR+ linear attention (F = 266), no
                                  kernel,
  * performer_favor_most_general  KERPLE (`auto`: the KERPLE kernels #1 and
                                  #2 at every N on the H100).

Protocol: one counted step, 3 warm-up steps, then the timed chain of
steps, closed by one host read of the loss that also depends on a
parameter (it waits for the last update).

FLOPs. `flops_per_step_counted` counts one eager `make_train_step` call
with `torch.utils.flop_counter.FlopCounterMode`, the port's counterpart of
the JAX `flops_per_step_xla` (XLA's cost analysis; the `_xla` keys are
renamed `_counted`, every other key is the JAX one). Like XLA's count it
does not see the hand-written kernels (a ctypes launch or a `torch.library`
kernel op has no FLOP formula and counts 0), so `pallas_attention_flops`
adds their analytic FLOPs, gated by the port's own `auto` rules:
`flops_per_step` is the sum. MFU divides FLOPs per second by the dense
bf16 peak of the card that ran, chosen by its name (`utils/timing.py`
`PEAK_BF16`); another card or the CPU gets a null MFU. Each row also
holds its kernel launches (`launches`: the whole row, `launches_per_step`:
the timed steps) and the timed steps' peak device memory.

    python -m efficient_rpe_vit_torch.experiments.vitbase_bench \\
        [--steps-scale 1.0] [--variants ...] [--shapes N=197 ...] \\
        [--remat] [--num-features 266|mxu] [--out FILE]

It runs on the GPU unless `--device cpu` is given, and raises without one;
the first line printed is the card's name and power limit. `--width DIM
DEPTH HEADS MLP` (default ViT-B's) is for the CPU tests. The result is
printed as the last line and, with `--out`, written there.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from . import ab_steps
from ..utils.timing import device_memory_stats, peak_bf16

# (label, image_size, patch_size, N, batch, timed_steps)
SHAPES = [
    ("N=197", 28, 2, 197, 64, 20),
    ("N=1025", 64, 2, 1025, 16, 10),
    ("N=4097", 128, 2, 4097, 4, 5),
]

VARIANTS = ["baseline", "performer_favor", "performer_favor_most_general"]
WARMUP = 3


def pallas_attention_flops(variant: str, B: int, H: int, N: int, D: int,
                           depth: int, num_features) -> float:
    """Analytic FLOPs of the hand-written attention kernels in one train
    step of `variant` at [B, H, N, D] (the JAX function of the same name,
    gated by the port's rules): no FLOP counter sees them.

    Counts true (unpadded) matmul FLOPs:
      * flash softmax: forward S and PV, 2 products; backward S, dP, dv,
        dq, dk, 5 -> 7 * 2*B*H*N^2*D per layer, where softmax's `auto`
        takes flash (`softmax_needs_flash`);
      * KERPLE over coefficients: forward q'k'^T (F) and W v (D); backward
        2 + 4 + 2 -> 5 * 2*B*H*N^2*(F+D) per layer, where KERPLE's `auto`
        takes the kernel (`kerple_arm`);
      * Circulant-STRING rotation: forward 4 DFT contractions per q and k
        call, backward 6 -> (16+24)*B*H*N*D*K per layer with K = D//2 + 1,
        where the rotation's `auto` takes the kernels (`prefer_kernel`:
        flash after it, or phi under `KERNEL_BEFORE_PHI`).
    Returns 0 for a variant that runs no kernel.
    """
    from ..models.attention import rotation_prefers_kernel
    from ..ops import attention_core, rotations
    from ..ops.feature_maps import default_num_features, mxu_num_features

    total = 0.0
    softmax = variant.startswith("baseline") or variant == "vit"
    flash = softmax and attention_core.softmax_needs_flash(B, H, N)
    consumer_is_kernel = flash if softmax else rotations.KERNEL_BEFORE_PHI
    if "circulant" in variant and rotations._resolve(
            "auto", rotation_prefers_kernel(None, consumer_is_kernel)) == "pallas":
        K = D // 2 + 1
        total += depth * (16.0 + 24.0) * B * H * N * D * K
    if softmax:
        if flash:
            total += depth * 7.0 * 2 * B * H * N * N * D
        return total
    if "most_general" in variant and attention_core.kerple_arm(B, H, N) == "pallas":
        if num_features == "mxu":
            F = mxu_num_features(D)
        elif num_features is not None:
            F = int(num_features)
        else:
            F = default_num_features(D)
        total += depth * 5.0 * 2 * B * H * N * N * (F + D)
    return total


def counted_step(step, state, images, labels, generator):
    """One eager train step under FlopCounterMode: (its counted FLOPs,
    state, loss). Only an eager step is ever counted, never a CUDA-graph
    replay."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        state, loss, _ = step(state, images, labels, generator)
    return counter.get_total_flops(), state, loss


def mfu(flops, seconds_per_step: float, peak):
    return None if peak is None else flops / seconds_per_step / peak


def setup(variant: str, image: int, patch: int, batch: int, remat: bool = False,
          num_features=None, device=None, widths=None):
    """`variant`'s model at (image, patch, batch) from seed 0 (ViT-B widths
    unless `widths`), its train state and eager `make_train_step`, seeded
    images and labels arange(batch) % classes, and the steps' generator:
    (cfg, model, state, step, images, labels, generator)."""
    from ..configs import mnist_config
    from ..models import create_model
    from ..train import create_train_state, make_train_step

    w = widths or dict(ab_steps.VITB_WIDTHS)
    cfg = mnist_config(image_size=image, patch_size=patch, batch_size=batch, **w)
    kw = {}
    if num_features is not None and variant != "baseline":
        kw["attention_config"] = {"num_features": num_features}
    model = create_model(variant, cfg, remat=remat, device=device,
                         generator=torch.Generator().manual_seed(0), **kw)
    state = create_train_state(model, cfg, steps_per_epoch=100)
    step = make_train_step(model, device=device)
    m = cfg.model
    data = torch.Generator(device).manual_seed(0)
    images = torch.randn((batch, m.image_size, m.image_size, m.in_channels),
                         generator=data, device=device)
    labels = torch.arange(batch, device=device) % m.num_classes
    return cfg, model, state, step, images, labels, torch.Generator(device).manual_seed(1)


def bench_one(variant: str, image: int, patch: int, batch: int, steps: int,
              warmup: int = WARMUP, remat: bool = False, num_features=None,
              device=None, widths=None) -> dict:
    """One row: `variant`'s train step at (image, patch, batch), `steps`
    timed steps after one counted step and `warmup` steps."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    before = ab_steps.launch_counts()
    cfg, _, state, step, images, labels, generator = setup(
        variant, image, patch, batch, remat, num_features, device, widths)

    counted, state, loss = counted_step(step, state, images, labels, generator)
    for _ in range(warmup):
        state, loss, _ = step(state, images, labels, generator)
    ab_steps.chain_barrier(state, loss)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    timed = ab_steps.launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss, _ = step(state, images, labels, generator)
    ab_steps.chain_barrier(state, loss)
    elapsed = time.perf_counter() - t0
    per_step = ab_steps.launches_since(timed)

    return timed_row(variant, cfg.model, batch, steps, elapsed, counted, num_features,
                     device, ab_steps.launches_since(before), per_step)


def timed_row(variant: str, m, batch: int, steps: int, elapsed: float, counted: float,
              num_features, device, launches: dict, per_step: dict) -> dict:
    """A row from `steps` timed steps of `variant` (model config `m`) in
    `elapsed` seconds: times, the counted FLOPs of one eager step plus the
    kernels' analytic ones, MFU against the card's peak, the row's
    `launches` and its timed steps' (`per_step`), and the peak memory since
    the last reset."""
    peak = peak_bf16(device)
    kernels = pallas_attention_flops(variant, batch, m.heads, m.seq_len, m.head_dim,
                                     m.depth, num_features)
    out = {
        "variant": variant,
        "batch": batch,
        "timed_steps": steps,
        "step_ms": elapsed / steps * 1e3,
        "images_per_sec": batch * steps / elapsed,
        "flops_per_step_counted": counted,
        "mfu_counted": mfu(counted, elapsed / steps, peak),
    }
    if kernels:
        out["pallas_attention_flops"] = kernels
    out["flops_per_step"] = counted + kernels
    out["mfu"] = mfu(out["flops_per_step"], elapsed / steps, peak)
    out["launches"] = launches
    out["launches_per_step"] = {k: n / steps for k, n in per_step.items()}
    out["peak_bytes_in_use"] = device_memory_stats(device).get("peak_bytes_in_use")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps-scale", type=float, default=1.0)
    ap.add_argument("--out", default=None, help="also write the JSON to this file")
    ap.add_argument("--variants", nargs="+", default=VARIANTS)
    ap.add_argument("--remat", action="store_true",
                    help="activation-checkpoint each block (trade FLOPs for memory at long N)")
    ap.add_argument("--shapes", nargs="+", default=None,
                    help="subset of shape labels, e.g. N=197 N=1025")
    ap.add_argument("--num-features", default=None,
                    help="linear-attention feature count: an int or 'mxu'. Default: the "
                         "paper default floor(d ln d) = 266 at D=64.")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU; default: the GPU (raises without one)")
    ab_steps.width_flag(ap)
    args = ap.parse_args(argv)
    num_features = args.num_features
    if num_features not in (None, "mxu"):
        num_features = int(num_features)
    device, card = ab_steps.start(args)
    w = ab_steps.widths(args)

    print(f"backend={card}  dims {w['dim']}/{w['heads']}h/D{w['dim'] // w['heads']}, "
          f"mlp {w['mlp_dim']}, depth {w['depth']}, bf16, full train step (fwd+bwd+adam)",
          flush=True)
    rows = []
    for label, image, patch, N, batch, steps in SHAPES:
        if args.shapes and label not in args.shapes:
            continue
        steps = max(3, int(steps * args.steps_scale))
        for variant in args.variants:
            try:
                r = bench_one(variant, image, patch, batch, steps, remat=args.remat,
                              num_features=num_features, device=device, widths=w)
            except Exception as e:  # the row records the failure, as the JAX bench does
                print(f"{label} {variant}: FAILED {type(e).__name__}: {str(e)[:300]}",
                      flush=True)
                rows.append({"shape": label, "N": N, "variant": variant,
                             "error": f"{type(e).__name__}: {str(e)[:300]}"})
                continue
            finally:
                ab_steps.release()
            r.update({"shape": label, "N": N})
            rows.append(r)
            mfu_text = "n/a" if r["mfu"] is None else f"{r['mfu'] * 100:.1f}%"
            print(f"{label} {variant}: {r['images_per_sec']:.1f} img/s  "
                  f"{r['step_ms']:.1f} ms/step (B={r['batch']})  MFU {mfu_text}", flush=True)

    result = {"backend": card, "dims": {"dim": w["dim"], "heads": w["heads"],
                                        "head_dim": w["dim"] // w["heads"],
                                        "mlp_dim": w["mlp_dim"], "depth": w["depth"],
                                        "dtype": "bfloat16"},
              "rows": rows}
    if num_features is not None:
        result["num_features"] = num_features
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
