"""Where the GPipe step's time and memory go on one card.

The flagship (performer_favor_most_general, FAVOR+ with KERPLE) at ViT-B
widths, batch 64, bf16, dropout 0, on one NCCL rank, in these arms:

    step         make_train_step: the batch of 64 in one pass
    accum4       make_train_step with grad_accum=4: four microbatches of 16,
                 one after the other, each freed after its backward
    gpipe_m4     make_pipeline_train_step on pipe=1, M = 4: the same four
                 microbatches, all forwards before the backwards
    gpipe_m1     the same at M = 1: the pipeline without the split

(phi runs on its kernels, which keep no fp32 intermediate, so
`models/attention.py`'s PHI_CHECKPOINT_BYTES does not bear on any arm.)

For each arm: the first step's peak memory above its start (what
`chip_smoke.py` phase 22 a logs) and a later step's; ms per step (host
clock over timed steps after two, ended by a synchronise); and one step
traced with torch.profiler: the kernels' summed device time against the
wall time, the launch count, the host's summed operator time, the top
kernels and the device time by group. GPU only:

    python -m efficient_rpe_vit_torch.experiments.pipeline_probe \\
        [--steps 5] [--out chiprun_out/pipeline_probe.json]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

VITB = dict(image_size=224, patch_size=16, in_channels=3, num_classes=1000, dim=768,
            depth=12, heads=12, mlp_dim=3072, dropout=0.0, compute_dtype="bfloat16",
            batch_size=64)
FLAGSHIP = "performer_favor_most_general"
# (arm, microbatches for GPipe or None, grad_accum)
ARMS = (("step", None, 1),
        ("accum4", None, 4),
        ("gpipe_m4", 4, 1),
        ("gpipe_m1", 1, 1))
GROUPS = (("kerple", ("mlc_",)),
          ("gemm", ("gemm", "xmma", "cutlass", "sm90", "sm80")),
          ("elementwise", ("elementwise", "vectorized", "unrolled")),
          ("reduce", ("reduce",)),
          ("softmax_norm", ("softmax", "norm")))


def _trace(run) -> dict:
    """One call of `run` under torch.profiler: device time of the kernels
    (user ranges left out), wall time, launches, host operator time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, host_us = [], 0.0
    for e in prof.key_averages():
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == DeviceType.CUDA:
            dev = getattr(e, "self_device_time_total", None)
            dev = getattr(e, "self_cuda_time_total", 0) if dev is None else dev
            if dev > 0:
                kernels.append((dev, e.count, e.key))
        else:
            host_us += e.self_cpu_time_total
    busy = sum(k[0] for k in kernels)
    groups = {}
    for dev, _, key in kernels:
        low = key.lower()
        group = next((g for g, hits in GROUPS if any(h in low for h in hits)), "other")
        groups[group] = groups.get(group, 0.0) + dev / 1e3
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us if wall_us else None,
            "launches": sum(k[1] for k in kernels), "host_op_ms": host_us / 1e3,
            "groups_ms": groups,
            "top": [{"ms": d / 1e3, "count": c, "kernel": k[:100]}
                    for d, c, k in sorted(kernels, reverse=True)[:12]]}


def run_arm(label, microbatches, accum, cfg, mesh, x, y, steps: int) -> dict:
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.parallel import (
        create_pipeline_train_state,
        make_pipeline_train_step,
    )
    from efficient_rpe_vit_torch.train import create_train_state, make_train_step

    try:
        model = create_model(FLAGSHIP, cfg, device="cuda",
                             generator=torch.Generator().manual_seed(0))
        if microbatches:
            state = create_pipeline_train_state(model, cfg, mesh, steps_per_epoch=100)
            step = make_pipeline_train_step(model, mesh, state, n_microbatches=microbatches)
        else:
            state = create_train_state(model, cfg, steps_per_epoch=100)
            step = make_train_step(model, grad_accum=accum)
        gen = torch.Generator(device="cuda").manual_seed(3)
        peaks = []
        for _ in range(2):  # the first step (Adam's moments made in it), then the second
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            state, loss, _ = step(state, x, y, gen)
            torch.cuda.synchronize()
            peaks.append((torch.cuda.max_memory_allocated() - start) / 2 ** 30)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss, _ = step(state, x, y, gen)
        float(loss)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps

        def one():
            step(state, x, y, gen)

        out = {"arm": label, "microbatches": microbatches, "grad_accum": accum,
               "ms_per_step": ms, "first_step_peak_gib": peaks[0],
               "second_step_peak_gib": peaks[1], "loss": float(loss), "trace": _trace(one)}
        del model, state, step
        return out
    finally:
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=5, help="timed steps per arm")
    p.add_argument("--out", default=os.path.join("chiprun_out", "pipeline_probe.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("pipeline_probe: no CUDA device is available", file=sys.stderr)
        return 1
    import torch.distributed as dist

    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.ops.kernels import _build
    from efficient_rpe_vit_torch.parallel import make_mesh_from_spec

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s; {card}", flush=True)
    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        cfg = mnist_config(**VITB)
        mesh = make_mesh_from_spec("pipe=1", device="cuda")
        g = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn(VITB["batch_size"], 224, 224, 3, generator=g, device="cuda")
        y = torch.randint(0, 1000, (VITB["batch_size"],), generator=g, device="cuda")
        arms = []
        for arm in ARMS:
            r = run_arm(*arm, cfg, mesh, x, y, args.steps)
            t = r["trace"]
            print(f"{r['arm']:<24} {r['ms_per_step']:9.3f} ms/step; peak above start "
                  f"{r['first_step_peak_gib']:.3f} GiB (first step) "
                  f"{r['second_step_peak_gib']:.3f} (second); traced step {t['wall_ms']:.3f} "
                  f"ms wall, kernels {t['device_busy_ms']:.3f} ms "
                  f"({100 * (t['device_busy_share'] or 0):.1f}%), {t['launches']} launches, "
                  f"host operators {t['host_op_ms']:.3f} ms; loss {r['loss']:.6f}", flush=True)
            print("    groups (ms): " + ", ".join(
                f"{k} {v:.3f}" for k, v in sorted(t["groups_ms"].items(), key=lambda kv: -kv[1])),
                flush=True)
            arms.append(r)
    finally:
        dist.destroy_process_group()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "config": VITB, "model": FLAGSHIP, "arms": arms}, f, indent=1)
    print(f"wrote {args.out}; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
