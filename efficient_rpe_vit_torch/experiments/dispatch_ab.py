#!/usr/bin/env python
"""Host cost of the kernel wrappers on two paths that `chip_smoke.py` times.

  * phase 4's served batch: ViT-B/16 performer_favor_most_general (bf16,
    random weights from seed 0, #1 on the kernel) answering batches of 32
    through `make_eval_step`, host clock over `--serve-iters` synchronised
    calls after 2;
  * phase 17's eager train step: the headline model (mnist_config at patch
    2, batch 256, bf16, dropout 0.1) taking `--steps` `make_train_step`
    steps, host clock per step;
  * one call of the KERPLE forward wrapper at a tiny shape ([1, 1, 16, 16],
    bf16), where the call is all host work: microseconds per call over
    1,000 calls.

Each is taken `--rounds` times (the JSON line holds every round and the
median), with the package imported from `--root`
(default: the repository holding this file), so one copy of this script
times two trees on one card in one call, e.g. a parent commit unpacked with
`git archive` against the change, as parent, change, change, parent.

    python efficient_rpe_vit_torch/experiments/dispatch_ab.py [--root DIR] [--rounds 10]

GPU only. Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

VITB = dict(image_size=224, patch_size=16, in_channels=3, num_classes=1000, dim=768,
            depth=12, heads=12, mlp_dim=3072, dropout=0.0, compute_dtype="bfloat16",
            batch_size=32)
HEADLINE = dict(patch_size=2, batch_size=256, compute_dtype="bfloat16")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="directory holding the efficient_rpe_vit_torch package to time")
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--serve-iters", type=int, default=10)
    p.add_argument("--steps", type=int, default=25)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dispatch_ab needs a CUDA device")
    import efficient_rpe_vit_torch
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.ops.kernels import _build
    from efficient_rpe_vit_torch.ops.kernels import masked_linear_coeffs as mlc
    from efficient_rpe_vit_torch.train import create_train_state, make_eval_step, make_train_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build()

    def synced(run, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    # phase 4's served batch
    model = create_model("performer_favor_most_general", mnist_config(**VITB), device="cuda",
                         generator=torch.Generator().manual_seed(0),
                         rpe_config={"method": "pallas"})
    serve = make_eval_step(model)
    g = torch.Generator(device="cuda").manual_seed(1)
    requests = [(torch.randn(32, 224, 224, 3, generator=g, device="cuda"),
                 torch.randint(0, 1000, (32,), generator=g, device="cuda")) for _ in range(4)]

    # phase 17's eager step
    cfg = mnist_config(**HEADLINE)
    head = create_model("performer_favor_most_general", cfg, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(head, cfg, steps_per_epoch=100)
    step = make_train_step(head)
    size = cfg.model.image_size
    xs = torch.randn(args.steps, 256, size, size, 1, generator=g, device="cuda")
    ys = torch.randint(0, 10, (args.steps, 256), generator=g, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)

    # one tiny forward-kernel call
    q = torch.rand(1, 1, 16, 16, generator=g, device="cuda").to(torch.bfloat16)
    c = torch.ones(1, 31, device="cuda")

    runs = {"serve": lambda i: serve(*requests[i % len(requests)]),
            "eager_step": lambda i: step(state, xs[i], ys[i], gen),
            "fwd_call": lambda i: mlc.masked_linear_attention_coeffs_fwd(q, q, q, c)}
    counts = {"serve": args.serve_iters, "eager_step": args.steps, "fwd_call": 1000}
    for name, run in runs.items():  # warm-up
        synced(run, 2)
    result = {"root": str(root), "package": str(Path(efficient_rpe_vit_torch.__file__).parent),
              "card": card, "serve_ms_per_batch": [], "eager_ms_per_step": [],
              "fwd_call_us": []}
    for _ in range(args.rounds):
        result["serve_ms_per_batch"].append(synced(runs["serve"], counts["serve"]) * 1e3)
        result["eager_ms_per_step"].append(synced(runs["eager_step"], counts["eager_step"]) * 1e3)
        result["fwd_call_us"].append(synced(runs["fwd_call"], counts["fwd_call"]) * 1e6)
    for key in ("serve_ms_per_batch", "eager_ms_per_step", "fwd_call_us"):
        result[f"median_{key}"] = statistics.median(result[key])
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
