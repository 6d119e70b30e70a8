#!/usr/bin/env python
"""Serving latency benchmark of the port: exported artifacts against the live model.

Counterpart of `experiments/serve_bench.py` (the JAX package's). For each
weights dtype (fp32 / bfloat16 / int8) the model is exported
(`serve.save_exported`) to a temporary file, loaded back
(`serve.load_exported`) as a server would, and the reloaded artifact's
forward is timed with `benchmark_inference`'s chained protocol (CUDA events
on the GPU) through a `chain_fn` over it; a `live_model` row times the
model itself. Every row carries the JAX row keys, the artifact's rows also
`artifact_bytes`. A failing case fails the run.

`--vitb` serves a ViT-B/16 (224x224x3, dim 768, depth 12, N=197, 1000
classes, bf16 compute) instead of a checkpoint: it is fitted for
`--fit-steps` on a fixed synthetic set (so its logits are a structured
function of the input), then each reduced artifact's top-1 agreement and
logit MAE against the fp32 artifact are taken on 64 probe images.

    python -m efficient_rpe_vit_torch.experiments.serve_bench --checkpoint ckpt.pt \\
        [--batches 1 32 256] [--out serve_bench.json] [--quick] [--cpu]
    python -m efficient_rpe_vit_torch.experiments.serve_bench --vitb \\
        [--model performer_favor_most_general] [--fit-steps 40]

The GPU unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

CASES = (("live_model", "live"), ("artifact_fp32", None), ("artifact_bf16", "bfloat16"),
         ("artifact_int8", "int8"))
VITB = dict(image_size=224, patch_size=16, in_channels=3, num_classes=1000, dim=768,
            depth=12, heads=12, mlp_dim=3072, dropout=0.0, compute_dtype="bfloat16",
            batch_size=32, learning_rate=1e-4, scheduler="constant")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", default=None,
                   help="path written by save_checkpoint (required without --vitb)")
    p.add_argument("--model", default=None,
                   help="variant name; default from the checkpoint metadata "
                        "(--vitb: baseline)")
    p.add_argument("--dataset", default=None, choices=[None, "mnist", "cifar10"])
    p.add_argument("--batches", nargs="+", type=int, default=[1, 32, 256])
    p.add_argument("--out", default=None, help="write the result JSON here")
    p.add_argument("--quick", action="store_true",
                   help="uncalibrated short chains (a smoke run, not a measurement)")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--vitb", action="store_true",
                   help="serve a ViT-B/16 fitted on a synthetic set instead of a "
                        "checkpoint, and compare each artifact dtype with the fp32 "
                        "artifact (top-1 agreement, logit MAE)")
    p.add_argument("--fit-steps", type=int, default=40,
                   help="--vitb: synthetic fit steps before export")
    return p.parse_args(argv)


def _vitb_model(args, device):
    """A ViT-B/16 fitted for `fit_steps` steps on 64 fixed synthetic images
    (batches of 32, alternating halves)."""
    from ..configs import mnist_config
    from ..models import create_model
    from ..train import create_train_state, make_train_step

    name = args.model or "baseline"
    cfg = mnist_config(**VITB)
    model = create_model(name, cfg, device=device, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, steps_per_epoch=max(1, args.fit_steps))
    m = cfg.model
    fit_x = torch.randn(64, m.image_size, m.image_size, m.in_channels,
                        generator=torch.Generator().manual_seed(42)).to(device)
    fit_y = (torch.arange(64) % 1000).to(device)
    step = make_train_step(model, device=device)
    generator = torch.Generator(device=device).manual_seed(7)
    loss = None
    for i in range(args.fit_steps):
        b = (i % 2) * 32
        state, loss, _ = step(state, fit_x[b:b + 32], fit_y[b:b + 32], generator)
    if loss is not None:
        print(f"vitb fit: {args.fit_steps} steps, final loss {float(loss):.3f}")
    return name, "synthetic-imagenet-shaped", cfg, state.eval_view()


def _checkpoint_model(args, device):
    from ..configs import get_dataset_config
    from ..models import create_model
    from ..train import create_train_state, load_checkpoint, model_kwargs_from_metadata

    if args.checkpoint is None:
        raise SystemExit("--checkpoint is required without --vitb")
    meta = {}
    if os.path.exists(args.checkpoint + ".meta.json"):
        with open(args.checkpoint + ".meta.json") as f:
            meta = json.load(f).get("metadata", {})
    name = args.model or meta.get("model_name")
    dataset = args.dataset or meta.get("dataset", "mnist")
    if name is None:
        raise SystemExit("--model required (no checkpoint metadata)")
    cfg = get_dataset_config(dataset, compute_dtype=meta.get("compute_dtype"))
    model = create_model(name, cfg, device=device, **model_kwargs_from_metadata(meta))
    state = create_train_state(model, cfg, ema_decay=float(meta.get("ema_decay") or 0.0))
    state, _ = load_checkpoint(args.checkpoint, state)
    return name, dataset, cfg, state.eval_view()


def artifact_chain(fn):
    """`chain(images, length)`: chained forwards through the reloaded
    artifact `fn`, each one's input images + 1e-30 * sum(previous logits),
    as `make_inference_chain` chains the live model."""

    def chain(images: torch.Tensor, length: int) -> torch.Tensor:
        with torch.inference_mode():
            x = images
            for _ in range(int(length)):
                out = fn(x)
                x = images + (1e-30 * out.float().sum()).to(images.dtype)
            return x.sum()

    return chain


def main(argv=None):
    args = parse_args(argv)
    from ..serve import load_exported, save_exported
    from ..train import benchmark_inference
    from ..utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    name, dataset, cfg, model = (_vitb_model if args.vitb else _checkpoint_model)(args, device)
    m = cfg.model
    model.eval()
    print(f"device={device}  model={name}  dataset={dataset}")
    bench_kwargs = (dict(num_chains=3, num_iterations=6, target_chain_time=0.0)
                    if args.quick else dict(num_chains=10, num_iterations=100))

    rows, artifacts = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, wd in CASES:
            chain_fn, artifact_bytes = None, None
            if wd != "live":
                path = save_exported(os.path.join(tmp, f"{label}.pt2"), model,
                                     image_size=m.image_size, in_channels=m.in_channels,
                                     weights_dtype=wd, device=device)
                artifact_bytes = os.path.getsize(path)
                artifacts[label], _ = load_exported(path, device=device)
                chain_fn = artifact_chain(artifacts[label])
            for batch in args.batches:
                images = torch.randn(batch, m.image_size, m.image_size, m.in_channels,
                                     generator=torch.Generator().manual_seed(batch)).to(device)
                r = benchmark_inference(model, images, chain_fn=chain_fn, **bench_kwargs)
                row = {"case": label, "batch": batch,
                       "p50_ms": r["latency_p50_ms"],
                       "mean_ms": r["latency_mean_ms"],
                       "us_per_sample": r["latency_ms_per_sample"] * 1e3,
                       "images_per_sec": r["throughput_images_per_sec"],
                       "chain_length": r["chain_length"],
                       "fetch_rt_ms": r["fetch_rt_ms"]}
                if artifact_bytes is not None:
                    row["artifact_bytes"] = artifact_bytes
                if r.get("clipped_chains"):
                    row["clipped_chains"] = r["clipped_chains"]
                rows.append(row)
                print(f"{label:14s} B={batch:<4d} p50 {row['p50_ms']:.4f} ms/batch"
                      f"  {row['us_per_sample']:.2f} us/sample"
                      f"  {row['images_per_sec']:,.0f} img/s", flush=True)

    agreement = None
    if args.vitb:
        # each reduced artifact's top-1 agreement and logit error against the
        # fp32 artifact on held-out inputs
        probe = torch.randn(64, m.image_size, m.image_size, m.in_channels,
                            generator=torch.Generator().manual_seed(123)).to(device)
        ref = artifacts["artifact_fp32"](probe).float()
        agreement = {"reference": "artifact_fp32"}
        for label in ("artifact_bf16", "artifact_int8"):
            lg = artifacts[label](probe).float()
            agreement[label] = {
                "top1_agreement": (lg.argmax(-1) == ref.argmax(-1)).float().mean().item(),
                "logit_mae": (lg - ref).abs().mean().item(),
                "logit_max_abs": ref.abs().max().item(),
            }
            print(f"{label}: top-1 agreement {agreement[label]['top1_agreement'] * 100:.1f}%  "
                  f"logit MAE {agreement[label]['logit_mae']:.4f} "
                  f"(|logit| max {agreement[label]['logit_max_abs']:.2f})")

    result = {"backend": device.type, "model": name, "dataset": dataset,
              "checkpoint": None if args.vitb else args.checkpoint,
              "quick": bool(args.quick), "rows": rows}
    if args.vitb:
        result["dims"] = {"image": m.image_size, "patch": m.patch_size, "dim": m.dim,
                          "depth": m.depth, "heads": m.heads, "num_classes": m.num_classes,
                          "fit_steps": args.fit_steps}
        result["agreement_vs_fp32_artifact"] = agreement
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
