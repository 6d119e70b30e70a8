#!/usr/bin/env python
"""Export a trained checkpoint of the port as a self-contained serving artifact.

Counterpart of `experiments/export.py` (the JAX package's CLI): restore a
`save_checkpoint` file (its sidecar names the variant, the dataset, the
compute dtype and the architecture knobs), take the EMA shadow when one was
tracked, and write the deterministic forward with the weights inside as a
`torch.export` program with a symbolic batch (`serve.save_exported`), which
any process that imports `efficient_rpe_vit_torch.serve` loads and calls
without the model code.

    python -m efficient_rpe_vit_torch.experiments.export --checkpoint ckpt.pt \\
        --out model.pt2 [--weights-dtype bfloat16|float32|int8] [--validate]
    python -m efficient_rpe_vit_torch.experiments.export --checkpoint ckpt.pt \\
        --out model.pt2 --device cpu    # exported on the CPU, served on the GPU
    python -m efficient_rpe_vit_torch.experiments.export --model baseline \\
        --out model.pt2                 # a fresh init

The GPU unless `--cpu` is given; `--device` (in place of the JAX CLI's
`--platforms`) is where the program is traced, by default where the CLI
runs. `--validate` reloads the artifact where the CLI runs and holds it to
the live model at batches 2 and 5.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

# max |logit difference| a reloaded artifact may show against the live
# model, by weights dtype; int8 moves logits by quantization error and is
# held to its top-1 predictions instead
VALIDATE_TOL = {None: 1e-4, "float32": 1e-4, "bfloat16": 5e-2}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", default=None,
                   help="path written by save_checkpoint; omit to export a "
                        "freshly initialised model (pipeline testing)")
    p.add_argument("--model", default=None,
                   help="variant name; default from the checkpoint metadata")
    p.add_argument("--dataset", default=None, choices=[None, "mnist", "cifar10"])
    p.add_argument("--out", required=True, help="artifact path to write")
    p.add_argument("--device", default=None,
                   help="device the program is exported on (e.g. cpu); "
                        "default: where the CLI runs")
    p.add_argument("--weights-dtype", default=None,
                   choices=[None, "bfloat16", "float32", "int8"],
                   help="store the weights in bfloat16 (half the size) or as "
                        "weight-only symmetric per-channel int8 (logits move by "
                        "quantization error)")
    p.add_argument("--validate", action="store_true",
                   help="reload the artifact and check its logits against the "
                        "live model at two batch sizes")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..configs import get_dataset_config
    from ..models import create_model
    from ..serve import load_exported, save_exported
    from ..train import create_train_state, load_checkpoint, model_kwargs_from_metadata
    from ..utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    meta = {}
    if args.checkpoint:
        meta_path = args.checkpoint + ".meta.json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f).get("metadata", {})
    model_name = args.model or meta.get("model_name")
    dataset = args.dataset or meta.get("dataset", "mnist")
    if model_name is None:
        raise SystemExit("--model required (no checkpoint metadata)")

    cfg = get_dataset_config(dataset, compute_dtype=meta.get("compute_dtype"))
    model = create_model(model_name, cfg, device=device, **model_kwargs_from_metadata(meta))
    state = create_train_state(model, cfg, ema_decay=float(meta.get("ema_decay") or 0.0))
    if args.checkpoint:
        state, _ = load_checkpoint(args.checkpoint, state)
    served = state.eval_view()  # the EMA shadow when tracked
    m = cfg.model

    path = save_exported(
        args.out, served, image_size=m.image_size, in_channels=m.in_channels,
        weights_dtype=args.weights_dtype, device=args.device or device,
        metadata={
            "model_name": model_name,
            "dataset": dataset,
            "num_classes": int(m.num_classes),
            "mean": [float(v) for v in np.atleast_1d(cfg.data.mean)],
            "std": [float(v) for v in np.atleast_1d(cfg.data.std)],
            "from_checkpoint": bool(args.checkpoint),
        },
    )
    print(f"wrote {path} ({os.path.getsize(path)} bytes) + {path}.meta.json")

    if args.validate:
        fn, _ = load_exported(path, device=device)
        tol = VALIDATE_TOL.get(args.weights_dtype)
        ok = True
        served.eval()
        for batch in (2, 5):
            g = torch.Generator().manual_seed(batch)
            x = torch.randn(batch, m.image_size, m.image_size, m.in_channels,
                            generator=g).to(device)
            with torch.inference_mode():
                ref = served(x)
            got = fn(x)
            err = (got - ref).abs().max().item()
            if tol is not None:
                print(f"validate B={batch}: max |Δlogit| = {err:.2e}")
                ok = ok and err < tol
            else:  # int8
                agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
                print(f"validate B={batch}: max |Δlogit| = {err:.2e}, "
                      f"top-1 agreement = {agree:.0%}")
                ok = ok and agree == 1.0
        if not ok:
            raise SystemExit("validation FAILED")
        print("validation OK")
    return path


if __name__ == "__main__":
    main()
