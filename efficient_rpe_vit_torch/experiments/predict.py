#!/usr/bin/env python
"""Offline inference CLI of the port: load a checkpoint, classify images.

Counterpart of `experiments/predict.py` (the JAX package's CLI). With
`--checkpoint`: restore a `save_checkpoint` file (its metadata sidecar
names the variant, the dataset and the architecture knobs), serve the EMA
shadow when one was tracked, and either

  * classify a .npy batch ([N, H, W], [N, H, W, C] or flattened) to a
    JSON / NPY prediction file (`--input`, `--output`), or
  * evaluate the dataset's test split (default), then benchmark inference
    on its first batch.

    python -m efficient_rpe_vit_torch.experiments.predict --checkpoint ckpt.pt
    python -m efficient_rpe_vit_torch.experiments.predict --checkpoint ckpt.pt \\
        --input digits.npy --output preds.json

With `--artifact` (written by `experiments.export`): serve the exported
program alone, with the geometry and normalisation of its sidecar, on an
.npy batch or the sidecar dataset's test split; no model code is built.

    python -m efficient_rpe_vit_torch.experiments.predict --artifact model.pt2 \\
        --input digits.npy

The GPU unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", default=None,
                   help="path written by save_checkpoint")
    p.add_argument("--artifact", default=None,
                   help="serving artifact written by experiments.export")
    p.add_argument("--model", default=None,
                   help="variant name; default from the checkpoint metadata")
    p.add_argument("--dataset", default=None, choices=[None, "mnist", "cifar10"],
                   help="config to build with; default from metadata")
    p.add_argument("--input", default=None,
                   help=".npy images to classify; omit to evaluate the "
                        "dataset test split")
    p.add_argument("--output", default=None,
                   help="write predictions to .json or .npy")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--attention-maps", default=None, metavar="PNG",
                   help="render CLS->patch attention heatmaps (softmax "
                        "variants) for up to 4 inputs to this PNG (needs "
                        "matplotlib)")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def _normalise(x, mean, std):
    x = np.asarray(x, np.float32)
    if x.max() > 1.5:  # raw 0-255 input
        x = x / 255.0
    return (x - mean) / std


def _load_input_npy(path, in_channels):
    """[N, H, W, C] from a .npy of flattened / [N, H, W] / [N, H, W, C]
    images (square images assumed for the flattened form)."""
    x = np.load(path)
    if x.ndim == 2:  # [N, H*W*C]
        side = int(np.sqrt(x.shape[-1] / in_channels))
        x = x.reshape(-1, side, side, in_channels)
    elif x.ndim == 3:  # [N, H, W] grayscale
        x = x[..., None]
    return x


def _classify_and_emit(run_batch, x, batch_size, name, output):
    """Batch-loop `run_batch` over x, argmax, and write or print preds."""
    preds = []
    for i in range(0, len(x), batch_size):
        preds.append(run_batch(x[i:i + batch_size]).argmax(dim=-1).cpu().numpy())
    preds = np.concatenate(preds)
    if output:
        if output.endswith(".npy"):
            np.save(output, preds)
        else:
            with open(output, "w") as f:
                json.dump({"model": name, "predictions": preds.tolist()}, f)
        print(f"{len(preds)} predictions written to {output}")
    else:
        print(preds.tolist())
    return preds


def _render_attention_maps(model, x, out_png):
    """Grid of CLS->patch attention per block (head-averaged), one row per
    sample, beside the input image."""
    from ..data.datasets import _pyplot

    plt = _pyplot()
    x = x[:4]
    model.eval()
    with torch.inference_mode():
        logits, maps = model(x, return_attention=True)
    n_blocks, B = len(maps), x.shape[0]
    side = int(np.sqrt(maps[0].shape[-1] - 1))
    fig, axes = plt.subplots(B, n_blocks + 1, figsize=(1.6 * (n_blocks + 1), 1.6 * B),
                             squeeze=False)
    images = x.float().cpu().numpy()
    for b in range(B):
        axes[b][0].imshow(images[b].squeeze(), cmap="gray")
        axes[b][0].set_title("input" if b == 0 else "", fontsize=8)
        for blk in range(n_blocks):
            # CLS row, averaged over heads, patches only -> [P] -> grid
            cls_attn = maps[blk][b].float().mean(0)[0, 1:].cpu().numpy()
            axes[b][blk + 1].imshow(cls_attn.reshape(side, side), cmap="viridis")
            if b == 0:
                axes[b][blk + 1].set_title(f"block {blk}", fontsize=8)
    for ax in fig.axes:
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    preds = logits.argmax(dim=-1).tolist()
    print(f"attention maps ({B} samples x {n_blocks} blocks) -> {out_png} (preds {preds})")
    return out_png


def _predict_from_artifact(args, device):
    """Serve an exported artifact: no model code, no config import for an
    .npy batch; the geometry and normalisation come from its sidecar."""
    from ..serve import load_exported

    fn, meta = load_exported(args.artifact, device=device)
    if "input_shape" not in meta:
        raise SystemExit(
            f"artifact sidecar {args.artifact}.meta.json is missing or incomplete: "
            "it carries the input geometry and normalisation stats; re-export with "
            "experiments.export or copy the sidecar next to the artifact")
    md = meta.get("metadata", {})
    _, H, W, C = meta["input_shape"]
    mean = np.asarray(md.get("mean", [0.0]), np.float32)
    std = np.asarray(md.get("std", [1.0]), np.float32)
    name = md.get("model_name", "artifact")

    if args.input:
        x = _normalise(_load_input_npy(args.input, C), mean, std)
        return _classify_and_emit(lambda xb: fn(torch.as_tensor(xb, device=device)), x,
                                  args.batch_size, name, args.output)

    # evaluate the test split of the sidecar's dataset
    from ..configs import get_dataset_config
    from ..data import get_dataloaders

    dataset = args.dataset or md.get("dataset", "mnist")
    _, test_ds = get_dataloaders(get_dataset_config(dataset), device=device)
    correct = total = 0
    for images, labels in test_ds:
        correct += int((fn(images).argmax(-1) == labels).sum())
        total += int(labels.shape[0])
    acc = 100.0 * correct / max(1, total)
    print(f"{name} (artifact) on {dataset} test split: "
          f"acc {acc:.2f}% over {total} samples")
    return {"accuracy": acc, "samples": total}


def main(argv=None):
    args = parse_args(argv)
    if (args.checkpoint is None) == (args.artifact is None):
        raise SystemExit("exactly one of --checkpoint / --artifact required")

    from ..utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    if args.artifact:
        return _predict_from_artifact(args, device)

    from ..configs import get_dataset_config
    from ..data import get_dataloaders
    from ..models import create_model
    from ..train import (benchmark_inference, create_train_state, evaluate,
                         load_checkpoint, make_eval_step, model_kwargs_from_metadata)

    meta = {}
    meta_path = args.checkpoint + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f).get("metadata", {})
    model_name = args.model or meta.get("model_name")
    dataset = args.dataset or meta.get("dataset", "mnist")
    if model_name is None:
        raise SystemExit("--model required (checkpoint has no metadata)")

    # the dtype the checkpoint was trained in (the JAX sidecar has none:
    # its predict serves in the config's float32)
    cfg = get_dataset_config(dataset, compute_dtype=meta.get("compute_dtype"))
    model = create_model(model_name, cfg, device=device, **model_kwargs_from_metadata(meta))
    state = create_train_state(model, cfg, ema_decay=float(meta.get("ema_decay") or 0.0))
    state, _ = load_checkpoint(args.checkpoint, state)
    served = state.eval_view()  # the EMA shadow when tracked
    m = cfg.model
    mean = np.asarray(cfg.data.mean, np.float32)
    std = np.asarray(cfg.data.std, np.float32)

    def forward(x):
        served.eval()
        with torch.inference_mode():
            return served(torch.as_tensor(np.asarray(x, np.float32), device=device))

    if args.attention_maps:
        if served.attention_type != "softmax":
            raise SystemExit(
                "--attention-maps needs a softmax-attention variant "
                "(linear attention never materialises the [N, N] weights)")
        if args.input:
            x = torch.as_tensor(_normalise(_load_input_npy(args.input, m.in_channels),
                                           mean, std), device=device)
        else:
            _, test_ds = get_dataloaders(cfg, device=device)
            x, _ = next(iter(test_ds))
        return _render_attention_maps(served, x, args.attention_maps)

    if args.input:
        x = _normalise(_load_input_npy(args.input, m.in_channels), mean, std)
        return _classify_and_emit(forward, x, args.batch_size, model_name, args.output)

    # evaluate the dataset's test split, then benchmark its first batch
    _, test_ds = get_dataloaders(cfg, device=device)
    result = evaluate(make_eval_step(served, device=device), test_ds)
    bench_x, _ = next(iter(test_ds))
    inf = benchmark_inference(served, bench_x[:args.batch_size], num_warmup=3,
                              num_iterations=20)
    print(f"{model_name} on {dataset} test split: "
          f"acc {result['accuracy']:.2f}% over {result['samples']} samples; "
          f"{inf['throughput_images_per_sec']:.1f} img/s, "
          f"p50 {inf['latency_p50_ms']:.2f} ms/batch")
    return result


if __name__ == "__main__":
    main()
