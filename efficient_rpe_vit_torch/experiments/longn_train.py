#!/usr/bin/env python
"""Long-N convergence: ViT-B at N=4097 learns on the kernels, on one card.

Counterpart of `experiments/longn_train.py` (the JAX package's), with its
variants, flags, protocol and JSON keys: ViT-B widths (dim 768, depth 12,
12 heads, mlp 3072) on 128x128 images at patch 2 (N=4097), batch 4, bf16,
the reference's default dropout 0.1 (attention probabilities included),
Adam at a constant learning rate of 1e-4 (1e-3, the config default, makes
the loss rise at dim 768 and batch 4), 120 train steps, for

  * baseline                      the flash kernels: #6 with its in-kernel
                                  hash dropout and the two-pass backward 7b,
  * performer_favor_most_general  the KERPLE kernels #1 and #2.

The data is a fixed synthetic set of 16 normal images drawn from a seeded
`torch.Generator` (the JAX draws cannot be reproduced), labelled
arange(16) % 10 and cycled in batches of 4, so the model can fit it: a
falling loss shows that the kernels' gradients drive learning, not only
that a step is finite. Each step's loss and accuracy are read on the host;
`decreased` compares the means of the first and the last five losses.
Each run also holds the kernel launches it made (`launches`). The result's
`backend` is the card's name and power limit.

    python -m efficient_rpe_vit_torch.experiments.longn_train \\
        [--steps 120] [--lr 1e-4] [--variants ...] [--out FILE]

It runs on the GPU unless `--device cpu` is given, and raises without one;
the first line printed is the card's name and power limit. `--width DIM
DEPTH HEADS MLP` and `--shape IMAGE PATCH BATCH` (default ViT-B's and 128
2 4) are for the CPU tests.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from . import ab_steps

VARIANTS = ["baseline", "performer_favor_most_general"]
SHAPE = (128, 2, 4)  # image, patch, batch
DROPOUT = 0.1
N_TRAIN = 16


def run(variant: str, steps: int, lr: float, batch: int = 4, n_train: int = N_TRAIN,
        image: int = SHAPE[0], patch: int = SHAPE[1], device=None, widths=None) -> dict:
    """`steps` train steps of `variant` over the fixed synthetic set."""
    from ..configs import mnist_config
    from ..models import create_model
    from ..train import create_train_state, make_train_step
    from ..utils.device import resolve_device

    device = resolve_device(device)
    w = dict(widths or ab_steps.VITB_WIDTHS, dropout=DROPOUT)
    cfg = mnist_config(image_size=image, patch_size=patch, batch_size=batch,
                       learning_rate=lr, scheduler="constant", epochs=1, **w)
    before = ab_steps.launch_counts()
    model = create_model(variant, cfg, device=device, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, steps_per_epoch=steps)
    step_fn = make_train_step(model, device=device)
    m = cfg.model
    data = torch.Generator(device).manual_seed(42)
    images = torch.randn((n_train, m.image_size, m.image_size, m.in_channels),
                         generator=data, device=device)
    labels = torch.arange(n_train, device=device) % m.num_classes
    n_batches = n_train // batch

    losses, accs = [], []
    generator = torch.Generator(device).manual_seed(7)
    t0 = time.perf_counter()
    for i in range(steps):
        b = i % n_batches
        x = images[b * batch:(b + 1) * batch]
        y = labels[b * batch:(b + 1) * batch]
        state, loss, correct = step_fn(state, x, y, generator)
        losses.append(float(loss))
        accs.append(float(correct) / batch)
    ab_steps.chain_barrier(state, loss)
    wall = time.perf_counter() - t0

    first5 = sum(losses[:5]) / 5
    last5 = sum(losses[-5:]) / 5
    row = {
        "variant": variant,
        "steps": steps,
        "lr": lr,
        "batch": batch,
        "n_train": n_train,
        "dropout": DROPOUT,
        "losses": losses,
        "accuracies": accs,
        "loss_first5_mean": first5,
        "loss_last5_mean": last5,
        "decreased": last5 < first5,
        "finite": all(math.isfinite(x) for x in losses),
        "wall_s": wall,
        "launches": ab_steps.launches_since(before),
    }
    print(f"{variant}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(first5 {first5:.3f}, last5 {last5:.3f}, "
          f"{'DOWN' if row['decreased'] else 'NOT DOWN'}), "
          f"acc {accs[-1] * 100:.0f}%, {wall:.0f}s", flush=True)
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--variants", nargs="+", default=VARIANTS)
    ap.add_argument("--out", default=None, help="also write the JSON to this file")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU; default: the GPU (raises without one)")
    ab_steps.width_flag(ap)
    ap.add_argument("--shape", type=int, nargs=3, default=list(SHAPE),
                    metavar=("IMAGE", "PATCH", "BATCH"), help="default: 128 2 4 (N=4097)")
    args = ap.parse_args(argv)
    device, card = ab_steps.start(args)
    w = ab_steps.widths(args)
    image, patch, batch = args.shape

    result = {
        "backend": card,
        "N": ab_steps.seq_len(image, patch),
        "dims": {"dim": w["dim"], "heads": w["heads"], "mlp_dim": w["mlp_dim"],
                 "depth": w["depth"], "dtype": "bfloat16"},
        "note": (
            f"ViT-B N={ab_steps.seq_len(image, patch)}, reference-default attention dropout "
            f"{DROPOUT}, constant LR, fixed synthetic set ({N_TRAIN} images cycled): a "
            "downward loss curve = the long-N kernels' gradients (flash softmax / KERPLE "
            "coefficients) drive real learning."
        ),
        "runs": [],
    }
    for v in args.variants:
        result["runs"].append(run(v, args.steps, args.lr, batch=batch, image=image,
                                  patch=patch, device=device, widths=w))
        ab_steps.release()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
