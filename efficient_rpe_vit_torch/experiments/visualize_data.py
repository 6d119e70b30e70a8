#!/usr/bin/env python
"""Raw-dataset explorer (MNIST, CIFAR-10): a PNG report.

Counterpart of the PNG mode of `experiments/visualize_data.py` (the JAX
package's explorer; its Streamlit mode needs `streamlit`, which the port
does not use): on the port's `data.load_dataset`, one figure of a sample
grid (per class, images picked with `numpy.random.default_rng(0)`), the
class distribution and a pixel histogram (2,000 images picked by the same
generator, with their mean and standard deviation), titled with the
dataset's shape and whether it came from the raw files or the synthetic
fallback.

    python -m efficient_rpe_vit_torch.experiments.visualize_data mnist \\
        [--split train] [--out mnist_train_explore.png]

It reads files and draws on the host: no device work, so it takes no
`--device`. Drawing needs matplotlib (Agg), imported inside the function
that draws.
"""

from __future__ import annotations

import argparse
import warnings

import numpy as np

CLASS_NAMES = {
    "mnist": [str(i) for i in range(10)],
    "cifar10": ["airplane", "automobile", "bird", "cat", "deer",
                "dog", "frog", "horse", "ship", "truck"],
}


def build_figure(name: str, split: str = "train", n_per_class: int = 8):
    """(figure, the loaded dataset dict) of `name`'s `split`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..data import load_dataset

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        data = load_dataset(name)
    images = data[f"{split}_images"]
    labels = data[f"{split}_labels"]
    names = CLASS_NAMES[name]

    fig = plt.figure(figsize=(14, 16))
    gs = fig.add_gridspec(13, n_per_class, hspace=0.4)

    # sample grid: one row per class
    rng = np.random.default_rng(0)
    for cls in range(10):
        idx = np.flatnonzero(labels == cls)
        picks = rng.choice(idx, min(n_per_class, len(idx)), replace=False)
        for col, i in enumerate(picks):
            ax = fig.add_subplot(gs[cls, col])
            img = images[i]
            ax.imshow(img.squeeze() if img.shape[-1] == 1 else img,
                      cmap="gray" if img.shape[-1] == 1 else None)
            ax.set_axis_off()
            if col == 0:
                ax.set_title(names[cls], fontsize=8, loc="left")

    # class distribution
    ax = fig.add_subplot(gs[10:12, : n_per_class // 2])
    counts = np.bincount(labels, minlength=10)
    ax.bar(range(10), counts)
    ax.set_title(f"{split} class distribution (n={len(labels)})", fontsize=9)
    ax.set_xticks(range(10))
    ax.set_xticklabels(names, rotation=45, fontsize=7)

    # pixel histogram
    ax = fig.add_subplot(gs[10:12, n_per_class // 2:])
    sample = images[rng.choice(len(images), min(2000, len(images)), replace=False)]
    ax.hist(sample.ravel(), bins=64, log=True)
    mean = sample.mean() / 255.0
    std = sample.std() / 255.0
    ax.set_title(f"pixel histogram  mean={mean:.4f} std={std:.4f}", fontsize=9)

    fig.suptitle(
        f"{name.upper()} {split}: {images.shape} "
        f"{'(synthetic fallback)' if data.get('synthetic') else '(raw files)'}",
        fontsize=12,
    )
    return fig, data


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("dataset", choices=["mnist", "cifar10"])
    p.add_argument("--split", default="train", choices=["train", "test"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    fig, _ = build_figure(args.dataset, args.split)
    out = args.out or f"{args.dataset}_{args.split}_explore.png"
    fig.savefig(out, dpi=110, bbox_inches="tight")
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
