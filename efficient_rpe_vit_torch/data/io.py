"""Raw dataset file parsers on numpy, no torchvision.

Counterpart of `efficient_rpe_vit_tpu/data/io.py`, a copy of its numpy
code (the port never imports the JAX package): the binary formats read
directly.

MNIST IDX format: big-endian magic (0x801 labels / 0x803 images) + dims.
CIFAR-10 python pickles: dict with b'data' [N, 3072] and b'labels'.
Transparent gzip support (accepts both `name` and `name.gz`).
"""

from __future__ import annotations

import gzip
import os
import pickle
from typing import List, Optional, Tuple

import numpy as np

IDX_IMAGES_MAGIC = 2051  # 0x803
IDX_LABELS_MAGIC = 2049  # 0x801


def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    if path.endswith(".gz") and os.path.exists(path[:-3]):
        return open(path[:-3], "rb")
    raise FileNotFoundError(path)


def read_idx_images(path: str) -> np.ndarray:
    """Parse an IDX3 image file -> uint8 [N, H, W]."""
    with _open_maybe_gz(path) as f:
        header = np.frombuffer(f.read(16), dtype=">i4")
        magic, n, rows, cols = (int(v) for v in header)
        if magic != IDX_IMAGES_MAGIC:
            raise ValueError(f"bad IDX image magic {magic} in {path}")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def read_idx_labels(path: str) -> np.ndarray:
    """Parse an IDX1 label file -> uint8 [N]."""
    with _open_maybe_gz(path) as f:
        header = np.frombuffer(f.read(8), dtype=">i4")
        magic, n = (int(v) for v in header)
        if magic != IDX_LABELS_MAGIC:
            raise ValueError(f"bad IDX label magic {magic} in {path}")
        return np.frombuffer(f.read(n), dtype=np.uint8)


def read_cifar10_batches(
    dir_path: str, names: List[str]
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Load CIFAR-10 pickle batches -> (uint8 [N, 32, 32, 3], int64 [N]).

    Returns None if any named batch file is missing.
    """
    images, labels = [], []
    for name in names:
        path = os.path.join(dir_path, name)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        data = batch[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        images.append(data.astype(np.uint8))
        labels.append(np.asarray(batch[b"labels"], dtype=np.int64))
    return np.concatenate(images), np.concatenate(labels)
