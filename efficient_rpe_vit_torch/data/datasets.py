"""Dataset loading with a flagged synthetic fallback.

Counterpart of `efficient_rpe_vit_tpu/data/datasets.py`, its numpy code
copied (the port never imports the JAX package):

  * searches an explicit data_dir, then RPE_VIT_DATA_DIR and ./data for
    raw files (the JAX package's third, absolute location is left out: the
    port reads no directory outside its checkout that the caller did not
    name),
  * MNIST: the IDX train and test splits when present; when only one split
    exists it is deterministically re-split 80/20 with a warning,
  * CIFAR-10: the pickle batches when present (one split: re-split 80/20),
  * else, when allowed, class-structured synthetic data (`_synthetic`, the
    same arrays as the JAX package's for the same seed), flagged with
    `synthetic: True` in every result made from it.

Returned splits are host numpy; `pipeline.DeviceDataset` moves them to
the device once and assembles batches there by index.
`visualize_batch` (matplotlib) is not ported yet.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .io import read_cifar10_batches, read_idx_images, read_idx_labels

_SEARCH_DIRS = [
    os.environ.get("RPE_VIT_DATA_DIR"),
    "./data",
]


def _find_dir(*candidates: str, data_dir: Optional[str] = None) -> Optional[str]:
    bases = ([data_dir] if data_dir else []) + _SEARCH_DIRS
    for base in bases:
        if not base:
            continue
        for cand in candidates:
            path = os.path.join(base, cand)
            if os.path.isdir(path):
                return path
    # an explicit data_dir may BE the dataset directory itself
    if data_dir and os.path.isdir(data_dir):
        return data_dir
    return None


def _synthetic(
    n_train: int, n_test: int, image_size: int, channels: int,
    num_classes: int = 10, seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Class-structured synthetic data: each class is a distinct smooth
    pattern + noise, so models can actually fit it (for pipeline tests and
    machines without the raw files)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32) / image_size

    def make(n):
        labels = rng.integers(0, num_classes, size=n)
        freq = 1 + labels[:, None, None] % 5
        phase = (labels[:, None, None] // 5) * np.pi / 2
        base = 0.5 + 0.5 * np.sin(
            2 * np.pi * freq * (xx + yy)[None] + phase
        )
        imgs = base[..., None].repeat(channels, axis=-1)
        imgs = imgs + rng.normal(0, 0.1, imgs.shape)
        return (np.clip(imgs, 0, 1) * 255).astype(np.uint8), labels.astype(np.int64)

    xtr, ytr = make(n_train)
    xte, yte = make(n_test)
    return {
        "train_images": xtr, "train_labels": ytr,
        "test_images": xte, "test_labels": yte,
        "synthetic": True,
    }


def _resplit(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, ...]:
    """The one split on disk, deterministically cut 80/20 into train/test."""
    n = len(x)
    perm = np.random.default_rng(0).permutation(n)
    cut = int(n * 0.8)
    return x[perm[:cut]], y[perm[:cut]], x[perm[cut:]], y[perm[cut:]]


def _load_mnist(allow_synthetic: bool,
                data_dir: Optional[str] = None) -> Dict[str, np.ndarray]:
    raw = _find_dir(os.path.join("MNIST", "raw"), "mnist/raw", "mnist",
                    data_dir=data_dir)
    splits = {}
    if raw is not None:
        for split, prefix in (("train", "train"), ("test", "t10k")):
            try:
                splits[split] = (
                    read_idx_images(os.path.join(raw, f"{prefix}-images-idx3-ubyte")),
                    read_idx_labels(os.path.join(raw, f"{prefix}-labels-idx1-ubyte")),
                )
            except FileNotFoundError:
                pass
    if len(splits) == 2:
        (xtr, ytr), (xte, yte) = splits["train"], splits["test"]
    elif splits:
        warnings.warn(
            "Only one MNIST split found on disk; deterministically "
            "re-splitting it 80/20 into train/test.",
            UserWarning,
        )
        xtr, ytr, xte, yte = _resplit(*next(iter(splits.values())))
    elif allow_synthetic:
        warnings.warn("MNIST raw files not found; using synthetic data.", UserWarning)
        return _synthetic(8000, 2000, 28, 1)
    else:
        raise FileNotFoundError("MNIST raw files not found and synthetic disabled")

    return {
        "train_images": xtr[..., None],  # [N, 28, 28, 1] uint8
        "train_labels": ytr.astype(np.int64),
        "test_images": xte[..., None],
        "test_labels": yte.astype(np.int64),
        "synthetic": False,
    }


def _load_cifar10(allow_synthetic: bool,
                  data_dir: Optional[str] = None) -> Dict[str, np.ndarray]:
    d = _find_dir("cifar-10-batches-py", data_dir=data_dir)
    if d is not None:
        train = read_cifar10_batches(d, [f"data_batch_{i}" for i in range(1, 6)])
        test = read_cifar10_batches(d, ["test_batch"])
        if train is not None and test is not None:
            return {
                "train_images": train[0], "train_labels": train[1],
                "test_images": test[0], "test_labels": test[1],
                "synthetic": False,
            }
        if train is not None or test is not None:
            warnings.warn(
                "Only one CIFAR-10 split found; re-splitting 80/20.", UserWarning
            )
            xtr, ytr, xte, yte = _resplit(*(train if train is not None else test))
            return {
                "train_images": xtr, "train_labels": ytr,
                "test_images": xte, "test_labels": yte,
                "synthetic": False,
            }
    if allow_synthetic:
        warnings.warn("CIFAR-10 batches not found; using synthetic data.", UserWarning)
        return _synthetic(8000, 2000, 32, 3)
    raise FileNotFoundError("CIFAR-10 batches not found and synthetic disabled")


def load_dataset(name: str, allow_synthetic: bool = True,
                 data_dir: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Load a dataset by name -> dict of numpy arrays (images NHWC uint8,
    labels int64) and its `synthetic` flag.

    `data_dir` (e.g. DataConfig.data_dir) is searched first, before
    RPE_VIT_DATA_DIR and the default locations. An explicit data_dir also
    disables the synthetic fallback: pointing at a directory asks for real
    data, and generated data in its place would give bogus results."""
    name = name.lower()
    if data_dir is not None:
        allow_synthetic = False
    if name == "mnist":
        return _load_mnist(allow_synthetic, data_dir)
    if name == "cifar10":
        return _load_cifar10(allow_synthetic, data_dir)
    raise ValueError(f"Unknown dataset {name!r}; available: mnist, cifar10")


def get_dataloaders(config, seed: int = 0,
                    device: Union[str, torch.device, None] = None):
    """(train, test) `DeviceDataset`s from an ExperimentConfig, on `device`
    (None: the GPU, raising when there is none). The train set shuffles
    and drops the last partial batch; the test set is sequential and keeps
    it. Both carry the loader's `synthetic` flag."""
    from .pipeline import DeviceDataset

    raw = load_dataset(config.data.dataset, config.data.allow_synthetic,
                       data_dir=config.data.data_dir)
    mean = np.asarray(config.data.mean, np.float32)
    std = np.asarray(config.data.std, np.float32)
    aug = None
    if config.data.augmentation:
        aug = "mnist" if config.data.dataset == "mnist" else "cifar"
    train = DeviceDataset(
        raw["train_images"], raw["train_labels"], mean, std,
        batch_size=config.train.batch_size, shuffle=True, drop_last=True,
        augment=aug, seed=seed, device=device, synthetic=raw["synthetic"],
    )
    test = DeviceDataset(
        raw["test_images"], raw["test_labels"], mean, std,
        batch_size=config.train.batch_size, shuffle=False, drop_last=False,
        device=device, synthetic=raw["synthetic"],
    )
    return train, test


def get_sample_batch(config, split: str = "test", batch_size: Optional[int] = None,
                     device: Union[str, torch.device, None] = None):
    """One normalised batch (images, labels) of `split` on `device`."""
    train, test = get_dataloaders(config, device=device)
    ds = train if split == "train" else test
    images, labels = next(iter(ds))
    if batch_size is not None:
        images, labels = images[:batch_size], labels[:batch_size]
    return images, labels


def compute_dataset_stats(name: str) -> Dict[str, Tuple[float, ...]]:
    """Per-channel mean/std of the raw training images in [0, 1]."""
    raw = load_dataset(name)
    x = raw["train_images"].astype(np.float64) / 255.0
    axes = (0, 1, 2)
    return {
        "mean": tuple(float(v) for v in x.mean(axis=axes)),
        "std": tuple(float(v) for v in x.std(axis=axes)),
        "num_train": int(len(raw["train_images"])),
        "num_test": int(len(raw["test_images"])),
    }
