"""Device-resident data pipeline: batches gathered, augmented and
normalised on the device.

Counterpart of `efficient_rpe_vit_tpu/data/pipeline.py`: the dataset lives
on the device as uint8 once (`DeviceDataset`); each batch is gathered by
index, augmented on raw [0, 1] pixels and then normalised (torchvision's
transform-then-Normalize order, so rotation and crop fills are black), and
only an index vector crosses from the host per batch. Augmentations mirror
the reference's transforms: MNIST RandomRotation(10 deg); CIFAR
RandomCrop(32, padding=4) + RandomHorizontalFlip. Their draws come from an
explicit `torch.Generator`, so they differ from JAX's; the deterministic
parts (`_rotate_bilinear` at given angles, `_crop_flip` at given offsets
and flips) match the JAX functions.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device


def normalize_images(images_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC -> float32 normalised: (x/255 - mean) / std."""
    x = images_u8.float() / 255.0
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def _rotate_bilinear(images: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate each [H, W, C] image of `images` [B, H, W, C] by its angle
    (radians, [B]) about its centre with bilinear resampling and zero
    fill: the JAX function's sampling grid and corner weights, its
    interpolation matrix replaced by a gather of the four corners."""
    B, H, W, C = images.shape
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=images.device),
        torch.arange(W, dtype=torch.float32, device=images.device), indexing="ij")
    cos = torch.cos(angles)[:, None, None]
    sin = torch.sin(angles)[:, None, None]
    src_y = cos * (yy - cy) + sin * (xx - cx) + cy
    src_x = -sin * (yy - cy) + cos * (xx - cx) + cx
    y0 = torch.floor(src_y)
    x0 = torch.floor(src_x)
    wy = src_y - y0
    wx = src_x - x0
    y0, x0 = y0.long(), x0.long()
    flat = images.reshape(B, H * W, C)

    def corner(yi, xi, w):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, H * W, 1)
        vals = torch.gather(flat, 1, idx.expand(B, H * W, C))
        return vals * torch.where(valid, w, 0.0).reshape(B, H * W, 1)

    out = (corner(y0, x0, (1 - wy) * (1 - wx))
           + corner(y0, x0 + 1, (1 - wy) * wx)
           + corner(y0 + 1, x0, wy * (1 - wx))
           + corner(y0 + 1, x0 + 1, wy * wx))
    return out.reshape(B, H, W, C)


def augment_mnist(images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Random rotation in [-10, 10] degrees per image (float inputs)."""
    u = torch.rand(images.shape[0], generator=generator, device=images.device)
    return _rotate_bilinear(images, (u * 20.0 - 10.0) * (math.pi / 180.0))


def _crop_flip(images: torch.Tensor, offsets: torch.Tensor, flip: torch.Tensor,
               pad: int = 4) -> torch.Tensor:
    """Crop each image of the zero-padded batch at its (row, column)
    offset [B, 2] in [0, 2*pad], then mirror it left-right where `flip`
    [B] is set."""
    B, H, W, C = images.shape
    padded = torch.nn.functional.pad(images, (0, 0, pad, pad, pad, pad))
    rows = offsets[:, 0, None] + torch.arange(H, device=images.device)
    cols = offsets[:, 1, None] + torch.arange(W, device=images.device)
    batch = torch.arange(B, device=images.device)[:, None, None]
    cropped = padded[batch, rows[:, :, None], cols[:, None, :]]
    return torch.where(flip[:, None, None, None], cropped.flip(2), cropped)


def augment_cifar(images: torch.Tensor, generator: torch.Generator,
                  pad: int = 4) -> torch.Tensor:
    """Random crop with `pad` zero padding + random horizontal flip."""
    B = images.shape[0]
    offsets = torch.randint(0, 2 * pad + 1, (B, 2), generator=generator,
                            device=images.device)
    flip = torch.rand(B, generator=generator, device=images.device) < 0.5
    return _crop_flip(images, offsets, flip, pad)


def _gather_batch(images_u8: torch.Tensor, labels: torch.Tensor, idx: torch.Tensor,
                  mean: torch.Tensor, std: torch.Tensor, augment: Optional[str],
                  generator: Optional[torch.Generator]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """On the device: gather the batch rows `idx`, augment on raw [0, 1]
    pixels, then normalise, so rotation and crop fills are black (raw 0),
    not the per-channel mean."""
    x = images_u8.index_select(0, idx).float() / 255.0
    y = labels.index_select(0, idx)
    if augment == "mnist":
        x = augment_mnist(x, generator)
    elif augment == "cifar":
        x = augment_cifar(x, generator)
    elif augment is not None:
        raise ValueError(f"unknown augment {augment!r}: 'mnist', 'cifar' or None")
    return (x - mean) / std, y


class DeviceDataset:
    """Device-resident dataset with on-device batch assembly.

    Holds the uint8 images [n, H, W, C] and int32 labels on `device` (None:
    the GPU, raising when there is none). Iterating yields (images [B, H,
    W, C] float32 normalised, labels [B] int32). Shuffling permutes a host
    index vector per epoch with numpy's `default_rng(seed)`, the JAX
    package's stream, so both packages see the same batches; augmentation
    draws come from a `torch.Generator` seeded seed + 1.
    """

    def __init__(self, images_u8: np.ndarray, labels: np.ndarray,
                 mean, std, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, augment: Optional[str] = None,
                 seed: int = 0, device: Union[str, torch.device, None] = None,
                 synthetic: bool = False):
        device = resolve_device(device)
        self.n = len(images_u8)
        # provenance: True when the loader fell back to generated data, so
        # accuracies are never taken for real-dataset numbers
        self.synthetic = synthetic
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.augment = augment
        self._rng = np.random.default_rng(seed)
        self._aug_gen = torch.Generator(device).manual_seed(seed + 1)
        self.images = torch.as_tensor(np.ascontiguousarray(images_u8, np.uint8),
                                      device=device)
        self.labels = torch.as_tensor(np.asarray(labels).astype(np.int32),
                                      device=device)
        channels = images_u8.shape[-1]
        self.mean, self.std = (
            torch.as_tensor(np.array(np.broadcast_to(v, (channels,)), np.float32),
                            device=device) for v in (mean, std))

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    @property
    def num_samples(self) -> int:
        return self.n

    def epoch_order(self) -> np.ndarray:
        """One epoch's sample order: a fresh permutation when shuffling (it
        advances the stream the iterator uses). The gather-fused epoch
        loop cuts it into [K, B] index chunks."""
        return self._rng.permutation(self.n) if self.shuffle else np.arange(self.n)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        order = self.epoch_order()
        bs = self.batch_size
        stop = len(self) * bs
        for start in range(0, min(stop, self.n), bs):
            idx = torch.as_tensor(order[start:start + bs], device=self.images.device)
            yield _gather_batch(self.images, self.labels, idx, self.mean, self.std,
                                self.augment, self._aug_gen)
