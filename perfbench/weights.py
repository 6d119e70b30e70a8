"""The inputs both sides get, made from `--seed` on the card: the weights,
the held images and labels, and each epoch's order.

Weights come from a few large draws of one `torch.Generator` on the device
(one normal draw for every dense leaf, one uniform draw for the KERPLE
slopes, one normal draw for every Omega, orthonormalised by one batched
QR), in float32, and are loaded into the program by name. The plain
reference draws them again from the same seed.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

Spec = List[Tuple[str, Tuple[int, ...], str]]


def sub_seed(seed: int, tag: str) -> int:
    """A seed in [0, 2**63) for one stream of the run's draws, from any
    whole number `seed`."""
    digest = hashlib.sha256(f"{seed}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _numel(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def make_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for every leaf of `spec` (name, shape, init):

    * `xavier`: N(0, 2 / (fan_in + fan_out)) for an [out, in, *kernel]
      weight of rank 2 or more, with torch's fans: fan_in = in x prod(kernel),
      fan_out = out x prod(kernel);
    * `small`: N(0, 0.02^2); `one_small`: 1 + N(0, 0.02^2);
    * `kerple_bias` [H, 2N-1]: -a log(1 + |k - N + 1|) + N(0, 0.02^2) with
      a ~ U(0, 0.5) per head, a Toeplitz mask that decays with distance;
    * `omega` [H, D, M]: per head ceil(M / D) Gaussian D x D blocks made
      orthonormal by QR, their columns side by side, cut to M and scaled by
      sqrt(D) (the Performer paper's orthogonal random features).
    """
    g = torch.Generator(device).manual_seed(sub_seed(seed, "weights"))
    dense = [(n, s, k) for n, s, k in spec if k != "omega"]
    z = torch.randn(sum(_numel(s) for _, s, _ in dense), generator=g, device=device)
    slopes = [(n, s) for n, s, k in spec if k == "kerple_bias"]
    a = torch.rand(sum(s[0] for _, s in slopes), generator=g, device=device) * 0.5
    omegas = [(n, s) for n, s, k in spec if k == "omega"]
    out: Dict[str, torch.Tensor] = {}
    at = ah = 0
    for name, shape, kind in dense:
        x = z[at:at + _numel(shape)].view(shape)
        at += _numel(shape)
        if kind == "xavier":
            if len(shape) < 2:
                raise ValueError(f"xavier init of {name} needs a rank of 2 or more: {shape}")
            receptive = _numel(shape[2:])
            out[name] = x * math.sqrt(2.0 / (shape[1] * receptive + shape[0] * receptive))
        elif kind == "small":
            out[name] = x * 0.02
        elif kind == "one_small":
            out[name] = 1.0 + x * 0.02
        elif kind == "kerple_bias":
            heads, width = shape
            n = (width + 1) // 2
            dist = torch.log1p((torch.arange(width, device=device) - (n - 1)).abs().float())
            out[name] = -a[ah:ah + heads, None] * dist + x * 0.02
            ah += heads
        else:
            raise ValueError(f"unknown init {kind!r} of {name}")
    if omegas:
        heads, d, m = omegas[0][1]
        blocks = -(-m // d)
        gauss = torch.randn((len(omegas) * heads, blocks, d, d), generator=g, device=device)
        q, _ = torch.linalg.qr(gauss)
        omega = q.permute(0, 2, 1, 3).reshape(len(omegas), heads, d, blocks * d)
        omega = omega[..., :m] * math.sqrt(d)
        for i, (name, shape) in enumerate(omegas):
            if tuple(shape) != (heads, d, m):
                raise ValueError(f"Omega leaves differ in shape: {shape}")
            out[name] = omega[i].contiguous()
    return {name: out[name] for name, _, _ in spec}


def make_images(n: int, size: int, channels: int, classes: int, seed: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The held dataset: uint8 noise images [n, size, size, channels] and
    int32 labels [n], drawn on the device."""
    g = torch.Generator(device).manual_seed(sub_seed(seed, "images"))
    images = torch.randint(0, 256, (n, size, size, channels), dtype=torch.uint8,
                           generator=g, device=device)
    labels = torch.randint(0, classes, (n,), dtype=torch.int32, generator=g, device=device)
    return images, labels


def chunks(n: int, batch: int, k: int, seed: int) -> Iterator[np.ndarray]:
    """Endless [k, batch] int32 row chunks: each epoch a fresh permutation
    of the n held rows, cut into whole chunks (the tail that fills no chunk
    is left out)."""
    rng = np.random.default_rng(sub_seed(seed, "order"))
    per = k * batch
    if n < per:
        raise ValueError(f"{n} held images fill no [{k}, {batch}] chunk")
    while True:
        order = rng.permutation(n).astype(np.int32)
        for start in range(0, n - per + 1, per):
            yield order[start:start + per].reshape(k, batch)
