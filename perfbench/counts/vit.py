"""FLOPs of the ViT parts every attention kind shares.

Copied from `bench_torch.py::train_flops_per_step` (2 FLOPs per
multiply-add; the backward counted as twice the forward, so a train step is
3x the forward; no recompute; elementwise work not counted) and split into
the shared part, here, and each attention kind's own products
(`counts/<attention>.py`). The `vit` family's counts (`spec.family`).
"""

from __future__ import annotations

from .. import spec


def shape(config: dict, mix: dict) -> dict:
    """The sizes the counts read: batch B, heads H, tokens N (CLS
    included), head dim D, depth L, and the widths."""
    dim, heads = config["dim"], config["heads"]
    patches = (mix["image_size"] // config["patch_size"]) ** 2
    return {
        "B": mix["batch"], "H": heads, "N": patches + 1, "D": dim // heads,
        "L": config["depth"], "dim": dim, "mlp": config["mlp_dim"],
        "patches": patches,
        "patch_dim": config["in_channels"] * config["patch_size"] ** 2,
        "classes": config["num_classes"],
    }


def shared_forward_flops_per_image(s: dict) -> float:
    """Per image, one forward: per block the fused QKV, the output
    projection and the two MLP products; the patch embedding and the head."""
    n, d = s["N"], s["dim"]
    block = 2 * n * d * 3 * d + 2 * n * d * d + 2 * 2 * n * d * s["mlp"]
    return s["L"] * block + 2 * s["patches"] * s["patch_dim"] * d + 2 * d * s["classes"]


def step_flops(s: dict, attention_forward_flops_per_image: float) -> float:
    """One train step's model FLOPs: 3x the forward of the batch."""
    return 3.0 * s["B"] * (shared_forward_flops_per_image(s)
                           + attention_forward_flops_per_image)


def train_flops_per_step(config: dict, mix: dict) -> float:
    """The `vit` family's step FLOPs (`step_mfu.train`): its attention
    kind's count, `counts/<attention>.py`."""
    return spec.counts(config["attention"]).train_flops_per_step(config, mix)


def elt_bytes(config: dict) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[config["compute_dtype"]]


def least_seconds(flops: float, nbytes: float, peak: dict, dtype: str) -> float:
    """The larger of the products at the dtype's peak and the bytes at the
    memory's peak."""
    return max(flops / peak[f"{dtype}_flops_per_s"], nbytes / peak["hbm_bytes_per_s"])
