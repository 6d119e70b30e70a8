"""Softmax attention: the op softmax(scale q k^T) v.

Forward products: S = q k^T and P v (2 of 2 B H N^2 D each); backward: S
again, dP = g v^T, dv = P^T g, dq = dS k, dk = dS^T q (5). Bytes: q, k, v
read and out written once (forward); q, k, v and g read, dq, dk, dv written
once (backward). Copied from `chip_smoke.py::flash_bound` /
`flash_bwd_bounds` without the kernels' lse / delta rows or their split
into dq and dkv passes, and `bench_torch.py::train_flops_per_step`'s
products extended to softmax.
"""

from __future__ import annotations

from . import vit


def attention_forward_flops_per_image(config: dict, s: dict) -> float:
    """Per image, one forward, all layers: S = q k^T and P v."""
    return s["L"] * 2 * 2 * s["H"] * s["N"] ** 2 * s["D"]


def train_flops_per_step(config: dict, mix: dict) -> float:
    s = vit.shape(config, mix)
    return vit.step_flops(s, attention_forward_flops_per_image(config, s))


def op_least_seconds(config: dict, mix: dict, peak: dict) -> dict:
    """{"forward": s, "backward": s}: the least time of one softmax op call
    (one layer) at the cell's shapes."""
    s = vit.shape(config, mix)
    bhnd = s["B"] * s["H"] * s["N"] * s["D"]
    product = 2 * s["B"] * s["H"] * s["N"] ** 2 * s["D"]
    elt, dtype = vit.elt_bytes(config), config["compute_dtype"]
    return {"forward": vit.least_seconds(2 * product, elt * 4 * bhnd, peak, dtype),
            "backward": vit.least_seconds(5 * product, elt * 7 * bhnd, peak, dtype)}
