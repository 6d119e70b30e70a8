"""FAVOR+ with KERPLE: phi's projections and the KERPLE op.

The op: out = (W v) / (W 1 + eps), W = (q' k'^T) * T, with q', k' [B, H, N,
F], v [B, H, N, D] and T the Toeplitz matrix of the [H, 2N-1] coefficients.
Forward products: q' k'^T (F) and W v (D). Backward products the op needs:
A = q' k'^T again, M = g v^T, dv = W^T (g / den), dq' = dA k', dk' = dA^T q'
(widths F, D, D, F, F). Bytes: the op's inputs read once and its outputs
written once (the backward reads the inputs and the output gradient and
writes the input gradients). The products are copied from
`bench_torch.py::train_flops_per_step` (forward) and the bytes from
`chip_smoke.py::kerple_bound`, without the kernels' tiles and windows that
`chip_smoke.py::kerple_bwd_bounds` counts.
"""

from __future__ import annotations

from . import vit


def _widths(config: dict, s: dict):
    return config["num_features"], s["D"]


def attention_forward_flops_per_image(config: dict, s: dict) -> float:
    """Per image, one forward, all layers: phi's projections x @ Omega of q
    and k, and the op's two products."""
    F, D = _widths(config, s)
    h, n = s["H"], s["N"]
    per_layer = 2 * 2 * h * n * D * F + 2 * h * n * n * F + 2 * h * n * n * D
    return s["L"] * per_layer


def train_flops_per_step(config: dict, mix: dict) -> float:
    s = vit.shape(config, mix)
    return vit.step_flops(s, attention_forward_flops_per_image(config, s))


def op_least_seconds(config: dict, mix: dict, peak: dict) -> dict:
    """{"forward": s, "backward": s}: the least time of one KERPLE op call
    (one layer) at the cell's shapes."""
    s = vit.shape(config, mix)
    F, D = _widths(config, s)
    bhn, nn = s["B"] * s["H"] * s["N"], s["B"] * s["H"] * s["N"] ** 2
    elt, dtype = vit.elt_bytes(config), config["compute_dtype"]
    coeffs = 4 * s["H"] * (2 * s["N"] - 1)
    fwd_flops = 2 * nn * (F + D)
    fwd_bytes = elt * bhn * (2 * F + D) + coeffs + elt * bhn * D
    bwd_flops = 2 * nn * (3 * F + 2 * D)
    bwd_bytes = elt * bhn * (2 * F + 2 * D) + coeffs + elt * bhn * (2 * F + D) + coeffs
    return {"forward": vit.least_seconds(fwd_flops, fwd_bytes, peak, dtype),
            "backward": vit.least_seconds(bwd_flops, bwd_bytes, peak, dtype)}
