"""The SAM image encoder's frozen FLOP and roofline arithmetic, from shapes
alone (the `sam` family's counts, `spec.family`).

Per image, one forward (2 FLOPs per multiply-add; a train step is 3x the
forward of the batch, as `vit.py` counts): the patch embedding; per block
the qkv and output projections over the tokens the attention sees (the
windowed blocks' padded windows, SAM computes them), the two MLP products
over the grid's tokens, the attention's S = q k^T and P v per window (or
over the whole grid), and the bias rows rel_h = q Rh, rel_w = q Rw (K
columns each); the neck's 1 x 1 and 3 x 3 products; the head. The
one-hot gathers of the tables and every elementwise step are not counted.

The least time of one attention op call (`op_least_seconds`), windowed
or global: forward products S and P v, backward S again, dP, dv, dq, dk
(5), at the dtype's peak; bytes: q, k, v and the fp32 bias rows read and
out written (forward); q, k, v, g and the bias rows read, dq, dk, dv and
the bias rows' gradient written (backward); the larger of the two times.
The softmax rows (lse, delta) and the kernels' tiles are not counted.
"""

from __future__ import annotations

from . import vit


def shape(config: dict, mix: dict) -> dict:
    """Batch B, heads H, head dim D, depth L, the widths; the token grid
    (side `grid`, N = grid^2 tokens) and its windows (side `window`,
    `windows` of them over the padded grid, `window_tokens` = windows x
    window^2 tokens); the block counts `global_blocks` and
    `window_blocks`."""
    dim, heads, p = config["dim"], config["heads"], config["patch_size"]
    grid = mix["image_size"] // p
    window = config["window_size"]
    per_side = -(-grid // window)
    n_global = len(config["global_attn_indexes"])
    return {
        "B": mix["batch"], "H": heads, "D": dim // heads, "L": config["depth"],
        "dim": dim, "mlp": config["mlp_dim"], "grid": grid, "N": grid * grid,
        "window": window, "windows": per_side ** 2,
        "window_tokens": per_side ** 2 * window ** 2,
        "global_blocks": n_global, "window_blocks": config["depth"] - n_global,
        "patch_dim": config["in_channels"] * p * p, "out_chans": config["out_chans"],
        "classes": config["num_classes"],
    }


def _attention(s: dict, windowed: bool) -> dict:
    """One attention call of a block over the batch: {"groups": windows
    (or 1) per image, "n": tokens a group, "side": the grid side K}."""
    if windowed:
        return {"groups": s["windows"], "n": s["window"] ** 2, "side": s["window"]}
    return {"groups": 1, "n": s["N"], "side": s["grid"]}


def block_forward_flops_per_image(s: dict, windowed: bool) -> float:
    a = _attention(s, windowed)
    tokens = a["groups"] * a["n"]
    dim, h, d = s["dim"], s["H"], s["D"]
    projections = 2 * tokens * dim * 3 * dim + 2 * tokens * dim * dim
    mlp = 2 * 2 * s["N"] * dim * s["mlp"]
    attention = a["groups"] * 2 * 2 * h * a["n"] ** 2 * d
    bias_rows = 2 * 2 * tokens * h * d * a["side"]
    return projections + mlp + attention + bias_rows


def forward_flops_per_image(config: dict, mix: dict) -> float:
    s = shape(config, mix)
    blocks = (s["window_blocks"] * block_forward_flops_per_image(s, True)
              + s["global_blocks"] * block_forward_flops_per_image(s, False))
    n, c = s["N"], s["out_chans"]
    patch = 2 * n * s["patch_dim"] * s["dim"]
    neck = 2 * n * s["dim"] * c + 2 * n * 9 * c * c
    head = 2 * c * s["classes"]
    return patch + blocks + neck + head


def train_flops_per_step(config: dict, mix: dict) -> float:
    """One train step's model FLOPs (`step_mfu.train`): 3x the forward of
    the batch."""
    return 3.0 * mix["batch"] * forward_flops_per_image(config, mix)


def attention_calls(config: dict) -> dict:
    """Attention op calls per forward: {"window": ..., "global": ...}."""
    n_global = len(config["global_attn_indexes"])
    return {"window": config["depth"] - n_global, "global": n_global}


def op_least_seconds(config: dict, mix: dict, peak: dict) -> dict:
    """{"window": {"forward": s, "backward": s}, "global": {...}}: the least
    time of one attention call with the bias, windowed and global, at the
    cell's shapes."""
    s = shape(config, mix)
    elt, dtype = vit.elt_bytes(config), config["compute_dtype"]
    out = {}
    for kind in ("window", "global"):
        a = _attention(s, kind == "window")
        rows = s["B"] * a["groups"] * s["H"] * a["n"]
        bhnd = rows * s["D"]
        product = 2 * rows * a["n"] * s["D"]
        bias = 4 * rows * 2 * a["side"]
        out[kind] = {
            "forward": vit.least_seconds(2 * product, elt * 4 * bhnd + bias, peak, dtype),
            "backward": vit.least_seconds(5 * product, elt * 7 * bhnd + 2 * bias, peak, dtype),
        }
    return out
