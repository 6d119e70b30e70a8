"""The SAM image encoder of the configurations, plain: its leaves and its
forward.

`segment_anything/modeling/image_encoder.py` (Kirillov et al. 2023) as
`build_sam_vit_h` configures it, in float32 with dense attention: the
patch embedding (the strided convolution as one product over (C, p, p)
patches of the NHWC images), the absolute position embedding, pre-norm
blocks (LayerNorm eps 1e-6, qkv with bias, exact GELU), windowed in all but
the global blocks (the normed tokens zero-padded to a multiple of the
window, cut into windows, put back and cropped; padded tokens take part in
the attention), softmax attention with the decomposed relative-position
bias `add_decomposed_rel_pos` adds, (scale q) k^T + q Rh + q Rw with the
tables indexed at qh - kh + K - 1 and q unscaled, and the neck (1 x 1
conv, LayerNorm2d, 3 x 3 conv with zero padding as an im2col product,
LayerNorm2d). The configuration's head follows: the mean over the neck's
grid and a linear layer. Every product goes through `prods`, so the fp8
control reaches each one. Leaf names are the program's (SAM's state-dict
names, `head.*` added). The `sam` family's plain model (`spec.family`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..counts.sam import shape

LN_EPS = 1e-6


def parameter_spec(config: dict, mix: dict):
    """[(name, shape, init)] of every leaf. The relative-position tables are
    drawn `xavier` (SAM starts them at zero) so that the bias moves the
    scores from the first step."""
    s = shape(config, mix)
    dim, mlp, g, d = s["dim"], s["mlp"], s["grid"], s["D"]
    c, p = s["out_chans"], config["patch_size"]
    spec = [("patch_embed.proj.weight", (dim, config["in_channels"], p, p), "xavier"),
            ("patch_embed.proj.bias", (dim,), "small"),
            ("pos_embed", (1, g, g, dim), "small")]
    for i in range(s["L"]):
        side = g if i in config["global_attn_indexes"] else s["window"]
        b = f"blocks.{i}."
        spec += [(b + "norm1.weight", (dim,), "one_small"), (b + "norm1.bias", (dim,), "small"),
                 (b + "attn.qkv.weight", (3 * dim, dim), "xavier"),
                 (b + "attn.qkv.bias", (3 * dim,), "small"),
                 (b + "attn.proj.weight", (dim, dim), "xavier"),
                 (b + "attn.proj.bias", (dim,), "small"),
                 (b + "attn.rel_pos_h", (2 * side - 1, d), "xavier"),
                 (b + "attn.rel_pos_w", (2 * side - 1, d), "xavier"),
                 (b + "norm2.weight", (dim,), "one_small"), (b + "norm2.bias", (dim,), "small"),
                 (b + "mlp.lin1.weight", (mlp, dim), "xavier"),
                 (b + "mlp.lin1.bias", (mlp,), "small"),
                 (b + "mlp.lin2.weight", (dim, mlp), "xavier"),
                 (b + "mlp.lin2.bias", (dim,), "small")]
    spec += [("neck.0.weight", (c, dim, 1, 1), "xavier"),
             ("neck.1.weight", (c,), "one_small"), ("neck.1.bias", (c,), "small"),
             ("neck.2.weight", (c, c, 3, 3), "xavier"),
             ("neck.3.weight", (c,), "one_small"), ("neck.3.bias", (c,), "small"),
             ("head.weight", (s["classes"], c), "xavier"),
             ("head.bias", (s["classes"],), "small")]
    return spec


def trains(init: str) -> bool:
    return True


def block_rows(config: dict, mix: dict, budget_bytes: float = 16e9) -> int:
    """Rows per block: what one image keeps for its float32 backward within
    `budget_bytes`: per block about four [tokens, dim + mlp] tensors over
    the tokens the attention sees and three [H, n, n] score tensors per
    window or grid (~34 GB at ViT-H, 1024^2: one image at a time)."""
    s = shape(config, mix)
    per_image = 0
    for windowed, count in ((True, s["window_blocks"]), (False, s["global_blocks"])):
        groups, n = (s["windows"], s["window"] ** 2) if windowed else (1, s["N"])
        per_image += count * 4 * (4 * groups * n * (s["dim"] + s["mlp"])
                                  + 3 * s["H"] * groups * n * n)
    return max(1, min(s["B"], int(budget_bytes // per_image)))


def _windows(x: torch.Tensor, window: int):
    """[b, H, W, C] -> [b nh nw, window, window, C], zero-padded first."""
    b, h, w, c = x.shape
    ph, pw = (window - h % window) % window, (window - w % window) % window
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // window, window, wp // window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window, window, c), (hp, wp)


def _unwindows(x: torch.Tensor, window: int, padded, size) -> torch.Tensor:
    (hp, wp), (h, w) = padded, size
    b = x.shape[0] // (hp * wp // window // window)
    x = x.view(b, hp // window, wp // window, window, window, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w, :]


def _relative(table: torch.Tensor, side: int) -> torch.Tensor:
    """SAM's get_rel_pos for equal query and key sides: [side, side, D],
    entry (a, b) = table[a - b + side - 1]."""
    a = torch.arange(side, device=table.device)
    return table[a[:, None] - a[None, :] + side - 1]


def attention(x: torch.Tensor, leaves: dict, heads: int, prods) -> torch.Tensor:
    """[b, h, w, dim] tokens -> [b, h, w, dim]: SAM's Attention with
    use_rel_pos, dense."""
    b, hh, ww, dim = x.shape
    n, d = hh * ww, dim // heads
    qkv = prods.linear(x.reshape(b, n, dim), leaves["attn.qkv.weight"], leaves["attn.qkv.bias"])
    q, k, v = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)  # [b, H, n, d] each
    scores = prods.matmul(q * d ** -0.5, k.transpose(-1, -2))
    rh = _relative(leaves["attn.rel_pos_h"], hh)  # [qh, kh, d]
    rw = _relative(leaves["attn.rel_pos_w"], ww)  # [qw, kw, d]
    grid = q.reshape(b * heads, hh, ww, d)
    rel_h = prods.matmul(grid, rh.transpose(-1, -2))  # [bH, qh, qw, kh]
    rel_w = prods.matmul(grid.transpose(1, 2), rw.transpose(-1, -2)).transpose(1, 2)
    scores = (scores.view(b * heads, hh, ww, hh, ww) + rel_h[..., :, None]
              + rel_w[..., None, :]).view(b, heads, n, n)
    o = prods.matmul(torch.softmax(scores, dim=-1), v)
    o = o.transpose(1, 2).reshape(b, hh, ww, dim)
    return prods.linear(o, leaves["attn.proj.weight"], leaves["attn.proj.bias"])


def forward(w: dict, x: torch.Tensor, config: dict, prods) -> torch.Tensor:
    """Normalised images x [b, S, S, C] -> logits [b, classes]."""
    b, size, _, c = x.shape
    p, dim, heads = config["patch_size"], config["dim"], config["heads"]
    g = size // p
    patches = (x.permute(0, 3, 1, 2).reshape(b, c, g, p, g, p)
               .permute(0, 2, 4, 1, 3, 5).reshape(b, g, g, c * p * p))
    h = prods.linear(patches, w["patch_embed.proj.weight"].reshape(dim, -1),
                     w["patch_embed.proj.bias"]) + w["pos_embed"]
    for i in range(config["depth"]):
        pre = f"blocks.{i}."
        leaves = {k[len(pre):]: v for k, v in w.items() if k.startswith(pre)}
        window = 0 if i in config["global_attn_indexes"] else config["window_size"]
        y = F.layer_norm(h, (dim,), leaves["norm1.weight"], leaves["norm1.bias"], LN_EPS)
        if window:
            y, padded = _windows(y, window)
            y = _unwindows(attention(y, leaves, heads, prods), window, padded, (g, g))
        else:
            y = attention(y, leaves, heads, prods)
        h = h + y
        y = F.layer_norm(h, (dim,), leaves["norm2.weight"], leaves["norm2.bias"], LN_EPS)
        y = F.gelu(prods.linear(y, leaves["mlp.lin1.weight"], leaves["mlp.lin1.bias"]))
        h = h + prods.linear(y, leaves["mlp.lin2.weight"], leaves["mlp.lin2.bias"])
    out = w["neck.0.weight"].shape[0]
    y = prods.linear(h, w["neck.0.weight"].reshape(out, dim))
    y = F.layer_norm(y, (out,), w["neck.1.weight"], w["neck.1.bias"], LN_EPS)
    cols = F.unfold(y.permute(0, 3, 1, 2), 3, padding=1).transpose(1, 2)  # [b, g g, out 9]
    y = prods.linear(cols, w["neck.2.weight"].reshape(out, -1)).reshape(b, g, g, out)
    y = F.layer_norm(y, (out,), w["neck.3.weight"], w["neck.3.bias"], LN_EPS)
    return prods.linear(y.mean(dim=(1, 2)), w["head.weight"], w["head.bias"])
