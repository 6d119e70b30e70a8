"""The ViT of the configurations, plain: its leaves and its forward.

Pre-norm blocks (Dosovitskiy et al. 2020): patches in the (C, p, p) layout
of NHWC images, a linear patch embedding, a CLS token and a learned
position embedding, then per block x + proj(attention(LN(x))) and
x + fc2(GELU(fc1(LN(x)))), GELU exact, LayerNorm eps 1e-5, the qkv
projection without bias; the head is LN + linear on the CLS row. Leaf names
are the state-dict names the port's ViT uses, so the benchmark loads the
same weights into both sides by name. The `vit` family's plain model
(`spec.family`).
"""

from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F

from ..counts.vit import shape

LN_EPS = 1e-5


def attention(config: dict):
    """The attention kind's module, `reference/attn_<attention>.py`."""
    return importlib.import_module(f"perfbench.reference.attn_{config['attention']}")


def parameter_spec(config: dict, mix: dict):
    """[(name, shape, init)] of every leaf; init "omega" marks the ones that
    do not train (buffers)."""
    s = shape(config, mix)
    dim, mlp = s["dim"], s["mlp"]
    spec = [("patch_embedding.weight", (dim, s["patch_dim"]), "xavier"),
            ("patch_embedding.bias", (dim,), "small"),
            ("cls_token", (1, 1, dim), "small"),
            ("pos_embedding", (1, s["N"], dim), "small")]
    extra = attention(config).params(config, s)
    for i in range(s["L"]):
        p = f"transformer_blocks.{i}."
        spec += [(p + "attention.qkv.weight", (3 * dim, dim), "xavier"),
                 (p + "attention.proj.weight", (dim, dim), "xavier"),
                 (p + "attention.proj.bias", (dim,), "small")]
        spec += [(p + suffix, leaf, init) for suffix, leaf, init in extra]
        spec += [(p + "norm1.weight", (dim,), "one_small"), (p + "norm1.bias", (dim,), "small"),
                 (p + "norm2.weight", (dim,), "one_small"), (p + "norm2.bias", (dim,), "small"),
                 (p + "mlp.0.weight", (mlp, dim), "xavier"), (p + "mlp.0.bias", (mlp,), "small"),
                 (p + "mlp.3.weight", (dim, mlp), "xavier"), (p + "mlp.3.bias", (dim,), "small")]
    spec += [("mlp_head.0.weight", (dim,), "one_small"), ("mlp_head.0.bias", (dim,), "small"),
             ("mlp_head.1.weight", (s["classes"], dim), "xavier"),
             ("mlp_head.1.bias", (s["classes"],), "small")]
    return spec


def trains(init: str) -> bool:
    return init != "omega"


def block_rows(config: dict, mix: dict, budget_bytes: float = 16e9) -> int:
    """Rows per block: what one image keeps for its backward (per layer
    about three [H, N, N] and twenty [N, dim + mlp] float32 tensors) within
    `budget_bytes`."""
    s = shape(config, mix)
    per_image = s["L"] * 4 * (3 * s["H"] * s["N"] ** 2 + 20 * s["N"] * (s["dim"] + s["mlp"]))
    return max(1, min(s["B"], int(budget_bytes // per_image)))


def forward(w: dict, x: torch.Tensor, config: dict, prods) -> torch.Tensor:
    """Normalised images x [b, S, S, C] -> logits [b, classes]."""
    attn = attention(config)
    b, size, _, c = x.shape
    p, dim, heads = config["patch_size"], config["dim"], config["heads"]
    g = size // p
    patches = (x.permute(0, 3, 1, 2).reshape(b, c, g, p, g, p)
               .permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, c * p * p))
    h = prods.linear(patches, w["patch_embedding.weight"], w["patch_embedding.bias"])
    h = torch.cat([w["cls_token"].expand(b, -1, -1), h], dim=1) + w["pos_embedding"]
    n = h.shape[1]
    for i in range(config["depth"]):
        pre = f"transformer_blocks.{i}."
        leaves = {k[len(pre):]: v for k, v in w.items() if k.startswith(pre)}
        y = F.layer_norm(h, (dim,), leaves["norm1.weight"], leaves["norm1.bias"], LN_EPS)
        q, k, v = (t.reshape(b, n, heads, dim // heads).transpose(1, 2)
                   for t in prods.linear(y, leaves["attention.qkv.weight"]).chunk(3, dim=-1))
        o = attn.attend(q, k, v, leaves, prods).transpose(1, 2).reshape(b, n, dim)
        h = h + prods.linear(o, leaves["attention.proj.weight"], leaves["attention.proj.bias"])
        y = F.layer_norm(h, (dim,), leaves["norm2.weight"], leaves["norm2.bias"], LN_EPS)
        y = F.gelu(prods.linear(y, leaves["mlp.0.weight"], leaves["mlp.0.bias"]))
        h = h + prods.linear(y, leaves["mlp.3.weight"], leaves["mlp.3.bias"])
    z = F.layer_norm(h[:, 0], (dim,), w["mlp_head.0.weight"], w["mlp_head.0.bias"], LN_EPS)
    return prods.linear(z, w["mlp_head.1.weight"], w["mlp_head.1.bias"])
