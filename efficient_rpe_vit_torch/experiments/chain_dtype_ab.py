"""Model-level A/B of the rotation chain's rounding: spectra rounded to the
input dtype between products (the JAX package's `CHAIN_INPUT_DTYPE = True`,
which the port keeps) against fp32 spectra.

Counterpart of `experiments/chain_dtype_ab.py`. The performer circulant
variants with `rpe_config={"method": "chain"}`, trained on the port's chain
(`ops.rotations._dft_chain`, the input dtype) and on `fp32_chain` below,
which this script puts in its place around the fp32 arm's chains; both arms
in one process, timed parent, change, change, parent (`ab_steps.abba`), at
ViT-B widths (dim 768, depth 12, 12 heads, mlp 3072, bf16, dropout 0),
N = 4097 at batch 4.

    python -m efficient_rpe_vit_torch.experiments.chain_dtype_ab [--device cpu]
        [--variants V ...] [--shape IMAGE PATCH BATCH ...]
        [--width DIM DEPTH HEADS MLP] [--steps 8] [--out rows.json]

It sets no dispatch constant: the chain keeps the JAX rounding.
"""

from __future__ import annotations

from ..ops import rotations
from . import ab_steps

VARIANTS = ["performer_favor_circulant", "performer_relu_circulant"]
SHAPES = [(128, 2, 4)]
INDTYPE_CHAIN = rotations._dft_chain


def fp32_chain(x, ct, st, C_f, S_f, C_b, S_b):
    """The chain with fp32 spectra: only the output is rounded to x's dtype
    (the JAX package's CHAIN_INPUT_DTYPE = False)."""
    x32 = x.float()
    x_re, x_im = x32 @ C_f, -(x32 @ S_f)
    y_re, y_im = ct * x_re - st * x_im, st * x_re + ct * x_im
    return (y_re @ C_b - y_im @ S_b).to(x.dtype)


def _chain(fn):
    return lambda: setattr(rotations, "_dft_chain", fn)


ARMS = {"fp32": {"rpe_config": {"method": "chain"}, "enter": _chain(fp32_chain),
                 "leave": _chain(INDTYPE_CHAIN)},
        "indtype": {"rpe_config": {"method": "chain"}}}


def main(argv=None) -> dict:
    ap = ab_steps.parser(__doc__, steps=8)
    ab_steps.width_flags(ap)
    ap.add_argument("--variants", nargs="+", default=VARIANTS)
    args = ap.parse_args(argv)
    device, card = ab_steps.start(args)
    rows = [ab_steps.model_ab(variant, fields, ARMS, args.steps, device)
            for variant in args.variants for fields in ab_steps.shape_fields(args, SHAPES)]
    return ab_steps.emit({"experiment": "chain_dtype_ab", "card": card, "rows": rows}, args.out)


if __name__ == "__main__":
    main()
