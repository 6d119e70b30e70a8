"""Model-level A/B of φ fused into the KERPLE forward kernel against φ
computed beside it: full ViT-B train steps at long N.

Counterpart of `experiments/fused_phi_ab.py`. Both `*_most_general`
variants trained with and without `attention_config={"fused_phi": True}`,
both arms in one process, timed parent, change, change, parent
(`ab_steps.abba`), at ViT-B widths (dim 768, depth 12, 12 heads, mlp 3072,
bf16, dropout 0), N = 4097 at batch 4.

    python -m efficient_rpe_vit_torch.experiments.fused_phi_ab [--device cpu]
        [--variants V ...] [--shape IMAGE PATCH BATCH ...]
        [--width DIM DEPTH HEADS MLP] [--steps 8] [--out rows.json]

It sets no dispatch constant: `fused_phi` stays a config flag.
"""

from __future__ import annotations

from . import ab_steps

VARIANTS = ["performer_favor_most_general", "performer_relu_most_general"]
SHAPES = [(128, 2, 4)]
ARMS = {"unfused_phi": {}, "fused_phi": {"attention_config": {"fused_phi": True}}}


def main(argv=None) -> dict:
    ap = ab_steps.parser(__doc__, steps=8)
    ab_steps.width_flags(ap)
    ap.add_argument("--variants", nargs="+", default=VARIANTS)
    args = ap.parse_args(argv)
    device, card = ab_steps.start(args)
    rows = [ab_steps.model_ab(variant, fields, ARMS, args.steps, device)
            for variant in args.variants for fields in ab_steps.shape_fields(args, SHAPES)]
    return ab_steps.emit({"experiment": "fused_phi_ab", "card": card, "rows": rows}, args.out)


if __name__ == "__main__":
    main()
