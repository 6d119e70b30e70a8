"""Model-level A/B of the Circulant-STRING rotation on its kernels against
the plain DFT chain: full ViT-B train steps.

Counterpart of `experiments/rotation_kernel_ab.py`. Each circulant variant
trained with `rpe_config={"method": "chain"}` and with `{"method":
"pallas"}`, both arms in one process, timed parent, change, change, parent
(`ab_steps.abba`), at ViT-B widths (dim 768, depth 12, 12 heads, mlp 3072,
bf16, dropout 0), N = 197 at batch 64 and N = 4097 at batch 4.
`baseline_circulant`'s softmax runs on the flash kernels in both arms: the
rotated q and k feed a kernel there, and the φ projections in the two
performer variants.

    python -m efficient_rpe_vit_torch.experiments.rotation_kernel_ab [--device cpu]
        [--variants V ...] [--shape IMAGE PATCH BATCH ...]
        [--width DIM DEPTH HEADS MLP] [--steps 8] [--out rows.json]

These rows set the rotation rule (`ops/rotations.py::rotation_kernel_enabled`
and who passes `prefer_kernel`).
"""

from __future__ import annotations

from . import ab_steps

VARIANTS = ["baseline_circulant", "performer_favor_circulant", "performer_relu_circulant"]
SHAPES = [(28, 2, 64), (128, 2, 4)]


def main(argv=None) -> dict:
    ap = ab_steps.parser(__doc__, steps=8)
    ab_steps.width_flags(ap)
    ap.add_argument("--variants", nargs="+", default=VARIANTS)
    args = ap.parse_args(argv)
    device, card = ab_steps.start(args)
    rows = []
    for variant in args.variants:
        attention = {"method": "flash"} if variant.startswith("baseline") else None
        arms = {arm: {"attention_config": attention, "rpe_config": {"method": arm}}
                for arm in ("chain", "pallas")}
        rows += [ab_steps.model_ab(variant, fields, arms, args.steps, device)
                 for fields in ab_steps.shape_fields(args, SHAPES)]
    return ab_steps.emit({"experiment": "rotation_kernel_ab", "card": card, "rows": rows},
                         args.out)


if __name__ == "__main__":
    main()
