"""Model-level A/B of KERPLE on the hand-written kernels against the dense
arm: full train steps of the flagship, `performer_favor_most_general`.

Counterpart of `experiments/kerple_pallas_ab.py`. The flagship trained with
`rpe_config={"method": "dense"}` and with `{"method": "pallas"}`, both arms
in one process, timed parent, change, change, parent (`ab_steps.abba`):
at ViT-B widths (dim 768, depth 12, 12 heads, mlp 3072, bf16, dropout 0)
N = 197 at batch 64 and N = 1025 at batch 16, the JAX script's shapes,
with N = 65 at batch 192 and N = 17 at batch 256 below them; then at the
headline's `mnist_config` widths (dim 32, depth 3, 2 heads, F = 44, bf16,
dropout 0) N = 197 at batch 256 and the train CLI's N = 17 at batch 32.

    python -m efficient_rpe_vit_torch.experiments.kerple_pallas_ab [--device cpu]
        [--shape IMAGE PATCH BATCH ...] [--width DIM DEPTH HEADS MLP]
        [--steps 10] [--out rows.json]

(--shape / --width replace both groups.) These rows set
`KERPLE_DENSE_CROSSOVER_N` (`ops/attention_core.py`).
"""

from __future__ import annotations

from . import ab_steps

VITB_SHAPES = [(8, 2, 256), (16, 2, 192), (28, 2, 64), (64, 2, 16)]
# the headline's mnist_config widths: patch 2 (N = 197) and the CLI's patch 7 (N = 17)
MNIST_WIDTHS = dict(ab_steps.VITB_WIDTHS, dim=32, depth=3, heads=2, mlp_dim=64)
MNIST_SHAPES = [(28, 2, 256), (28, 7, 32)]
ARMS = {"dense": {"rpe_config": {"method": "dense"}},
        "pallas": {"rpe_config": {"method": "pallas"}}}


def main(argv=None) -> dict:
    ap = ab_steps.parser(__doc__, steps=10)
    ab_steps.width_flags(ap)
    args = ap.parse_args(argv)
    device, card = ab_steps.start(args)
    runs = ab_steps.shape_fields(args, VITB_SHAPES)
    if args.shape is None and args.width is None:
        runs += [dict(MNIST_WIDTHS, image_size=i, patch_size=p, batch_size=b)
                 for i, p, b in MNIST_SHAPES]
    rows = [ab_steps.model_ab("performer_favor_most_general", fields, ARMS, args.steps, device)
            for fields in runs]
    return ab_steps.emit({"experiment": "kerple_pallas_ab", "card": card, "rows": rows},
                         args.out)


if __name__ == "__main__":
    main()
