"""Model-level A/B of softmax attention on the flash kernels against the
dense arm: full ViT-B `baseline` train steps.

Counterpart of `experiments/flash_crossover.py`. The same ViT-B model
(dim 768, depth 12, 12 heads, mlp 3072, bf16, mnist_config's one channel,
dropout 0) trained with `attention_config={"method": "dense"}` and with
`{"method": "flash"}`, both arms in one process, timed parent, change,
change, parent (`ab_steps.abba`). The shapes are the JAX script's (N = 577,
785, 1025 at batch 32, 24, 16), N = 197 at batch 64 and shorter sequences
(N = 65 at batch 192, N = 17 at batch 256) that bracket the crossover from
below.

    python -m efficient_rpe_vit_torch.experiments.flash_crossover [--device cpu]
        [--shape IMAGE PATCH BATCH ...] [--width DIM DEPTH HEADS MLP]
        [--steps 10] [--out rows.json]

These rows, not `flash_ab`'s isolated ones, set `FLASH_MIN_N`
(`ops/attention_core.py`).
"""

from __future__ import annotations

from . import ab_steps

# (image, patch, batch) at patch 2: N = (image / 2)^2 + 1
SHAPES = [(8, 2, 256), (16, 2, 192), (28, 2, 64), (48, 2, 32), (56, 2, 24), (64, 2, 16)]
ARMS = {"dense": {"attention_config": {"method": "dense"}},
        "flash": {"attention_config": {"method": "flash"}}}


def main(argv=None) -> dict:
    ap = ab_steps.parser(__doc__, steps=10)
    ab_steps.width_flags(ap)
    args = ap.parse_args(argv)
    device, card = ab_steps.start(args)
    rows = [ab_steps.model_ab("baseline", fields, ARMS, args.steps, device)
            for fields in ab_steps.shape_fields(args, SHAPES)]
    return ab_steps.emit({"experiment": "flash_crossover", "card": card, "rows": rows},
                         args.out)


if __name__ == "__main__":
    main()
