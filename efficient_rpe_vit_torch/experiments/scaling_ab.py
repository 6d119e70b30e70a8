"""Linear against softmax attention across N at a fixed token budget, and
the memory walls of the dense softmax and dense KERPLE train steps.

Counterpart of `experiments/scaling_ab.py`. First, forward + backward
(gradients of sum(out^2)) at H=8 D=64 F=266 bf16, B = 32768 // N, N in
{256, 1024, 4096, 16384}: softmax by the dense arm and by the flash
kernels, and linear attention over |normal| x 0.2 features
(`utils/timing.py::chained_time`, CUDA events on the card; a dense row that
runs out of memory is recorded as such).

Then the walls: full ViT-B train steps (dim 768, depth 12, 12 heads, mlp
3072, bf16, dropout 0, patch 2) of `baseline` with
`attention_config={"method": "dense"}` and of the flagship with
`rpe_config={"method": "dense"}`, at N = 1025 and 4097, the batch doubled
from 1 until a step runs out of the card's memory, then one batch between
the last that fit and the first that did not. Each attempt records two
steps' peak allocated bytes and the bytes the dispatch rules count for one
layer: 3 B H N^2 4 for softmax (`softmax_needs_flash`), 5 B H N^2 4 for
KERPLE (`kerple_arm`).

    python -m efficient_rpe_vit_torch.experiments.scaling_ab [--device cpu]
        [--sizes N ...] [--token-budget 32768] [--wall-images 64 128]
        [--wall-max 256] [--width DIM DEPTH HEADS MLP]
        [--steps 10] [--out rows.json]

The walls set `SOFTMAX_DENSE_MEMORY_BUDGET` and `KERPLE_DENSE_MEMORY_BUDGET`.
"""

from __future__ import annotations

import functools
import gc

import torch

from ..configs import mnist_config
from ..ops.attention_core import linear_attention, softmax_attention
from ..utils.timing import chained_time
from . import ab_steps

SIZES = (256, 1024, 4096, 16384)
WALL_IMAGES = (64, 128)  # patch 2: N = 1025, 4097
WALLS = {"softmax": ("baseline", {"attention_config": {"method": "dense"}}, 3),
         "kerple": ("performer_favor_most_general", {"rpe_config": {"method": "dense"}}, 5)}


def _grad(fn, a, b, v):
    leaves = [x.detach().requires_grad_() for x in (a, b, v)]
    return torch.autograd.grad((fn(*leaves) ** 2).sum().float(), leaves)


def _timed(fn, args, steps):
    try:
        return chained_time(functools.partial(_grad, fn), args, steps,
                            lambda cur, out: (cur[0] + 0 * out[0], cur[1], cur[2]))
    except torch.cuda.OutOfMemoryError:
        return None


def bench(N, steps, token_budget=32768, H=8, D=64, F=266, device=None):
    """(B, {arm: forward + backward seconds or None when out of memory})."""
    B = max(1, token_budget // N)
    g = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(B, H, N, D, generator=g, device=device).to(torch.bfloat16)
               for _ in range(3))
    qp, kp = ((torch.randn(B, H, N, F, generator=g, device=device).abs() * 0.2)
              .to(torch.bfloat16) for _ in range(2))
    scale = D ** -0.5
    times = {"softmax_dense": _timed(functools.partial(softmax_attention, scale=scale,
                                                       method="dense"), (q, k, v), steps)}
    ab_steps.release()
    times["softmax_flash"] = _timed(functools.partial(softmax_attention, scale=scale,
                                                      method="flash"), (q, k, v), steps)
    times["linear"] = _timed(linear_attention, (qp, kp, v), steps)
    return B, times


def _wall_attempt(variant, arm, fields, device):
    """(whether two train steps fit, their peak allocated bytes: None on the
    CPU, where nothing measures it)."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        step = ab_steps.StepArm(variant, mnist_config(**fields), device, **arm)
        step.chain(2)
    except torch.cuda.OutOfMemoryError:
        return False, None
    finally:
        step = None
        gc.collect()
        ab_steps.release()
    return True, torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def wall(rule, image, w, wall_max, device) -> dict:
    """The batches tried for one rule at one N, doubling from 1, then one
    between the last that fit and the first that did not."""
    variant, arm, temps = WALLS[rule]
    N = ab_steps.seq_len(image, 2)
    tried = {}

    def attempt(B):
        fits, peak = _wall_attempt(variant, arm, dict(w, image_size=image, patch_size=2,
                                                      batch_size=B), device)
        tried[B] = {"batch": B, "fits": fits, "peak_bytes": peak,
                    "rule_bytes": temps * B * w["heads"] * N * N * 4}
        ab_steps.log(f"wall {rule} N={N}: {tried[B]}")
        return fits

    B, fit, fail = 1, None, None
    while B <= wall_max:
        if not attempt(B):
            fail = B
            break
        fit, B = B, 2 * B
    if fit is not None and fail is not None and fail - fit > 1:
        mid = (fit + fail) // 2
        if attempt(mid):
            fit = mid
        else:
            fail = mid
    return {"rule": rule, "variant": variant, "N": N, "temps": temps,
            "largest_fit": tried[fit] if fit is not None else None,
            "first_failure": tried[fail] if fail is not None else None,
            "attempts": [tried[b] for b in sorted(tried)]}


def main(argv=None) -> dict:
    ap = ab_steps.parser(__doc__, steps=10)
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--token-budget", type=int, default=32768)
    ap.add_argument("--wall-images", type=int, nargs="+", default=list(WALL_IMAGES))
    ap.add_argument("--wall-max", type=int, default=256)
    ap.add_argument("--width", type=int, nargs=4, default=None,
                    metavar=("DIM", "DEPTH", "HEADS", "MLP"))
    args = ap.parse_args(argv)
    device, card = ab_steps.start(args)
    rows = []
    for N in args.sizes:
        B, times = bench(N, args.steps, args.token_budget, device=device)
        rows.append({"N": N, "B": B, "H": 8, "D": 64, "F": 266,
                     "grad_ms": {k: (None if t is None else t * 1e3) for k, t in times.items()}})
        ab_steps.log(f"scaling {rows[-1]}")
        ab_steps.release()
    w = ab_steps.widths(args)
    walls = [wall(rule, image, w, args.wall_max, device)
             for rule in WALLS for image in args.wall_images]
    total = (torch.cuda.get_device_properties(device).total_memory
             if device.type == "cuda" else None)
    return ab_steps.emit({"experiment": "scaling_ab", "card": card, "device_bytes": total,
                          "rows": rows, "walls": walls}, args.out)


if __name__ == "__main__":
    main()
