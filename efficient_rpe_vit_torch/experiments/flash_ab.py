"""Isolated A/B of softmax attention on the flash kernels against the dense
arm.

Counterpart of `experiments/flash_ab.py`: q, k, v normal in bf16 at
B=8 H=4 D=64 and N in {197, 512, 1024, 2048, 4096}, scale D^-1/2, no mask,
no dropout; forward, and forward + backward (gradients of sum(out^2) over
q, k, v), each arm through `softmax_attention(..., method=)`. Each time is
`utils/timing.py::chained_time` (CUDA events on the card).

    python -m efficient_rpe_vit_torch.experiments.flash_ab [--device cpu]
        [--sizes N ...] [--batch 8 --heads 4 --head-dim 64] [--steps 20]
        [--out rows.json]

An isolated win does not set `FLASH_MIN_N`: `flash_crossover` does, at the
model level.
"""

from __future__ import annotations

import functools

import torch

from ..ops.attention_core import softmax_attention
from ..utils.timing import chained_time
from . import ab_steps

SIZES = (197, 512, 1024, 2048, 4096)
ARMS = ("dense", "flash")


def _grad(method, scale, q, k, v):
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = softmax_attention(*leaves, scale, method=method)
    return torch.autograd.grad((out ** 2).sum().float(), leaves)


def bench(N, steps, B=8, H=4, D=64, device=None):
    """(forward, forward + backward) seconds per call of each arm."""
    g = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(B, H, N, D, generator=g, device=device).to(torch.bfloat16)
               for _ in range(3))
    scale = D ** -0.5
    fwd, grad = {}, {}
    for method in ARMS:
        fwd[method] = chained_time(
            lambda q, k, v, m=method: softmax_attention(q, k, v, scale, method=m),
            (q, k, v), steps, lambda cur, out: (cur[0], cur[1], cur[2] + 0 * out))
        grad[method] = chained_time(
            functools.partial(_grad, method, scale), (q, k, v), max(5, steps // 2),
            lambda cur, out: (cur[0] + 0 * out[0], cur[1], cur[2]))
    return fwd, grad


def main(argv=None) -> dict:
    ap = ab_steps.parser(__doc__, steps=20)
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--head-dim", type=int, default=64)
    args = ap.parse_args(argv)
    device, card = ab_steps.start(args)
    rows = []
    for N in args.sizes:
        fwd, grad = bench(N, args.steps, args.batch, args.heads, args.head_dim, device)
        rows.append({"N": N, "B": args.batch, "H": args.heads, "D": args.head_dim,
                     "fwd_ms": {k: t * 1e3 for k, t in fwd.items()},
                     "grad_ms": {k: t * 1e3 for k, t in grad.items()},
                     "fwd_winner": min(fwd, key=fwd.get),
                     "grad_winner": min(grad, key=grad.get)})
        ab_steps.log(f"flash_ab {rows[-1]}")
        ab_steps.release()
    return ab_steps.emit({"experiment": "flash_ab", "card": card,
                          "rows": rows}, args.out)


if __name__ == "__main__":
    main()
