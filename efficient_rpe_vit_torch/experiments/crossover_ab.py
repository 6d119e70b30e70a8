"""Isolated A/B of KERPLE's three arms and of the raw Toeplitz product's two.

Counterpart of `experiments/crossover_ab.py`. KERPLE linear attention by the
dense arm, the `fft` arm (`torch.fft`) and the hand-written kernel
(`"pallas"`), forward and forward + backward (gradients of sum(out^2) over
q', k', v), at N in {197, 256, 512, 1024, 2048, 4096}, on the JAX script's
inputs (|normal| x 0.2 for q' and k', normal v, bf16; coefficients
exp(0.05 normal)) at its default B=8 H=2 F=44 D=16 (flags change them).
Then `toeplitz_matmul` by `"dense"` against `"fft"` at [8, 2, N, 44] and
[2, 12, N, 266] bf16. Each time is `utils/timing.py::chained_time` (each
call's input depends on the previous output; CUDA events on the card).

    python -m efficient_rpe_vit_torch.experiments.crossover_ab [--device cpu]
        [--sizes N ...] [--batch 8 --heads 2 --features 44 --head-dim 16]
        [--toeplitz B H F ...] [--steps 30] [--out rows.json]

The rows set `KERPLE_DENSE_CROSSOVER_N` only together with the model-level
rows of `kerple_pallas_ab`, and the Toeplitz window (`FFT_MIN_N`,
`FFT_MAX_N`, `FFT_MAX_D`) of `ops/fft_toeplitz.py`.
"""

from __future__ import annotations

import functools

import torch

from ..ops.attention_core import kerple_linear_attention
from ..ops.fft_toeplitz import toeplitz_matmul
from ..utils.timing import chained_time
from . import ab_steps
from .pallas_ab import make_inputs

SIZES = (197, 256, 512, 1024, 2048, 4096)
KERPLE_ARMS = ("dense", "fft", "pallas")
TOEPLITZ_ARMS = ("dense", "fft")
# (B, H, F) of the Toeplitz product's input [B, H, N, F]: the JAX table's
# MNIST-width D2 and ViT-B's (F = 266 at head dim 64)
TOEPLITZ_SHAPES = ((8, 2, 44), (2, 12, 266))


def _kerple_loss(method, qp, kp, v, c):
    return (kerple_linear_attention(qp, kp, v, c, method=method) ** 2).sum().float()


def _kerple_grad(method, qp, kp, v, c):
    leaves = [x.detach().requires_grad_() for x in (qp, kp, v)]
    return torch.autograd.grad(_kerple_loss(method, *leaves, c), leaves)


def bench_kerple(N, steps, B=8, H=2, F=44, D=16, device=None):
    """Seconds per call of each arm, forward and forward + backward."""
    args = make_inputs(B, H, N, F, D, device)
    fwd, grad = {}, {}
    for method in KERPLE_ARMS:
        fwd[method] = chained_time(
            functools.partial(kerple_linear_attention, method=method), args, steps,
            lambda cur, out: (cur[0], cur[1], cur[2] + 0 * out.to(cur[2].dtype), cur[3]))
        grad[method] = chained_time(
            functools.partial(_kerple_grad, method), args, max(5, steps // 2),
            lambda cur, out: (cur[0] + 0 * out[0].to(cur[0].dtype), *cur[1:]))
    return fwd, grad


def bench_toeplitz(N, steps, B=8, H=2, F=44, device=None):
    """Seconds per `toeplitz_matmul` call of each arm at [B, H, N, F] bf16."""
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(B, H, N, F, generator=g, device=device).to(torch.bfloat16)
    c = torch.exp(torch.randn(H, 2 * N - 1, generator=g, device=device) * 0.05)
    return {method: chained_time(
        functools.partial(toeplitz_matmul, method=method), (c, x), steps,
        lambda cur, out: (cur[0], cur[1] + 0 * out.to(cur[1].dtype)))
        for method in TOEPLITZ_ARMS}


def run(sizes, steps, B, H, F, D, toeplitz_shapes, device) -> dict:
    kerple, toeplitz = [], []
    for N in sizes:
        fwd, grad = bench_kerple(N, steps, B, H, F, D, device)
        kerple.append({"N": N, "B": B, "H": H, "F": F, "D": D,
                       "fwd_ms": {k: t * 1e3 for k, t in fwd.items()},
                       "grad_ms": {k: t * 1e3 for k, t in grad.items()},
                       "fwd_winner": min(fwd, key=fwd.get),
                       "grad_winner": min(grad, key=grad.get)})
        ab_steps.log(f"kerple N={N}: {kerple[-1]}")
        ab_steps.release()
    for tb, th, tf in toeplitz_shapes:
        for N in sizes:
            ms = bench_toeplitz(N, steps, tb, th, tf, device)
            toeplitz.append({"shape": [tb, th, N, tf], "ms": {k: t * 1e3 for k, t in ms.items()},
                             "winner": min(ms, key=ms.get)})
            ab_steps.log(f"toeplitz {toeplitz[-1]}")
        ab_steps.release()
    return {"experiment": "crossover_ab", "kerple": kerple, "toeplitz": toeplitz}


def main(argv=None) -> dict:
    ap = ab_steps.parser(__doc__, steps=30)
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--features", type=int, default=44)
    ap.add_argument("--head-dim", type=int, default=16)
    ap.add_argument("--toeplitz", type=int, nargs=3, action="append", metavar=("B", "H", "F"),
                    help="a Toeplitz input shape (repeatable); default: the two of the table")
    args = ap.parse_args(argv)
    device, card = ab_steps.start(args)
    result = run(args.sizes, args.steps, args.batch, args.heads, args.features, args.head_dim,
                 args.toeplitz or TOEPLITZ_SHAPES, device)
    result["card"] = card
    return ab_steps.emit(result, args.out)


if __name__ == "__main__":
    main()
