"""Isolated A/B of the Circulant-STRING rotation kernels against the plain
DFT chain at the ViT-B long-N shape.

Counterpart of `experiments/rot_isolated_ab.py`: one rotation of x
[4, 12, 4097, 64] bf16 with CLS kept (normal x, coefficients 0.01 normal,
the 64 x 64 patch grid's positions, the angle tables computed once), by
the kernel (`circulant_rotate(..., keep_cls=True)`) and by the chain
(`_dft_chain` with the JAX rounding, then CLS selected back), forward and
forward + backward (the gradient of sum(out^2) over x). Each time is
`utils/timing.py::chained_time`: each rotation takes the previous one's
output, CUDA events on the card (no dispatch floor to subtract there).

    python -m efficient_rpe_vit_torch.experiments.rot_isolated_ab [--device cpu]
        [--shape B H N D] [--steps 16] [--out rows.json]

An isolated win does not set the rotation rule: `rotation_kernel_ab` does.
"""

from __future__ import annotations

import functools

import torch

from ..ops.kernels.circulant_rotate import circulant_rotate
from ..ops.rotations import (_circulant_theta, _dft_chain, _rdft_matrices, _with_cls_position,
                             grid_positions_2d)
from ..utils.timing import chained_time
from . import ab_steps

SHAPE = (4, 12, 4097, 64)
ARMS = ("chain", "kernel")


def _chain(x, ct, st, mats):
    is_cls = (torch.arange(x.shape[2], device=x.device) == 0)[None, None, :, None]
    return torch.where(is_cls, x, _dft_chain(x, ct[None], st[None], *mats))


def _grad(rotate, x):
    x = x.detach().requires_grad_()
    return torch.autograd.grad((rotate(x).float() ** 2).sum(), x)[0]


def bench(B, H, N, D, steps, device):
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(B, H, N, D, generator=g, device=device).to(torch.bfloat16)
    coeffs = torch.randn(H, 2, D, generator=g, device=device) * 0.01
    theta = _circulant_theta(_with_cls_position(grid_positions_2d(N - 1)), coeffs, D)
    ct, st = torch.cos(theta), torch.sin(theta)
    rotate = {"kernel": lambda y: circulant_rotate(y, ct, st, keep_cls=True),
              "chain": functools.partial(_chain, ct=ct, st=st,
                                         mats=_rdft_matrices(D, device))}
    fwd = {arm: chained_time(rotate[arm], (x,), steps, lambda cur, out: (out,))
           for arm in ARMS}
    grad = {arm: chained_time(functools.partial(_grad, rotate[arm]), (x,), steps,
                              lambda cur, out: (cur[0] + 0 * out,))
            for arm in ARMS}
    return fwd, grad


def main(argv=None) -> dict:
    ap = ab_steps.parser(__doc__, steps=16)
    ap.add_argument("--shape", type=int, nargs=4, metavar=("B", "H", "N", "D"),
                    default=list(SHAPE))
    args = ap.parse_args(argv)
    device, card = ab_steps.start(args)
    B, H, N, D = args.shape
    fwd, grad = bench(B, H, N, D, args.steps, device)
    row = {"shape": [B, H, N, D], "dtype": "bfloat16",
           "fwd_ms": {k: t * 1e3 for k, t in fwd.items()},
           "grad_ms": {k: t * 1e3 for k, t in grad.items()}}
    ab_steps.log(f"rot_isolated_ab {row}")
    return ab_steps.emit({"experiment": "rot_isolated_ab", "card": card, "rows": [row]},
                         args.out)


if __name__ == "__main__":
    main()
