"""A/B of Toeplitz-masked linear attention over a materialised T (the
hand-written kernels) against the plain dense KERPLE arm.

Counterpart of `experiments/pallas_ab.py`: the same shapes (the ViT head-dim
bench shape B=256 H=2 N=197 F=44 D=16, a longer N, and wider heads), the
same input draws (|normal| x 0.2 for q' and k', normal v, all bf16;
coefficients exp(0.05 normal)), from a seeded `torch.Generator` (the JAX
draws cannot be reproduced), and the same rows:

    fwd_dense, fwd_pallas                   forward
    grad_dense                              grads over (q', k', v), dense arm
    grad_pallas_jnp, grad_pallas_fused      the same through
        `fused_masked_linear_attention` with bwd_mode 'jnp_residual' (the
        residual formula in PyTorch) and 'pallas' (the backward kernels)
    grad_pallas_fused_t                     'pallas' with T's gradient too,
        as the JAX package's oracle tests take it: the row that runs the dT
        kernel, which a gradient over (q', k', v) alone never launches

Each row is the median seconds per call of chained calls
(`utils/timing.py::chained_time`, CUDA events on the card). Run it as

    python -m efficient_rpe_vit_torch.experiments.pallas_ab [--device cpu]
        [--shape B H N F D ...] [--steps 20]

It runs on the GPU unless `--device cpu` is given, and raises without one.
The first line printed is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import functools
from typing import Dict, Optional

import torch

from ..ops.attention_core import kerple_linear_attention
from ..ops.fft_toeplitz import toeplitz_from_coeffs
from ..ops.kernels import masked_linear as ml
from ..utils.device import resolve_device
from ..utils.timing import chained_time, device_label

SHAPES = [(256, 2, 197, 44, 16), (8, 2, 1024, 44, 16), (32, 4, 512, 128, 64)]
ROWS = ("fwd_dense", "fwd_pallas", "grad_dense", "grad_pallas_jnp",
        "grad_pallas_fused", "grad_pallas_fused_t")
# the wrappers whose launches each row's run records
WRAPPERS = {"masked_linear_fwd": ml.masked_linear_fwd,
            "masked_linear_bwd_dq": ml.masked_linear_bwd_dq,
            "masked_linear_bwd_dkv": ml.masked_linear_bwd_dkv,
            "masked_linear_bwd_dt": ml.masked_linear_bwd_dt}


def make_inputs(B, H, N, F, D, device):
    """(q', k', v in bf16, coeffs [H, 2N-1] fp32), drawn as the JAX script
    draws them, from a generator seeded with 0."""
    g = torch.Generator(device=device).manual_seed(0)
    qp, kp = ((torch.randn(B, H, N, F, generator=g, device=device)
               .to(torch.bfloat16).abs() * 0.2) for _ in range(2))
    v = torch.randn(B, H, N, D, generator=g, device=device).to(torch.bfloat16)
    coeffs = torch.exp(torch.randn(H, 2 * N - 1, generator=g, device=device) * 0.05)
    return qp, kp, v, coeffs


# the backward of each row through `fused_masked_linear_attention`
BWD_MODE = {"fwd_pallas": "auto", "grad_pallas_jnp": "jnp_residual",
            "grad_pallas_fused": "pallas", "grad_pallas_fused_t": "pallas"}


def _attention(row: str, qp, kp, v, c, t=None):
    """The row's forward: the dense arm, or the kernel op over T (built
    from c unless given)."""
    if row not in BWD_MODE:
        return kerple_linear_attention(qp, kp, v, c, method="dense")
    t = toeplitz_from_coeffs(c, qp.shape[2]) if t is None else t
    return ml.fused_masked_linear_attention(qp, kp, v, t, bwd_mode=BWD_MODE[row])


def _grads(row: str, qp, kp, v, c):
    """Gradients of sum(out^2) over (q', k', v), and T for
    grad_pallas_fused_t."""
    leaves = [x.detach().requires_grad_() for x in (qp, kp, v)]
    t = None
    if row == "grad_pallas_fused_t":
        t = toeplitz_from_coeffs(c, qp.shape[2]).requires_grad_()
        leaves.append(t)
    loss = (_attention(row, *leaves[:3], c, t) ** 2).sum().float()
    return torch.autograd.grad(loss, leaves)


def run_row(row: str, qp, kp, v, c):
    """One call of a row: the forward output, or the tuple of gradients."""
    return (_attention if row.startswith("fwd_") else _grads)(row, qp, kp, v, c)


def _fwd_feedback(cur, out):
    return cur[0], cur[1], cur[2] + 0 * out.to(cur[2].dtype), cur[3]


def _grad_feedback(cur, out):
    return cur[0] + 0 * out[0].to(cur[0].dtype), cur[1], cur[2], cur[3]


def bench_shape(B, H, N, F, D, steps: int = 20, device=None,
                launches: Optional[Dict[str, Dict[str, int]]] = None
                ) -> Dict[str, float]:
    """Seconds per call of each row of ROWS at one shape (forward rows over
    `steps` chained calls, gradient rows over max(10, steps // 2)).

    Args:
        device: where to run; None means the GPU, and raises without one.
        launches: when given, filled with row -> {wrapper: launches} made
            by that row's run (warm-up included).
    """
    device = resolve_device(device)
    args = make_inputs(B, H, N, F, D, device)
    rows = {}
    for row in ROWS:
        before = {k: w.launches for k, w in WRAPPERS.items()}
        fwd = row.startswith("fwd_")
        rows[row] = chained_time(functools.partial(run_row, row), args,
                                 steps if fwd else max(10, steps // 2),
                                 _fwd_feedback if fwd else _grad_feedback)
        if launches is not None:
            launches[row] = {k: w.launches - before[k] for k, w in WRAPPERS.items()}
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="'cpu' for the CPU; default: the GPU (raises without one)")
    parser.add_argument("--shape", type=int, nargs=5, action="append",
                        metavar=("B", "H", "N", "F", "D"),
                        help="a shape to run (repeatable); default: the JAX script's three")
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print(device_label(device), flush=True)
    for B, H, N, F, D in args.shape or SHAPES:
        rows = bench_shape(B, H, N, F, D, steps=args.steps, device=device)
        pretty = "  ".join(f"{k}={v * 1e3:.4f}ms" for k, v in rows.items())
        print(f"B={B} H={H} N={N} F={F} D={D}: {pretty}", flush=True)


if __name__ == "__main__":
    main()
