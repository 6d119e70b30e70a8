"""The products of the plain reference, in the precision it is run at.

`fp32`: every product in float32 with TF32 off (`float32_products` turns it
off for the reference's run and restores the setting after). `fp8`: the
control, one precision below the configuration's bfloat16: both operands of
every product rounded to float8 e4m3 with a per-tensor scale (amax to 448),
the product accumulated in float32, and the gradient flowing back into the
product rounded to float8 e5m2 (amax to 57344), the common fp8 training
recipe. The roundings pass gradients straight through.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = top / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Gradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class Products:
    """`matmul(a, b)` and `linear(x, w, b)` at one precision."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp32":
            return torch.matmul(a, b)
        return _Gradient.apply(torch.matmul(_Operand.apply(a), _Operand.apply(b)))

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        y = self.matmul(x, w.t())
        return y if b is None else y + b


@contextlib.contextmanager
def float32_products():
    """TF32 off for matmuls and convolutions, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
