"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Counterpart of `efficient_rpe_vit_tpu/ops/pallas/`. CUDA sources live in
`efficient_rpe_vit_torch/csrc/` and are built by `_build.py` on first use.
"""

from .masked_linear_coeffs import (
    masked_linear_attention_coeffs,
    masked_linear_attention_coeffs_fwd,
    masked_linear_attention_coeffs_reference,
)

__all__ = [
    "masked_linear_attention_coeffs",
    "masked_linear_attention_coeffs_fwd",
    "masked_linear_attention_coeffs_reference",
]
