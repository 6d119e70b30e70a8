"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Counterpart of `efficient_rpe_vit_tpu/ops/pallas/`. CUDA sources live in
`efficient_rpe_vit_torch/csrc/` and are built by `_build.py` on first use.
"""

# the differentiable `circulant_rotate` stays in its module of the same name
from .circulant_rotate import (
    circulant_rotate_bwd,
    circulant_rotate_bwd_reference,
    circulant_rotate_fwd,
    circulant_rotate_fwd_reference,
)
from .flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_softmax_attention,
    flash_softmax_attention_reference,
)
from .masked_linear_coeffs import (
    kerple_attention_fused_phi,
    kerple_attention_fused_phi_fwd,
    kerple_attention_fused_phi_fwd_reference,
    masked_linear_attention_coeffs,
    masked_linear_attention_coeffs_bwd,
    masked_linear_attention_coeffs_bwd_reference,
    masked_linear_attention_coeffs_fwd,
    masked_linear_attention_coeffs_reference,
)

__all__ = [
    "circulant_rotate_bwd",
    "circulant_rotate_bwd_reference",
    "circulant_rotate_fwd",
    "circulant_rotate_fwd_reference",
    "flash_attention_bwd",
    "flash_attention_bwd_reference",
    "flash_attention_fwd",
    "flash_softmax_attention",
    "flash_softmax_attention_reference",
    "kerple_attention_fused_phi",
    "kerple_attention_fused_phi_fwd",
    "kerple_attention_fused_phi_fwd_reference",
    "masked_linear_attention_coeffs",
    "masked_linear_attention_coeffs_bwd",
    "masked_linear_attention_coeffs_bwd_reference",
    "masked_linear_attention_coeffs_fwd",
    "masked_linear_attention_coeffs_reference",
]
