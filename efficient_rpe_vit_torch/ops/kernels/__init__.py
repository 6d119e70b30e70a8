"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Counterpart of `efficient_rpe_vit_tpu/ops/pallas/`. CUDA sources live in
`efficient_rpe_vit_torch/csrc/` and are built by `_build.py` on first use.
Importing this package registers the forward kernels as `torch.library`
custom ops (`_library.py`), which exported programs name.
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
from .masked_linear import (
    fused_masked_linear_attention,
    masked_linear_bwd,
    masked_linear_bwd_reference,
    masked_linear_fwd,
    masked_linear_fwd_reference,
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
from .phi_positive import (
    phi_positive_bwd,
    phi_positive_bwd_reference,
    phi_positive_fwd,
    phi_positive_kernel,
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
    "fused_masked_linear_attention",
    "kerple_attention_fused_phi",
    "kerple_attention_fused_phi_fwd",
    "kerple_attention_fused_phi_fwd_reference",
    "masked_linear_attention_coeffs",
    "masked_linear_attention_coeffs_bwd",
    "masked_linear_attention_coeffs_bwd_reference",
    "masked_linear_attention_coeffs_fwd",
    "masked_linear_attention_coeffs_reference",
    "masked_linear_bwd",
    "masked_linear_bwd_reference",
    "masked_linear_fwd",
    "masked_linear_fwd_reference",
    "phi_positive_bwd",
    "phi_positive_bwd_reference",
    "phi_positive_fwd",
    "phi_positive_kernel",
]
