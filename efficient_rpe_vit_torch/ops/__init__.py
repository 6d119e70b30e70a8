from .fft_toeplitz import toeplitz_diag_sums, toeplitz_from_coeffs
from .feature_maps import (
    default_num_features,
    gaussian_features,
    mxu_num_features,
    orthogonal_gaussian_features,
    phi_hyperbolic,
    phi_positive,
    phi_relu,
)
from .rotations import (
    apply_block_circulant_rotation,
    apply_circulant_rotation,
    apply_circulant_string,
    apply_rope,
    apply_rope_2d,
    circulant_eigenvalues,
    grid_positions_2d,
    rope_2d_tables,
    rope_tables,
)
from .attention_core import (
    EPS,
    softmax_attention,
    linear_attention,
    kerple_linear_attention,
    masked_linear_vjp_residual,
)
from .kernels import kerple_attention_fused_phi

__all__ = [
    "toeplitz_diag_sums",
    "toeplitz_from_coeffs",
    "default_num_features",
    "gaussian_features",
    "mxu_num_features",
    "orthogonal_gaussian_features",
    "phi_hyperbolic",
    "phi_positive",
    "phi_relu",
    "apply_block_circulant_rotation",
    "apply_circulant_rotation",
    "apply_circulant_string",
    "apply_rope",
    "apply_rope_2d",
    "circulant_eigenvalues",
    "grid_positions_2d",
    "rope_2d_tables",
    "rope_tables",
    "EPS",
    "softmax_attention",
    "linear_attention",
    "kerple_linear_attention",
    "masked_linear_vjp_residual",
    "kerple_attention_fused_phi",
]
