from .fft_toeplitz import toeplitz_diag_sums, toeplitz_from_coeffs
from .feature_maps import (
    default_num_features,
    gaussian_features,
    mxu_num_features,
    orthogonal_gaussian_features,
    phi_positive,
    phi_relu,
)
from .attention_core import (
    EPS,
    softmax_attention,
    linear_attention,
    kerple_linear_attention,
    masked_linear_vjp_residual,
)

__all__ = [
    "toeplitz_diag_sums",
    "toeplitz_from_coeffs",
    "default_num_features",
    "gaussian_features",
    "mxu_num_features",
    "orthogonal_gaussian_features",
    "phi_positive",
    "phi_relu",
    "EPS",
    "softmax_attention",
    "linear_attention",
    "kerple_linear_attention",
    "masked_linear_vjp_residual",
]
