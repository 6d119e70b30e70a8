from .fft_toeplitz import toeplitz_from_coeffs
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
    linear_attention,
    kerple_linear_attention,
)

__all__ = [
    "toeplitz_from_coeffs",
    "default_num_features",
    "gaussian_features",
    "mxu_num_features",
    "orthogonal_gaussian_features",
    "phi_positive",
    "phi_relu",
    "EPS",
    "linear_attention",
    "kerple_linear_attention",
]
