"""Random-feature maps for linear attention (FAVOR+ and ReLU-Performer).

Counterpart of `efficient_rpe_vit_tpu/ops/feature_maps.py`:
  * positive random features phi+(x) = exp(x@Omega - max - ||x||^2/2)/sqrt(m),
  * positive hyperbolic features (2m of them, `favor_hyper`),
  * ReLU features phi(x) = relu(x@Omega)/sqrt(m),
  * per-head orthogonal Omega via blockwise QR, scaled by sqrt(head_dim).

Omega is drawn from an explicit `torch.Generator`; the projection runs in
fp32 whatever the input dtype (the JAX version promotes the bf16 input
against the fp32 Omega the same way) and the features come back in the
input dtype. `phi_positive` runs on its two hand-written kernels
(`ops/kernels/phi_positive.py`) where `phi_kernel_takes` holds, and as the
plain chain of PyTorch passes (`phi_positive_plain`) everywhere else.
"""

from __future__ import annotations

import math

import torch


def default_num_features(head_dim: int) -> int:
    """Performer-paper default m = floor(d_h * ln d_h)."""
    return int(head_dim * math.log(head_dim))


def mxu_num_features(head_dim: int) -> int:
    """`num_features='mxu'`: the paper default rounded to the nearest
    multiple of 128, never below 128 (same values as the JAX package, so a
    config means the same model in both)."""
    return max(128, 128 * round(default_num_features(head_dim) / 128))


def gaussian_features(generator: torch.Generator, heads: int, head_dim: int,
                      num_features: int) -> torch.Tensor:
    """i.i.d. N(0,1) feature matrix, shape [heads, head_dim, num_features],
    on the generator's device."""
    return torch.randn((heads, head_dim, num_features), generator=generator,
                       device=generator.device)


def orthogonal_gaussian_features(generator: torch.Generator, heads: int,
                                 head_dim: int,
                                 num_features: int) -> torch.Tensor:
    """Blockwise-orthogonal random features, shape [heads, head_dim, m].

    Draws ceil(m / d) Gaussian d×d blocks per head, orthonormalises each with
    QR, concatenates columns, truncates to m, scales by sqrt(d) so row norms
    match the Gaussian case in expectation.
    """
    num_blocks = -(-num_features // head_dim)  # ceil
    g = torch.randn((heads, num_blocks, head_dim, head_dim),
                    generator=generator, device=generator.device)
    q, _ = torch.linalg.qr(g)  # batched QR over [heads, blocks]
    # [heads, blocks, d, d] -> [heads, d, blocks*d]: omega[h, i, b*d+j] = q[h, b, i, j]
    omega = q.permute(0, 2, 1, 3).reshape(heads, head_dim, num_blocks * head_dim)
    return omega[:, :, :num_features] * math.sqrt(head_dim)


def _project(x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """[B, H, N, D] @ [H, D, M] -> contiguous fp32 [B, H, N, M] (the
    features feed kernels that take contiguous tensors)."""
    return torch.matmul(x.float(), omega.float())


# the kernels' limits (csrc/phi_positive.cu): head dims, features
PHI_KERNEL_MAX_D = 64
PHI_KERNEL_MAX_F = 272


def phi_kernel_takes(x: torch.Tensor, omega: torch.Tensor,
                     device_rule: bool = True) -> bool:
    """Whether `phi_positive(x, omega)` runs on the phi+ kernels: CUDA
    tensors, or any while `torch.export` traces (so that an artifact
    exported on the CPU holds the op and launches the kernel once moved to
    the card; `device_rule` off: any device), x bf16 [B, H, N, D] with D <=
    64 and D % 8 == 0, Omega fp32 [H, D, F] without a gradient, F even and
    <= 272, H and N not empty. Decided from shapes, dtypes and devices
    alone, before any call; everything else (CPU tensors outside an export,
    fp32 compute, odd or wide F, an Omega that needs a gradient) takes the
    plain chain."""
    if (device_rule and not (x.is_cuda and omega.is_cuda)
            and not torch.compiler.is_exporting()):
        return False
    if x.dim() != 4 or omega.dim() != 3 or x.dtype != torch.bfloat16:
        return False
    if omega.dtype != torch.float32 or omega.requires_grad:
        return False
    _, H, N, D = x.shape
    F = omega.shape[-1]
    return (tuple(omega.shape[:2]) == (H, D) and H > 0 and N > 0
            and 0 < D <= PHI_KERNEL_MAX_D and D % 8 == 0
            and 0 < F <= PHI_KERNEL_MAX_F and F % 2 == 0)


def phi_keeps_fp32(kind: str, x: torch.Tensor, omega: torch.Tensor) -> bool:
    """Whether the feature map `kind` ("favor_plus", "favor_hyper" or
    "relu") keeps fp32 [B, H, N, M] intermediates for its backward on these
    inputs: every map but phi+ on its kernels, whose backward recomputes the
    projection and keeps only x."""
    return not (kind == "favor_plus" and phi_kernel_takes(x, omega))


def phi_positive_plain(x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """phi+ as the chain of PyTorch passes (see `phi_positive`)."""
    m = omega.shape[-1]
    proj = _project(x, omega)
    proj_max = proj.amax(dim=-1, keepdim=True).detach()
    x_norm_sq_half = (x * x).sum(dim=-1, keepdim=True) / 2.0
    phi = torch.exp(proj - proj_max - x_norm_sq_half) / math.sqrt(m)
    return phi.to(x.dtype)


def phi_positive(x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Positive random features for the softmax kernel (FAVOR+).

    phi+(x) = exp(x@Omega - rowmax(x@Omega) - ||x||^2 / 2) / sqrt(m)

    The per-row max is a detached stabiliser; ||x||^2/2 is taken in the
    input dtype, as the JAX version does. Where `phi_kernel_takes(x,
    omega)` holds, one forward and one backward kernel compute the same
    function (the projection fp32-exact, Omega never rounded); elsewhere
    the plain chain (`phi_positive_plain`) runs.

    Args:
        x: [B, H, N, D] queries or keys.
        omega: [H, D, M] random feature matrix.
    Returns:
        [B, H, N, M] positive features in x's dtype.
    """
    if phi_kernel_takes(x, omega):
        from .kernels.phi_positive import phi_positive_kernel

        return phi_positive_kernel(x, omega)
    return phi_positive_plain(x, omega)


def phi_hyperbolic(x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Positive hyperbolic random features (Performer paper, Lemma 1):

    phi_hyp(x) = exp(-||x||^2/2) / sqrt(2m) * [exp(x@Omega); exp(-x@Omega)]

    Both signs of each projection (an antithetic pair), so 2m features; the
    stabiliser is the detached per-row max of |x@Omega|.

    Args:
        x: [B, H, N, D].
        omega: [H, D, M].
    Returns:
        [B, H, N, 2M] positive features in x's dtype.
    """
    m = omega.shape[-1]
    proj = _project(x, omega)
    stab = proj.abs().amax(dim=-1, keepdim=True).detach()
    x_norm_sq_half = (x * x).sum(dim=-1, keepdim=True) / 2.0
    pos = torch.exp(proj - stab - x_norm_sq_half)
    neg = torch.exp(-proj - stab - x_norm_sq_half)
    return (torch.cat([pos, neg], dim=-1) / math.sqrt(2 * m)).to(x.dtype)


def phi_relu(x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """ReLU random features phi(x) = relu(x@Omega)/sqrt(m).

    Args:
        x: [B, H, N, D].
        omega: [H, D, M].
    Returns:
        [B, H, N, M] non-negative features in x's dtype.
    """
    m = omega.shape[-1]
    return (torch.relu(_project(x, omega)) / math.sqrt(m)).to(x.dtype)
