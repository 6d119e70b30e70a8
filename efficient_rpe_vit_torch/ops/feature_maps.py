"""Random-feature maps for linear attention (FAVOR+ and ReLU-Performer).

Counterpart of `efficient_rpe_vit_tpu/ops/feature_maps.py`:
  * positive random features phi+(x) = exp(x@Omega - max - ||x||^2/2)/sqrt(m),
  * positive hyperbolic features (2m of them, `favor_hyper`),
  * ReLU features phi(x) = relu(x@Omega)/sqrt(m),
  * per-head orthogonal Omega via blockwise QR, scaled by sqrt(head_dim).

Omega is drawn from an explicit `torch.Generator`; the projection runs in
fp32 whatever the input dtype (the JAX version promotes the bf16 input
against the fp32 Omega the same way) and the features come back in the
input dtype.
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


def phi_positive(x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Positive random features for the softmax kernel (FAVOR+).

    phi+(x) = exp(x@Omega - rowmax(x@Omega) - ||x||^2 / 2) / sqrt(m)

    The per-row max is a detached stabiliser; ||x||^2/2 is taken in the
    input dtype, as the JAX version does.

    Args:
        x: [B, H, N, D] queries or keys.
        omega: [H, D, M] random feature matrix.
    Returns:
        [B, H, N, M] positive features in x's dtype.
    """
    m = omega.shape[-1]
    proj = _project(x, omega)
    proj_max = proj.amax(dim=-1, keepdim=True).detach()
    x_norm_sq_half = (x * x).sum(dim=-1, keepdim=True) / 2.0
    phi = torch.exp(proj - proj_max - x_norm_sq_half) / math.sqrt(m)
    return phi.to(x.dtype)


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
