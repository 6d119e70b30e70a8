"""FAVOR+ with KERPLE, dense: q and k L2-normalised, positive random
features phi+(x) = exp(x Omega - max_row(x Omega) - |x|^2 / 2) / sqrt(M)
(the row max detached), the Toeplitz matrix T[i, j] = exp(b[j - i + N - 1])
built whole, out = (W v) / (W 1 + 1e-6) with W = (phi(q) phi(k)^T) * T
(Luo et al. 2021, KERPLE; Choromanski et al. 2020, FAVOR+)."""

from __future__ import annotations

import math

import torch

EPS = 1e-6


def params(config: dict, s: dict):
    """Per-block leaves beyond the shared ones: (suffix, shape, init)."""
    return [("attention.omega", (s["H"], s["D"], config["num_features"]), "omega"),
            ("rpe.rel_pos_bias", (s["H"], 2 * s["N"] - 1), "kerple_bias")]


def _normalise(t: torch.Tensor) -> torch.Tensor:
    return t / torch.sqrt(torch.clamp((t * t).sum(-1, keepdim=True), min=1e-24))


def attend(q, k, v, leaves: dict, prods) -> torch.Tensor:
    """q, k, v [b, H, N, D] -> [b, H, N, D]."""
    omega = leaves["attention.omega"]
    m = omega.shape[-1]

    def phi(x):
        proj = prods.matmul(x, omega)
        top = proj.amax(-1, keepdim=True).detach()
        return torch.exp(proj - top - (x * x).sum(-1, keepdim=True) / 2.0) / math.sqrt(m)

    qp, kp = phi(_normalise(q)), phi(_normalise(k))
    n = q.shape[2]
    pos = torch.arange(n, device=q.device)
    t = torch.exp(leaves["rpe.rel_pos_bias"])[:, pos[None, :] - pos[:, None] + n - 1]
    w = prods.matmul(qp, kp.transpose(-1, -2)) * t
    return prods.matmul(w, v) / (w.sum(-1, keepdim=True) + EPS)
