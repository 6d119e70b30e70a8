"""Softmax attention, dense: softmax(q k^T / sqrt(D)) v."""

from __future__ import annotations

import torch


def params(config: dict, s: dict):
    """No per-block leaves beyond the shared ones."""
    return []


def attend(q, k, v, leaves: dict, prods) -> torch.Tensor:
    """q, k, v [b, H, N, D] -> [b, H, N, D]."""
    scores = prods.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return prods.matmul(torch.softmax(scores, dim=-1), v)
