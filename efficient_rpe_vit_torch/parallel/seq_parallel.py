"""Sequence-parallel (context-parallel) attention cores.

Counterpart of `efficient_rpe_vit_tpu/parallel/seq_parallel.py`. Each
function takes replicated [B, H, N, .] tensors and the process group of a
'seq' mesh axis, and returns the replicated [B, H, N, D] output, as the
JAX `shard_map` does: the sequence is zero-padded to a multiple of the
group size P, each rank takes its N / P rows (`scatter_seq`), runs its
part, and the rows are gathered back (`gather_seq`).

  * `seq_parallel_linear_attention`: the summaries sum_j phi(k_j)^T v_j
    and sum_j phi(k_j) are plain sums, so each rank makes its part and one
    `psum` completes them; exact.
  * `ring_softmax_attention`: (k, v) blocks go round the ring while each
    rank keeps the online-softmax statistics (m, l, o) of its queries;
    padded key columns are masked to a large finite negative value. The
    backward is a second ring: each block's probabilities are recomputed
    from the saved log-sum-exp, dq accumulates locally, and the dk / dv
    accumulators ride the ring with their block until they are back at
    their owner.
  * `ring_kerple_attention`: the same ring over Toeplitz-weighted products
    (no max correction: the weights are positive and just add); the block
    from rank `src` sees coeffs[(src - idx) * n_local + (j - i) + N - 1];
    for a padded N the coefficients are re-centred. The coefficients enter
    through `copy_to_group`, so their gradient, which each rank makes from
    its own queries, is summed over the group.

Point-to-point ops have no autograd, so the rings are autograd Functions.
Their bodies are plain PyTorch products in fp32, as the JAX bodies are
einsums outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.attention_core import EPS
from .comm import copy_to_group, gather_seq, psum, ring_exchange, scatter_seq

# finite mask for padded ring-softmax columns: keeps the running max finite
# (a -inf max would make the correction exp(m - m_new) NaN)
_MASK = -0.7 * torch.finfo(torch.float32).max


def _pad_seq(x: torch.Tensor, p: int) -> torch.Tensor:
    """Zero-pad the sequence axis (2) up to a multiple of p."""
    return F.pad(x, (0, 0, 0, (-x.shape[2]) % p))


def _split(group, *tensors):
    p = dist.get_world_size(group)
    return [scatter_seq(_pad_seq(t, p), group) for t in tensors]


def seq_parallel_linear_attention(q_prime: torch.Tensor, k_prime: torch.Tensor,
                                  v: torch.Tensor, group) -> torch.Tensor:
    """Linear attention with the sequence split over `group`: equal to
    `ops.linear_attention` on one device. As the JAX body does, the
    summed phi(k) stays fp32."""
    n = q_prime.shape[2]
    q, k, v_l = _split(group, q_prime, k_prime, v)
    kv = psum(torch.einsum("bhnf,bhnd->bhfd", k.float(), v_l.float()), group)
    k_sum = psum(k.float().sum(dim=2), group)
    qf = q.float()
    num = torch.einsum("bhnf,bhfd->bhnd", qf, kv)
    den = torch.einsum("bhnf,bhf->bhn", qf, k_sum)
    out = (num / (den[..., None] + EPS)).to(v.dtype)
    return gather_seq(out, group)[:, :, :n]


def _ring_steps(group):
    p, idx = dist.get_world_size(group), dist.get_rank(group)
    return p, idx, [(step, (idx - step) % p) for step in range(p)]


class _RingSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, n_valid, group):
        p, idx, steps = _ring_steps(group)
        B, H, nl, D = q.shape
        qf = q.float()
        m = torch.full((B, H, nl, 1), -torch.inf, device=q.device)
        l = torch.zeros((B, H, nl, 1), device=q.device)
        o = torch.zeros((B, H, nl, D), device=q.device)
        j_loc = torch.arange(nl, device=q.device)
        k_blk, v_blk = k, v
        for step, src in steps:
            s = torch.einsum("bhnd,bhmd->bhnm", qf, k_blk.float()) * scale
            s = torch.where(src * nl + j_loc < n_valid, s, _MASK)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            pr = torch.exp(s - m_new)
            l = alpha * l + pr.sum(dim=-1, keepdim=True)
            o = alpha * o + torch.einsum("bhnm,bhmd->bhnd", pr, v_blk.float())
            m = m_new
            if step < p - 1:
                k_blk, v_blk = ring_exchange([k_blk, v_blk], group)
        l = torch.where(l == 0.0, 1.0, l)
        out = o / l
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.scale, ctx.n_valid, ctx.group = scale, n_valid, group
        return out.to(v.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        scale, group = ctx.scale, ctx.group
        p, idx, steps = _ring_steps(group)
        nl = q.shape[2]
        qf, do = q.float(), dout.float()
        delta = (do * out).sum(dim=-1, keepdim=True)
        j_loc = torch.arange(nl, device=q.device)
        dq = torch.zeros_like(qf)
        k_blk, v_blk = k, v
        dk = torch.zeros(k.shape, device=k.device)
        dv = torch.zeros(v.shape, device=v.device)
        for step, src in steps:
            kb = k_blk.float()
            s = torch.einsum("bhnd,bhmd->bhnm", qf, kb) * scale
            s = torch.where(src * nl + j_loc < ctx.n_valid, s, _MASK)
            pr = torch.exp(s - lse)
            dv = dv + torch.einsum("bhnm,bhnd->bhmd", pr, do)
            ds = pr * (torch.einsum("bhnd,bhmd->bhnm", do, v_blk.float()) - delta)
            dq = dq + torch.einsum("bhnm,bhmd->bhnd", ds, kb) * scale
            dk = dk + torch.einsum("bhnm,bhnd->bhmd", ds, qf) * scale
            if step < p - 1:
                k_blk, v_blk, dk, dv = ring_exchange([k_blk, v_blk, dk, dv], group)
            elif p > 1:  # the accumulators go home
                dk, dv = ring_exchange([dk, dv], group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float, group) -> torch.Tensor:
    """softmax(q k^T * scale) v with the sequence split over `group` (ring
    attention, non-causal): per-rank memory O((N/P)^2), per step one
    (k, v) block sent to the next rank. Any N: the sequence is zero-padded
    and padded key columns are masked."""
    n = q.shape[2]
    ql, kl, vl = _split(group, q, k, v)
    out = _RingSoftmax.apply(ql, kl, vl, scale, n, group)
    return gather_seq(out, group)[:, :, :n]


def _toeplitz_block(coeffs, src, idx, nl, n_global):
    i = torch.arange(nl, device=coeffs.device)
    rel = (src - idx) * nl + (i[None, :] - i[:, None]) + n_global - 1
    return coeffs[:, rel], rel  # [H, nl, nl]


class _RingKerple(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, coeffs, group):
        p, idx, steps = _ring_steps(group)
        B, H, nl, _ = q.shape
        qf = q.float()
        num = torch.zeros((B, H, nl, v.shape[-1]), device=q.device)
        den = torch.zeros((B, H, nl), device=q.device)
        k_blk, v_blk = k, v
        for step, src in steps:
            T, _ = _toeplitz_block(coeffs, src, idx, nl, nl * p)
            W = torch.einsum("bhif,bhjf->bhij", qf, k_blk.float()) * T
            num = num + torch.einsum("bhij,bhjd->bhid", W, v_blk.float())
            den = den + W.sum(dim=-1)
            if step < p - 1:
                k_blk, v_blk = ring_exchange([k_blk, v_blk], group)
        out = num / (den[..., None] + EPS)
        ctx.save_for_backward(q, k, v, coeffs, out, den)
        ctx.group = group
        return out.to(v.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, coeffs, out, den = ctx.saved_tensors
        group = ctx.group
        p, idx, steps = _ring_steps(group)
        H, nl = q.shape[1], q.shape[2]
        qf, do = q.float(), dout.float()
        inv = 1.0 / (den + EPS)
        d_num = do * inv[..., None]
        d_den = -(do * out).sum(dim=-1) * inv
        dq = torch.zeros_like(qf)
        dk = torch.zeros(k.shape, device=k.device)
        dv = torch.zeros(v.shape, device=v.device)
        dcoeffs = torch.zeros_like(coeffs)
        k_blk, v_blk = k, v
        for step, src in steps:
            T, rel = _toeplitz_block(coeffs, src, idx, nl, nl * p)
            kb = k_blk.float()
            A = torch.einsum("bhif,bhjf->bhij", qf, kb)
            dv = dv + torch.einsum("bhij,bhid->bhjd", A * T, d_num)
            dW = torch.einsum("bhid,bhjd->bhij", d_num, v_blk.float()) + d_den[..., None]
            dA = dW * T
            dq = dq + torch.einsum("bhij,bhjf->bhif", dA, kb)
            dk = dk + torch.einsum("bhij,bhif->bhjf", dA, qf)
            dcoeffs.index_add_(1, rel.reshape(-1), (dW * A).sum(dim=0).reshape(H, -1))
            if step < p - 1:
                k_blk, v_blk, dk, dv = ring_exchange([k_blk, v_blk, dk, dv], group)
            elif p > 1:  # the accumulators go home
                dk, dv = ring_exchange([dk, dv], group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dcoeffs, None


def ring_kerple_attention(q_prime: torch.Tensor, k_prime: torch.Tensor, v: torch.Tensor,
                          coeffs: torch.Tensor, group) -> torch.Tensor:
    """KERPLE attention with the sequence split over `group`, as a ring:
    equal to `ops.kerple_linear_attention` on one device. The [N, N]
    weights never exist whole; per-rank memory is O((N/P)^2).

    Args:
        q_prime, k_prime: [B, H, N, F]; v: [B, H, N, D].
        coeffs: [H, 2N-1] positive Toeplitz coefficients (replicated); for
            an N that the group does not divide they re-centre into a
            [H, 2 * N_pad - 1] table (offsets out of range only ever meet
            zero-padded phi(k) rows).
    """
    n = q_prime.shape[2]
    p = dist.get_world_size(group)
    pad = (-n) % p
    coeffs = copy_to_group(F.pad(coeffs.float(), (pad, pad)), group)
    ql, kl, vl = _split(group, q_prime, k_prime, v)
    out = _RingKerple.apply(ql, kl, vl, coeffs, group)
    return gather_seq(out, group)[:, :, :n]
