"""Attention modules: softmax O(N^2), FAVOR+ O(N) and ReLU O(N).

Counterpart of `efficient_rpe_vit_tpu/models/attention.py`:
  * fused QKV projection, optional bias,
  * softmax: scale d^-1/2, mask and return_attention, KERPLE rejected,
    RoPE / RoPE2D / Circulant-STRING rotate q and k before the core,
    attention-probability dropout in train mode from a seed drawn from the
    caller's generator, the core arm from `method` ('flash', 'dense' = the
    plain [B, H, N, N] formula, or 'auto' = `ops.attention_core.softmax_arm`),
  * the Circulant-STRING rotation's `prefer_kernel` from
    `rotation_prefers_kernel`,
  * linear-attention scale d^-1/4 on both q and k (after the rotation
    under RoPE / RoPE2D / Circulant-STRING), except under KERPLE, which
    L2-normalises q and k instead (clamp inside the sqrt),
  * `fused_phi=True` under KERPLE: phi computed inside the fused-phi KERPLE
    kernel from the normalised q, k and Omega (FAVOR+ and ReLU; hyperbolic
    features raise), the RPE's `method` not consulted; without KERPLE the
    flag changes nothing,
  * FAVOR+, hyperbolic FAVOR+ (2m features) and ReLU feature maps,
  * linear attention raises on return_attention,
  * Omega in the non-trainable buffer `omega` [heads, head_dim, m],
  * optional feature redraw in train mode every `feature_redraw_interval`
    calls, counted in the buffer `redraw_counter` (the JAX package's
    'state' collection), Omega drawn from the caller's generator,
  * phi recomputed in the backward (a checkpoint) once the fp32 phi of one
    of q, k would exceed PHI_CHECKPOINT_BYTES,
  * dropout on the output, masks from the caller's generator,
  * context parallelism (`seq_mesh`, `seq_axis`): the core runs with the
    sequence split over the mesh axis (`parallel/seq_parallel.py`): ring
    softmax, ring KERPLE or the summed linear attention; no masks, no
    return_attention, no attention-probability dropout in training, and
    no fused phi,
  * tensor parallelism (`tp`, set by `parallel.shard_model`): heads / P
    heads of width `inner` = dim / P, the input through `copy_to_group`,
    the projection's partial sums through `reduce_from_group` and its bias
    added once after it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import (
    default_num_features,
    gaussian_features,
    kerple_attention_fused_phi,
    linear_attention,
    orthogonal_gaussian_features,
    phi_hyperbolic,
    phi_positive,
    phi_relu,
    softmax_attention,
)
from ..ops import rotations
from ..ops.attention_core import softmax_arm
from ..ops.feature_maps import mxu_num_features
from ..utils import tracing
from .dense import Dense, Dropout, batch_part, draw, replaying
from .rpe import CirculantStringRPE, KerpleRPE, RoPE, RoPE2D

# Byte size of one fp32 phi (4 * B * H * N * m) past which phi(q) and phi(k)
# are recomputed in the backward instead of keeping their fp32
# intermediates (the JAX package's long-N memory guard); read at call time.
PHI_CHECKPOINT_BYTES = 128 * 1024 ** 2


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, N, C] -> [B, H, N, C/H]"""
    B, N, C = x.shape
    return x.reshape(B, N, heads, C // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, D] -> [B, N, H*D]"""
    B, H, N, D = x.shape
    return x.transpose(1, 2).reshape(B, N, H * D)


def _safe_normalize(t: torch.Tensor) -> torch.Tensor:
    """L2 normalisation with the clamp inside the sqrt (finite on all-zero
    rows), in t's dtype."""
    sq = (t * t).sum(dim=-1, keepdim=True)
    return t / torch.sqrt(torch.clamp(sq, min=1e-24))


def _check_mesh(seq_mesh, seq_axis: str) -> None:
    from ..parallel.mesh import Mesh

    if not isinstance(seq_mesh, Mesh):
        raise TypeError(f"seq_mesh must be a parallel.Mesh, got {type(seq_mesh).__name__}")
    if seq_axis not in seq_mesh:
        raise ValueError(f"seq_mesh {seq_mesh.shape} has no axis {seq_axis!r}")


def _fold_seed(seed: torch.Tensor, k: int) -> torch.Tensor:
    """An int32 dropout seed made distinct for rank part `k` (unchanged for
    k = 0), so that ranks holding other samples or heads draw other
    keep-masks."""
    if k == 0:
        return seed
    v = (seed.long() + k * 0x9E3779B1) % 2 ** 32
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


class _Attention(nn.Module):
    """What the attention modules share: the fused `qkv` and the `proj`,
    `inner` = heads * head_dim (dim alone, dim / P under tensor
    parallelism), and the context- / tensor-parallel wiring."""

    def __init__(self, dim: int, heads: int, dropout: float, qkv_bias: bool,
                 compute_dtype: torch.dtype, seq_mesh, seq_axis: str):
        super().__init__()
        if seq_mesh is not None:
            _check_mesh(seq_mesh, seq_axis)
        self.dim = dim
        self.heads = heads
        self.inner = dim
        self.dropout = dropout
        self.seq_mesh = seq_mesh
        self.seq_axis = seq_axis
        self.tp = None
        self.qkv = Dense(dim, dim * 3, bias=qkv_bias, compute_dtype=compute_dtype)
        self.proj = Dense(dim, dim, compute_dtype=compute_dtype)
        self.drop = Dropout(dropout)

    @property
    def head_dim(self) -> int:
        return self.inner // self.heads

    @property
    def seq_group(self):
        return None if self.seq_mesh is None else self.seq_mesh.get_group(self.seq_axis)

    def _qkv(self, x: torch.Tensor):
        if self.tp is not None:
            from ..parallel.comm import copy_to_group

            x = copy_to_group(x, self.tp.group)
        return (_split_heads(t, self.heads) for t in self.qkv(x).chunk(3, dim=-1))

    def _out(self, out: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """[B, H, N, D] -> the projected [B, N, dim] with output dropout."""
        out = _merge_heads(out)
        if self.tp is None:
            return self.drop(self.proj(out), generator)
        from ..parallel.comm import reduce_from_group

        dt = self.proj.compute_dtype
        y = reduce_from_group(F.linear(out.to(dt), self.proj.weight.to(dt)), self.tp.group)
        return self.drop(y + self.proj.bias.to(dt), generator)


def _rotate(q: torch.Tensor, k: torch.Tensor, rpe: Optional[nn.Module],
            prefer_kernel: bool = False):
    """q and k rotated by a RoPE, RoPE2D or Circulant-STRING rpe; unchanged
    for None and KERPLE, which the caller handles; any other module raises.
    `prefer_kernel` goes to the Circulant-STRING rotation
    (`rotation_prefers_kernel`)."""
    if isinstance(rpe, (RoPE, RoPE2D)):
        return rpe.apply_rotary(q, k)
    if isinstance(rpe, CirculantStringRPE):
        return rpe.rotate(q, k, prefer_kernel=prefer_kernel)
    if rpe is not None and not isinstance(rpe, KerpleRPE):
        raise TypeError(f"unsupported RPE module {type(rpe).__name__}")
    return q, k


def rotation_prefers_kernel(seq_mesh, consumer_is_kernel: bool) -> bool:
    """The `prefer_kernel` an attention module passes to its rotation: no
    context parallelism (the rings run plain code) and a consumer of the
    rotated q and k that is a kernel. Softmax's consumer is a kernel where
    its arm is 'flash' (JAX: `softmax_needs_flash` without
    return_attention); linear attention's is the phi projections, which ask
    for the kernels only under `ops.rotations.KERNEL_BEFORE_PHI`. The JAX
    package also asks for a concrete batch, because a Pallas grid must be
    static; the port's rotation op exports at any batch, so a symbolic
    batch under `torch.export` keeps the kernels."""
    return seq_mesh is None and consumer_is_kernel


_KERPLE_REJECTION = (
    "KERPLE RPE is designed specifically for kernelized attention "
    "(FAVOR+/ReLU Performer) and cannot be used with standard softmax "
    "attention. KERPLE requires linear attention mechanisms to achieve "
    "O(n log n) complexity. For softmax attention, use RoPE or "
    "Circulant-STRING RPE instead."
)


class SoftmaxAttention(_Attention):
    """Standard multi-head softmax attention: fused `qkv` (optional bias),
    scale head_dim^-1/2, `proj`, dropout on the probabilities (train mode)
    and on the output."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.0,
                 qkv_bias: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 method: str = "auto", seq_mesh=None, seq_axis: str = "seq"):
        super().__init__(dim, heads, dropout, qkv_bias, compute_dtype, seq_mesh, seq_axis)
        self.method = method

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                rpe: Optional[nn.Module] = None, return_attention: bool = False,
                generator: Optional[torch.Generator] = None):
        """x [B, N, dim] -> [B, N, dim], and the [B, H, N, N] probabilities
        if return_attention. In train mode with dropout > 0 the
        probabilities' dropout seed (one int32 drawn on x's device, so the
        host never waits) and the output's dropout mask come from
        `generator`."""
        if isinstance(rpe, KerpleRPE):
            raise NotImplementedError(_KERPLE_REJECTION)
        rate = float(self.dropout) if self.training and self.dropout > 0 else 0.0
        if self.seq_mesh is not None:
            if mask is not None or return_attention:
                raise NotImplementedError(
                    "context-parallel softmax attention supports neither "
                    "masks nor return_attention")
            if rate > 0:
                raise NotImplementedError(
                    "context-parallel softmax attention does not support "
                    "attention-probability dropout; set dropout=0 or train "
                    "without seq_mesh")
        q, k, v = self._qkv(x)
        B, H, N, _ = q.shape
        flash = softmax_arm(self.method, B, H, N, return_attention) == "flash"
        q, k = _rotate(q, k, rpe, rotation_prefers_kernel(self.seq_mesh, flash))
        if self.seq_mesh is not None:
            from ..parallel.seq_parallel import ring_softmax_attention

            out = ring_softmax_attention(q, k, v, self.head_dim ** -0.5, self.seq_group)
            return self._out(out, generator)
        seed = None
        if rate > 0:
            if generator is None:
                raise ValueError("train-mode dropout needs a generator: pass "
                                 "one to the model's forward")
            seed = draw(lambda: torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                                              generator=generator, device=x.device))
            row, _ = batch_part()
            tp_index, tp_count = (0, 1) if self.tp is None else (self.tp.index, self.tp.count)
            seed = _fold_seed(seed, row * tp_count + tp_index)
        out = softmax_attention(q, k, v, self.head_dim ** -0.5, mask=mask,
                                return_attention=return_attention,
                                dropout_rate=rate, dropout_seed=seed,
                                method=self.method)
        if return_attention:
            out, weights = out
            return self._out(out, generator), weights
        return self._out(out, generator)


class _KernelAttention(_Attention):
    """Shared machinery for FAVOR+, hyperbolic FAVOR+ and ReLU linear
    attention."""

    feature_kind: str = "favor_plus"  # overridden by subclasses

    def __init__(self, dim: int, heads: int, dropout: float = 0.0,
                 num_features: Union[int, str, None] = None,
                 use_orthogonal: bool = True,
                 feature_redraw_interval: Optional[int] = None,
                 qkv_bias: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 fused_phi: bool = False, seq_mesh=None, seq_axis: str = "seq"):
        super().__init__(dim, heads, dropout, qkv_bias, compute_dtype, seq_mesh, seq_axis)
        self.fused_phi = fused_phi
        self.num_features = num_features
        self.use_orthogonal = use_orthogonal
        self.feature_redraw_interval = feature_redraw_interval
        self.register_buffer("omega", torch.empty(heads, self.head_dim, self.m))
        if feature_redraw_interval is not None:
            self.register_buffer("redraw_counter",
                                 torch.zeros((), dtype=torch.int32))
        # the count `redraw_counter` holds, when the host knows it: set by a
        # K-step CUDA-graph program (`train.training._HostCounts`) for the
        # calls it runs, so that no call reads the card
        self.host_count: Optional[int] = None

    @property
    def m(self) -> int:
        if self.num_features == "mxu":
            return mxu_num_features(self.head_dim)
        return (
            self.num_features
            if self.num_features is not None
            else default_num_features(self.head_dim)
        )

    def draw_omega(self, generator: torch.Generator) -> torch.Tensor:
        """Omega of every head from `generator`; under tensor parallelism
        the whole model's heads are drawn and this rank's are kept."""
        sample = (orthogonal_gaussian_features if self.use_orthogonal
                  else gaussian_features)
        index, count = (0, 1) if self.tp is None else (self.tp.index, self.tp.count)
        omega = sample(generator, self.heads * count, self.head_dim, self.m)
        return omega[index * self.heads:(index + 1) * self.heads]

    def _phi(self, x: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
        if self.feature_kind == "favor_plus":
            return phi_positive(x, omega)
        if self.feature_kind == "favor_hyper":
            return phi_hyperbolic(x, omega)
        return phi_relu(x, omega)

    def _phi_pair(self, q: torch.Tensor, k: torch.Tensor,
                  omega: torch.Tensor):
        with tracing.device_span("rpe.phi", q.device) as span:
            q, k = span.inputs(q, k)
            return span.outputs(self._phi(q, omega), self._phi(k, omega))

    @torch.no_grad()
    def _maybe_redraw(self, generator: Optional[torch.Generator]) -> None:
        """Train mode: redraw Omega on the calls where counter % interval ==
        0 (the first call included), then count the call."""
        if generator is None:
            raise ValueError("feature redraw in train mode needs a generator: "
                             "pass one to the model's forward")
        # the host decides, so that the QR draw runs only on the redraw
        # calls: from the count a graphed program gave it, else by reading
        # the counter (on the GPU, a sync per block and call)
        if self.host_count is None:
            count = int(self.redraw_counter)
        else:
            count = self.host_count
            self.host_count += 1
        if count % self.feature_redraw_interval == 0:
            self.omega.copy_(self.draw_omega(generator))
        self.redraw_counter += 1

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                rpe: Optional[nn.Module] = None, return_attention: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`mask` is taken and not applied, as in the JAX module: linear
        attention has no [N, N] matrix to mask."""
        if return_attention:
            raise NotImplementedError(
                "Linear attention doesn't compute explicit attention "
                "matrices. Returning attention weights would require O(N^2) "
                "computation."
            )
        # a recomputed block (ViT remat) neither redraws nor counts again
        if (self.training and self.feature_redraw_interval is not None
                and not replaying()):
            self._maybe_redraw(generator)
        q, k, v = self._qkv(x)

        q, k = _rotate(q, k, rpe, rotation_prefers_kernel(self.seq_mesh,
                                                          rotations.KERNEL_BEFORE_PHI))
        use_kerple = isinstance(rpe, KerpleRPE)
        if use_kerple:
            # L2 normalisation for stability (Luo et al. 2021 §3.3, Thm 3);
            # no d^-1/4 scale on this branch
            q, k = _safe_normalize(q), _safe_normalize(k)
        else:
            scale = self.head_dim ** -0.25  # d^-1/4 on both q and k
            q, k = q * scale, k * scale

        if self.fused_phi and use_kerple and self.seq_mesh is None:
            if self.feature_kind not in ("favor_plus", "relu"):
                raise NotImplementedError(
                    f"fused_phi supports favor_plus/relu, not {self.feature_kind}")
            out = kerple_attention_fused_phi(q.contiguous(), k.contiguous(),
                                             v.contiguous(), self.omega,
                                             rpe.coeffs(), self.feature_kind)
            return self._out(out, generator)

        B, H, N, _ = q.shape
        if torch.is_grad_enabled() and 4 * B * H * N * self.m > PHI_CHECKPOINT_BYTES:
            # keep only q', k' (the attention core saves them anyway); phi's
            # fp32 intermediates are recomputed in the backward. phi draws
            # no random numbers, so no RNG state needs restoring.
            q_prime, k_prime = checkpoint(self._phi_pair, q, k, self.omega,
                                          use_reentrant=False,
                                          preserve_rng_state=False)
        else:
            q_prime, k_prime = self._phi_pair(q, k, self.omega)
        if self.seq_mesh is not None:
            from ..parallel.seq_parallel import (
                ring_kerple_attention,
                seq_parallel_linear_attention,
            )

            if use_kerple:
                out = ring_kerple_attention(q_prime, k_prime, v, rpe.coeffs(), self.seq_group)
            else:
                out = seq_parallel_linear_attention(q_prime, k_prime, v, self.seq_group)
        elif use_kerple:
            out = rpe.attention(q_prime, k_prime, v.contiguous())
        else:
            out = linear_attention(q_prime, k_prime, v)
        return self._out(out, generator)


class FavorPlusAttention(_KernelAttention):
    """FAVOR+ positive-random-feature attention (Choromanski et al. 2020)."""

    feature_kind = "favor_plus"


class ReluAttention(_KernelAttention):
    """ReLU-feature linear attention."""

    feature_kind = "relu"


class FavorHyperAttention(_KernelAttention):
    """Positive hyperbolic random features (Performer paper, Lemma 1):
    antithetic +/- projection pairs, 2m features."""

    feature_kind = "favor_hyper"


# name -> class, with aliases (the JAX package's registry)
ATTENTION_REGISTRY = {
    "softmax": SoftmaxAttention,
    "baseline": SoftmaxAttention,
    "favor_plus": FavorPlusAttention,
    "favor+": FavorPlusAttention,
    "performer": FavorPlusAttention,
    "relu": ReluAttention,
    "favor_hyper": FavorHyperAttention,
}
