"""The Segment Anything image encoder (Kirillov et al. 2023, arXiv:2304.02643).

Counterpart of `segment_anything/modeling/image_encoder.py::ImageEncoderViT`
as `build_sam_vit_h` configures it, with a pooled classification head added
so that it trains on labelled images: a 16 x 16 patch embedding (a strided
convolution, here one product over the (C, p, p) patches) and an absolute
position embedding [1, S, S, dim] on NHWC tokens without a CLS token; pre-norm
blocks (LayerNorm eps 1e-6, qkv with bias, exact GELU), windowed in all but
the global blocks: the normed tokens zero-padded to a multiple of the window
and cut into windows, which attend within themselves, padded tokens
included, then are put back and cropped; every block's softmax attention
with SAM's decomposed relative-position bias

    S = (scale q) k^T + rel_h + rel_w,
    rel_h[i, kh] = q_i . Rh[qh(i) - kh + K - 1],  rel_w[i, kw] = q_i . Rw[qw(i) - kw + K - 1]

(q unscaled, K the attended grid's side, tables [2K - 1, head_dim]); the
neck (1 x 1 conv, LayerNorm2d, 3 x 3 conv, LayerNorm2d, no biases); then
the head: the mean over the neck's grid and a linear layer in fp32.

Leaf names are the SAM state dict's (`patch_embed.proj`, `pos_embed`,
`blocks.{i}.norm1`, `.attn.qkv`, `.attn.proj`, `.attn.rel_pos_h`,
`.attn.rel_pos_w`, `.norm2`, `.mlp.lin1`, `.mlp.lin2`, `neck.0` to
`neck.3`) plus `head.weight`, `head.bias`. Parameters are fp32, cast to the
compute dtype where used; LayerNorm takes fp32 statistics (`dense.py`).

The attention runs on the flash kernels with the bias
(`ops/kernels/flash_attention.py`, `rel_pos`); the bias rows are computed
here from unscaled q and the tables, gathered by a product with a constant
one-hot matrix, whose backward (a product too) sums the tables' gradient in
a fixed order, where an indexed gather's backward would accumulate with
atomics. Device spans (`utils/tracing.py`, with their backwards): the window
copies `rpe.window`, the bias rows `rpe.relpos`, and the op `rpe.attn_window`
or `rpe.attn_global`.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels._library import real_constants
from ..ops.kernels.flash_attention import flash_softmax_attention
from ..utils import tracing
from .dense import Dense, LayerNorm, torch_dtype
from .vit import patchify

# build_sam_vit_h: encoder_embed_dim 1280, depth 32, 16 heads,
# global_attn_indexes [7, 15, 23, 31]; ImageEncoderViT's mlp_ratio 4,
# patch 16, window 14, out_chans 256: what `create_model("sam_vit_h", ...)`
# builds, SamImageEncoder's architecture arguments
SAM_VIT_H = dict(dim=1280, depth=32, heads=16, mlp_dim=5120, patch_size=16, window_size=14,
                 global_attn_indexes=(7, 15, 23, 31), out_chans=256)
LN_EPS = 1e-6


def window_partition(x: torch.Tensor, window: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """[B, H, W, C] -> ([B * nh * nw, window, window, C], (Hp, Wp)): zero
    padding to multiples of `window`, then the windows in row-major order."""
    B, H, W, C = x.shape
    pad_h, pad_w = (window - H % window) % window, (window - W % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window, window, Wp // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C), (Hp, Wp)


def window_unpartition(windows: torch.Tensor, window: int, padded: Tuple[int, int],
                       size: Tuple[int, int]) -> torch.Tensor:
    """The inverse of `window_partition`, cropped back to `size`."""
    (Hp, Wp), (H, W) = padded, size
    B = windows.shape[0] // (Hp * Wp // window // window)
    x = windows.view(B, Hp // window, Wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W, :].contiguous()


def relative_one_hot(side: int) -> torch.Tensor:
    """[side * side, 2 side - 1] fp32: row (a, b) picks table row a - b +
    side - 1, the relative offset SAM's `get_rel_pos` indexes (query and
    key grids of one side)."""
    a = torch.arange(side)
    index = (a[:, None] - a[None, :] + side - 1).reshape(-1)
    return F.one_hot(index, 2 * side - 1).float()


@functools.cache
def _one_hot(side: int, device: torch.device) -> torch.Tensor:
    """`relative_one_hot(side)` on `device`, made once, outside any trace or
    capture mode, and kept out of the module's state (a constant, not a
    leaf)."""
    with real_constants():
        return relative_one_hot(side).to(device)


class ConvNHWC(nn.Module):
    """A k x k convolution on NHWC tokens as one product in the compute
    dtype, weight [out, in, k, k] as torch's Conv2d names it: stride k (the
    patch embedding) or stride 1 with zero padding (k - 1) / 2 (the neck)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int,
                 bias: bool, compute_dtype: torch.dtype):
        super().__init__()
        if stride not in (1, kernel) or (stride == 1 and kernel % 2 == 0):
            raise ValueError(f"stride {kernel} or an odd kernel at stride 1, got kernel "
                             f"{kernel}, stride {stride}")
        self.kernel, self.stride, self.compute_dtype = kernel, stride, compute_dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, in] -> [B, H / stride, W / stride, out]."""
        dt, k = self.compute_dtype, self.kernel
        B, H, W, _ = x.shape
        w = self.weight.reshape(self.weight.shape[0], -1).to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        if k == 1:
            cols = x.to(dt)
        elif self.stride == k:
            cols = patchify(x.to(dt), k).view(B, H // k, W // k, -1)
        else:  # (C, kh, kw) columns of every position, as F.unfold orders them
            cols = F.unfold(x.to(dt).permute(0, 3, 1, 2), k, padding=(k - 1) // 2)
            cols = cols.transpose(1, 2).reshape(B, H, W, -1)
        return F.linear(cols, w, bias)


class SamAttention(nn.Module):
    """Multi-head softmax attention over a [B, h, w, dim] grid of tokens
    with the decomposed relative-position bias of a grid of side `side`."""

    def __init__(self, dim: int, heads: int, side: int, windowed: bool,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.heads, self.head_dim = heads, dim // heads
        self.scale = self.head_dim ** -0.5
        self.side, self.windowed = side, windowed
        self.qkv = Dense(dim, 3 * dim, bias=True, compute_dtype=compute_dtype)
        self.proj = Dense(dim, dim, compute_dtype=compute_dtype)
        self.rel_pos_h = nn.Parameter(torch.empty(2 * side - 1, self.head_dim))
        self.rel_pos_w = nn.Parameter(torch.empty(2 * side - 1, self.head_dim))

    def relative_rows(self, q: torch.Tensor, h: int, w: int):
        """(rel_h [B, H, h w, h], rel_w [B, H, h w, w]) fp32 from unscaled q
        [B, H, h w, D]: the tables gathered by the one-hot products
        (Rh [h, h, D], Rw [w, w, D]), then q . R per query row, in q's
        dtype."""
        if h != self.side or w != self.side:
            raise ValueError(f"the tables are for a {self.side} x {self.side} grid, got "
                             f"{h} x {w}")
        with tracing.device_span("rpe.relpos", q.device) as span:
            q, table_h, table_w = span.inputs(q, self.rel_pos_h, self.rel_pos_w)
            one_hot = _one_hot(self.side, q.device)
            rh = (one_hot @ table_h).view(h, h, -1).to(q.dtype)
            rw = (one_hot @ table_w).view(w, w, -1).to(q.dtype)
            B, H, _, D = q.shape
            grid = q.reshape(B * H, h, w, D)
            rel_h = torch.einsum("bhwc,hkc->bhwk", grid, rh).reshape(B, H, h * w, h)
            rel_w = torch.einsum("bhwc,wkc->bhwk", grid, rw).reshape(B, H, h * w, w)
            return span.outputs(rel_h.float(), rel_w.float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, h, w, dim = x.shape
        qkv = self.qkv(x).reshape(B, h * w, 3, self.heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # [B, H, N, D] each
        rel_pos = self.relative_rows(q, h, w)
        name = "rpe.attn_window" if self.windowed else "rpe.attn_global"
        with tracing.device_span(name, x.device) as span:
            q, k, v, *rel_pos = span.inputs(q, k, v, *rel_pos)
            o = flash_softmax_attention(q, k, v, self.scale, rel_pos=tuple(rel_pos))
            (o,) = span.outputs(o)
        return self.proj(o.transpose(1, 2).reshape(B, h, w, dim))


class MlpBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.lin1 = Dense(dim, mlp_dim, compute_dtype=compute_dtype)
        self.lin2 = Dense(mlp_dim, dim, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.gelu(self.lin1(x)))


class SamBlock(nn.Module):
    """x + attn(LN(x)) (windowed when `window` > 0), then x + mlp(LN(x))."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, window: int, grid: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.window = window
        self.norm1 = LayerNorm(dim, eps=LN_EPS, compute_dtype=compute_dtype)
        self.attn = SamAttention(dim, heads, window or grid, window > 0, compute_dtype)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, compute_dtype=compute_dtype)
        self.mlp = MlpBlock(dim, mlp_dim, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        if self.window:
            H, W = y.shape[1:3]
            with tracing.device_span("rpe.window", y.device) as span:
                (y,) = span.inputs(y)
                y, padded = window_partition(y, self.window)
                (y,) = span.outputs(y)
            y = self.attn(y)
            with tracing.device_span("rpe.window", y.device) as span:
                (y,) = span.inputs(y)
                y = window_unpartition(y, self.window, padded, (H, W))
                (y,) = span.outputs(y)
        else:
            y = self.attn(y)
        x = x + y
        return x + self.mlp(self.norm2(x))


class SamImageEncoder(nn.Module):
    """SAM's image encoder with a pooled linear head: [B, S, S, C] images ->
    [B, num_classes] fp32 logits."""

    def __init__(self, image_size: int, in_channels: int, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, patch_size: int, window_size: int,
                 global_attn_indexes: Sequence[int], out_chans: int,
                 dtype: str = "float32"):
        super().__init__()
        if image_size % patch_size or dim % heads:
            raise ValueError(f"image_size {image_size} must be a multiple of patch_size "
                             f"{patch_size} and dim {dim} of heads {heads}")
        self.image_size, self.in_channels = image_size, in_channels
        self.compute_dtype = dt = torch_dtype(dtype)
        self.global_attn_indexes = tuple(global_attn_indexes)
        grid = image_size // patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = ConvNHWC(in_channels, dim, patch_size, patch_size, True, dt)
        self.pos_embed = nn.Parameter(torch.empty(1, grid, grid, dim))
        self.blocks = nn.ModuleList(
            SamBlock(dim, heads, mlp_dim, 0 if i in self.global_attn_indexes else window_size,
                     grid, dt)
            for i in range(depth))
        self.neck = nn.Sequential(ConvNHWC(dim, out_chans, 1, 1, False, dt),
                                  LayerNorm(out_chans, eps=LN_EPS, compute_dtype=dt),
                                  ConvNHWC(out_chans, out_chans, 3, 1, False, dt),
                                  LayerNorm(out_chans, eps=LN_EPS, compute_dtype=dt))
        self.head = nn.Linear(out_chans, num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier-uniform weights (convolutions with torch's fans), zero
        biases, unit LayerNorms, and SAM's zero position embedding and zero
        relative-position tables (`rel_pos_zero_init`), drawn from
        `generator` (a CPU generator gives the same model on every
        device)."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, ConvNHWC)):
                tmp = torch.empty(m.weight.shape)
                nn.init.xavier_uniform_(tmp, generator=generator)
                m.weight.copy_(tmp)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, SamAttention):
                m.rel_pos_h.zero_()
                m.rel_pos_w.zero_()
        self.pos_embed.zero_()

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """x: [B, S, S, C] float images -> [B, num_classes] fp32 logits.
        Nothing is drawn: `generator` is taken for the train steps' calling
        convention."""
        if tuple(x.shape[1:]) != (self.image_size, self.image_size, self.in_channels):
            raise ValueError(f"expected input [B, {self.image_size}, {self.image_size}, "
                             f"{self.in_channels}], got {tuple(x.shape)}")
        h = self.patch_embed.proj(x) + self.pos_embed.to(self.compute_dtype)
        for block in self.blocks:
            h = block(h)
        h = self.neck(h)
        return self.head(h.float().mean(dim=(1, 2)))

