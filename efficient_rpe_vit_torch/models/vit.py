"""Vision Transformer skeleton.

Counterpart of `efficient_rpe_vit_tpu/models/vit.py`: reshape-based
patchify with the (C, p, p) patch layout, linear patch embedding, learned
CLS token + learned absolute positional embedding (always present, even
with RPE), depth x transformer blocks, LayerNorm + Linear head on the CLS
output in fp32. Images come in NHWC, as in the JAX package.

Init (`reset_parameters`, from an explicit generator): Xavier-uniform
linear weights / zero biases (the MoE expert kernels under flax's fan rule
for 3-D kernels), unit LayerNorms, N(0, 0.02) for pos_embedding, cls_token
and KERPLE biases, N(0, 0.01) for circulant coefficients, Omega drawn per
block (and the feature-redraw counters zeroed).

`remat=True` recomputes each block's activations in the backward
(`torch.utils.checkpoint`, non-reentrant; the JAX package's `nn.remat`), in
train mode with gradients on; eval and `torch.inference_mode` run the
blocks as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import _KernelAttention
from .dense import Dense, DrawTape, LayerNorm, torch_dtype
from .layers import MoeMlp, TransformerBlock
from .rpe import CirculantStringRPE, KerpleRPE


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) NHWC images -> (B, num_patches, C*p*p) patches in the
    (C, p, p) vector layout."""
    B, H, W, C = x.shape
    p = patch_size
    x = x.permute(0, 3, 1, 2)  # NCHW
    x = x.reshape(B, C, H // p, p, W // p, p)
    x = x.permute(0, 2, 4, 1, 3, 5)  # (B, H/p, W/p, C, p, p)
    return x.reshape(B, (H // p) * (W // p), C * p * p)


def _checkpointed_block(block: TransformerBlock, x: torch.Tensor,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
    """`block(x, generator)` with its activations recomputed in the
    backward. The recompute takes back the first run's random draws from a
    `DrawTape` (the same dropout masks and seeds, the generator left where
    the forward left it) and skips the feature redraw, so the gradients are
    those of the plain block."""
    tape = DrawTape()

    def run(x):
        with tape.active():
            return block(x, generator)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class ViT(nn.Module):
    """Configurable-attention/RPE Vision Transformer.

    State-dict names follow the reference torch model (`patch_embedding`,
    `cls_token`, `pos_embedding`, `transformer_blocks.{i}.*`,
    `mlp_head.{0,1}`), so `efficient_rpe_vit_tpu.utils.import_torch` maps
    them onto the JAX package's params.
    """

    def __init__(self, image_size: int, in_channels: int, patch_size: int,
                 num_classes: int, dim: int, depth: int, heads: int,
                 mlp_dim: int, dropout: float = 0.1,
                 attention_type: str = "favor_plus",
                 rpe_type: Optional[str] = None,
                 attention_kwargs: Optional[Dict[str, Any]] = None,
                 rpe_kwargs: Optional[Dict[str, Any]] = None,
                 dtype: str = "float32", mlp_type: str = "dense",
                 mlp_kwargs: Optional[Dict[str, Any]] = None,
                 remat: bool = False):
        super().__init__()
        self.attention_type = attention_type
        self.rpe_type = rpe_type
        self.mlp_type = mlp_type
        self.depth = depth
        self.remat = remat
        self.image_size = image_size
        self.in_channels = in_channels
        self.patch_size = patch_size
        self.compute_dtype = torch_dtype(dtype)
        n = self.num_patches + 1  # CLS included
        self.patch_embedding = Dense(self.patch_dim, dim,
                                     compute_dtype=self.compute_dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, n, dim))
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(dim, heads, mlp_dim, n, dropout, attention_type,
                             rpe_type, attention_kwargs, rpe_kwargs,
                             self.compute_dtype, mlp_type, mlp_kwargs)
            for _ in range(depth)
        )
        self.mlp_head = nn.Sequential(LayerNorm(dim, eps=1e-5),
                                      nn.Linear(dim, num_classes))

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.patch_size * self.patch_size

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter and Omega buffer from `generator` (a CPU
        generator gives the same model on every device)."""
        def draw(fill, t, *args, shard=None):
            # a split tensor (the experts of an expert_mesh MoE) takes its
            # part of the whole tensor's draw
            count = 1 if shard is None else shard.count
            tmp = torch.empty((t.shape[0] * count, *t.shape[1:]), dtype=t.dtype)
            fill(tmp, *args, generator=generator)
            t.copy_(tmp.chunk(count)[0 if shard is None else shard.index])

        for m in self.modules():
            if isinstance(m, nn.Linear):
                draw(nn.init.xavier_uniform_, m.weight)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, MoeMlp):
                for w in (m.w1, m.w2):
                    draw(nn.init.uniform_, w, -m.init_limit, m.init_limit, shard=m.ep)
                m.b1.zero_()
                m.b2.zero_()
            elif isinstance(m, KerpleRPE):
                draw(nn.init.normal_, m.rel_pos_bias, 0.0, 0.02)
            elif isinstance(m, CirculantStringRPE):
                draw(nn.init.normal_, m.circulant_coeffs, 0.0, 0.01)
            elif isinstance(m, _KernelAttention):
                m.omega.copy_(m.draw_omega(generator))
                if m.feature_redraw_interval is not None:
                    m.redraw_counter.zero_()
        draw(nn.init.normal_, self.cls_token, 0.0, 0.02)
        draw(nn.init.normal_, self.pos_embedding, 0.0, 0.02)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                return_attention: bool = False):
        """x: [B, H, W, C] float images -> [B, num_classes] fp32 logits.

        In train mode, dropout masks and redrawn random features come from
        `generator` (on x's device), which is then required where either is
        live; eval mode never draws. With return_attention (softmax
        attention only), returns (logits, [per-block [B, H, N, N]
        probabilities])."""
        B = x.shape[0]
        if tuple(x.shape[1:]) != (self.image_size, self.image_size,
                                  self.in_channels):
            raise ValueError(
                f"expected input [B, {self.image_size}, {self.image_size}, "
                f"{self.in_channels}], got {tuple(x.shape)}"
            )
        dt = self.compute_dtype
        x = self.patch_embedding(patchify(x, self.patch_size).to(dt))
        cls = self.cls_token.to(dt).expand(B, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(dt)
        attention_maps = []
        remat = (self.remat and not return_attention and self.training
                 and torch.is_grad_enabled())
        for block in self.transformer_blocks:
            if remat:
                x = _checkpointed_block(block, x, generator)
                continue
            x = block(x, generator, return_attention=return_attention)
            if return_attention:
                x, weights = x
                attention_maps.append(weights)
        logits = self.mlp_head(x[:, 0].float())  # head in fp32
        return (logits, attention_maps) if return_attention else logits
