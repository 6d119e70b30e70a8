"""Model factory: variant names -> configured ViT modules.

Counterpart of `efficient_rpe_vit_tpu/models/factory.py`: the same variant
names, the same custom "<attention>_<rpe>" parsing and the same
per-mechanism `attention_params` / `rpe_params` merging: the 11 reference
variants, the aliases and the custom names (`favor_plus_rope_2d`,
`favor_hyper_circulant`, ...) all build; softmax with KERPLE raises. The
soft-MoE MLP (`mlp_config`) and per-block checkpointing (`remat`) are
taken as in JAX; `list_available_models`, `get_model_info` and
`count_parameters` are the JAX lookups. The port's own architecture
`sam_vit_h` (SAM's image encoder with a pooled head, `models/sam.py`)
builds by name too and stays out of the JAX lookups.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from ..configs import ExperimentConfig
from ..utils.device import resolve_device
from .attention import ATTENTION_REGISTRY
from .rpe import RPE_REGISTRY
from .sam import SAM_VIT_H, SamImageEncoder
from .vit import ViT

# name -> (attention_type, rpe_type)
MODEL_VARIANTS: Dict[str, Tuple[str, Optional[str]]] = {
    # Baseline models
    "baseline": ("softmax", None),
    "baseline_most_general": ("softmax", "most_general"),  # rejected at build
    "baseline_circulant": ("softmax", "circulant_string"),
    "baseline_rope": ("softmax", "rope"),
    # Performer FAVOR+ models
    "performer_favor": ("favor_plus", None),
    "performer_favor_most_general": ("favor_plus", "most_general"),
    "performer_favor_circulant": ("favor_plus", "circulant_string"),
    "performer_favor_rope": ("favor_plus", "rope"),
    # Performer ReLU models
    "performer_relu": ("relu", None),
    "performer_relu_most_general": ("relu", "most_general"),
    "performer_relu_circulant": ("relu", "circulant_string"),
    "performer_relu_rope": ("relu", "rope"),
    # Aliases
    "performer": ("favor_plus", None),
    "vit": ("softmax", None),
}


def _resolve_variant(model_name: str) -> Tuple[str, Optional[str]]:
    if model_name in MODEL_VARIANTS:
        return MODEL_VARIANTS[model_name]
    # custom "<attention>_<rpe>" names — greedy over attention prefixes so
    # multi-token names like "favor_plus_rope_2d" parse correctly
    parts = model_name.split("_")
    for i in range(len(parts), 0, -1):
        attention_type = "_".join(parts[:i])
        if attention_type in ATTENTION_REGISTRY:
            rpe_type = "_".join(parts[i:]) or None
            if rpe_type is not None and rpe_type not in RPE_REGISTRY:
                raise ValueError(
                    f"Unknown RPE type: {rpe_type}. "
                    f"Available types: {list(RPE_REGISTRY)}"
                )
            return attention_type, rpe_type
    raise ValueError(
        f"Unknown model: {model_name}. "
        f"Available models: {list(MODEL_VARIANTS.keys())}"
    )


def create_model(
    model_name: str,
    config: Union[ExperimentConfig, Dict[str, Any]],
    attention_config: Optional[Dict[str, Any]] = None,
    rpe_config: Optional[Dict[str, Any]] = None,
    mlp_config: Optional[Dict[str, Any]] = None,
    *,
    remat: bool = False,
    device: Union[str, torch.device, None] = None,
    generator: Optional[torch.Generator] = None,
    **overrides,
) -> ViT:
    """Build a ViT for a named variant, with its weights drawn, in eval mode
    (the JAX package's default deterministic forward).

    Args:
        model_name: variant name (e.g. 'performer_favor_most_general').
        config: ExperimentConfig or the flat dict from `.to_dict()`.
        attention_config / rpe_config: per-call mechanism overrides, merged
            over the config's `attention_params` / `rpe_params` defaults
            (e.g. rpe_config={"method": "dense"} for KERPLE, {"method":
            "chain"} for Circulant-STRING, {"block_size": 16,
            "enable_block_circulant": True} for block-circulant).
        mlp_config: optional MLP override, as in the JAX factory:
            {"mlp_type": "moe", "num_experts": E} switches the block MLPs
            to the soft mixture of experts (`layers.MoeMlp`); with
            "expert_mesh" (a `parallel.Mesh`) and "expert_axis" its
            experts are split over that mesh axis. An attention_config's
            "seq_mesh" / "seq_axis" split the attention core's sequence
            over that axis (context parallelism).
        remat: per-block activation checkpointing (`ViT.remat`); the
            config's `remat` field turns it on too.
        device: where the model lives; None means the GPU, and raises when
            there is none. Pass "cpu" to run on the CPU.
        generator: CPU generator the weights are drawn from; None seeds
            one from the config's `seed`.
        **overrides: architecture field overrides (dim, depth, dropout, ...).

        For `sam_vit_h` the architecture is `models/sam.py::SAM_VIT_H`
        (SAM's published widths, windows and global blocks), the config
        gives the image size, channels, classes and compute dtype,
        `overrides` may replace any architecture field, and the mechanism,
        MLP and remat arguments do not apply.

    Raises:
        NotImplementedError: for the rejected softmax+KERPLE combination.
    """
    device = resolve_device(device)
    if model_name == "sam_vit_h":
        if attention_config or rpe_config or mlp_config or remat:
            raise ValueError(f"{model_name} takes no attention, rpe or mlp config and no remat")
        cfg = config.to_dict() if isinstance(config, ExperimentConfig) else dict(config)
        model = SamImageEncoder(cfg["image_size"], cfg["in_channels"], cfg["num_classes"],
                                dtype=cfg.get("compute_dtype", "float32"),
                                **{**SAM_VIT_H, **overrides})
        if generator is None:
            generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
        model.reset_parameters(generator)
        return model.to(device).eval()
    attention_type, rpe_type = _resolve_variant(model_name)
    if attention_type in ("softmax", "baseline") and rpe_type in (
            "most_general", "kerple"):
        raise NotImplementedError(
            "KERPLE RPE is designed specifically for kernelized attention "
            "(FAVOR+/ReLU Performer) and cannot be used with standard softmax "
            "attention. For softmax attention, use RoPE or Circulant-STRING "
            "RPE instead."
        )
    cfg = config.to_dict() if isinstance(config, ExperimentConfig) else dict(config)
    cfg.update(overrides)
    mlp_kwargs = dict(mlp_config or {})
    mlp_type = mlp_kwargs.pop("mlp_type", "dense")

    attn_kwargs = dict((cfg.get("attention_params") or {}).get(attention_type, {}))
    if attention_config:
        attn_kwargs.update(attention_config)
    rpe_kwargs: Dict[str, Any] = {}
    if rpe_type is not None:
        rpe_kwargs = dict((cfg.get("rpe_params") or {}).get(rpe_type, {}))
        if rpe_config:
            rpe_kwargs.update(rpe_config)
    # drop Nones so module defaults apply
    attn_kwargs = {k: v for k, v in attn_kwargs.items() if v is not None}
    rpe_kwargs = {k: v for k, v in rpe_kwargs.items() if v is not None}

    model = ViT(
        image_size=cfg["image_size"],
        in_channels=cfg["in_channels"],
        patch_size=cfg["patch_size"],
        num_classes=cfg["num_classes"],
        dim=cfg["dim"],
        depth=cfg["depth"],
        heads=cfg["heads"],
        mlp_dim=cfg["mlp_dim"],
        dropout=cfg.get("dropout", 0.1),
        attention_type=attention_type,
        rpe_type=rpe_type,
        attention_kwargs=attn_kwargs,
        rpe_kwargs=rpe_kwargs,
        dtype=cfg.get("compute_dtype", "float32"),
        mlp_type=mlp_type,
        mlp_kwargs=mlp_kwargs,
        remat=bool(remat or cfg.get("remat", False)),
    )
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    model.reset_parameters(generator)
    return model.to(device).eval()



def list_available_models() -> list:
    """All pre-configured variant names."""
    return list(MODEL_VARIANTS.keys())


def get_model_info(model_name: str) -> Dict[str, Any]:
    """Variant metadata: name, attention and RPE types, complexity."""
    if model_name not in MODEL_VARIANTS:
        raise ValueError(f"Unknown model: {model_name}")
    attention_type, rpe_type = MODEL_VARIANTS[model_name]
    return {
        "name": model_name,
        "attention_type": attention_type,
        "rpe_type": rpe_type,
        "attention_complexity": "O(N²)" if attention_type == "softmax" else "O(N)",
        "has_rpe": rpe_type is not None,
    }


# persistent buffers of the port's models: the JAX package's `constants`
# (Omega) and `state` (the feature-redraw counters) collections, which its
# parameter count leaves out
_BUFFER_NAMES = ("omega", "redraw_counter")


def count_parameters(model: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, int]:
    """Parameter count of a model or of its state dict: parameters only,
    never Omega or the redraw counters (all parameters train)."""
    if isinstance(model, nn.Module):
        total = sum(p.numel() for p in model.parameters())
    else:
        total = sum(t.numel() for name, t in model.items()
                    if name.rsplit(".", 1)[-1] not in _BUFFER_NAMES)
    return {"total": total, "trainable": total, "non_trainable": 0}
