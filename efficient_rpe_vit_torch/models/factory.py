"""Model factory: variant names -> configured ViT modules.

Counterpart of `efficient_rpe_vit_tpu/models/factory.py`: the same variant
names, the same custom "<attention>_<rpe>" parsing and the same
per-mechanism `attention_params` / `rpe_params` merging. A variant whose
modules are not ported yet raises NotImplementedError naming the slice of
the port that brings it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..configs import ExperimentConfig
from ..utils.device import resolve_device
from .attention import ATTENTION_REGISTRY
from .rpe import RPE_REGISTRY
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

# mechanisms of the JAX package that the port does not have yet -> the
# slice that brings them
_ROTATION_SLICE = "the rotation slice (RoPE and circulant kernels)"
NOT_PORTED: Dict[str, str] = {
    "favor_hyper": _ROTATION_SLICE,
    "circulant_string": _ROTATION_SLICE,
    "circulant": _ROTATION_SLICE,
    "rope": _ROTATION_SLICE,
    "rotary": _ROTATION_SLICE,
    "rope_2d": _ROTATION_SLICE,
    "rope_axial": _ROTATION_SLICE,
}
_ATTENTION_NAMES = set(ATTENTION_REGISTRY) | {"favor_hyper"}
_RPE_NAMES = set(RPE_REGISTRY) | (set(NOT_PORTED) - _ATTENTION_NAMES)


def _resolve_variant(model_name: str) -> Tuple[str, Optional[str]]:
    if model_name in MODEL_VARIANTS:
        return MODEL_VARIANTS[model_name]
    # custom "<attention>_<rpe>" names — greedy over attention prefixes so
    # multi-token names like "favor_plus_rope_2d" parse correctly
    parts = model_name.split("_")
    for i in range(len(parts), 0, -1):
        attention_type = "_".join(parts[:i])
        if attention_type in _ATTENTION_NAMES:
            rpe_type = "_".join(parts[i:]) or None
            if rpe_type is not None and rpe_type not in _RPE_NAMES:
                raise ValueError(
                    f"Unknown RPE type: {rpe_type}. "
                    f"Available types: {sorted(_RPE_NAMES)}"
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
    *,
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
            (e.g. rpe_config={"method": "dense"}).
        device: where the model lives; None means the GPU, and raises when
            there is none. Pass "cpu" to run on the CPU.
        generator: CPU generator the weights are drawn from; None seeds
            one from the config's `seed`.
        **overrides: architecture field overrides (dim, depth, dropout, ...).

    Raises:
        NotImplementedError: for the rejected softmax+KERPLE combination and
            for variants whose modules are not ported yet.
    """
    device = resolve_device(device)
    attention_type, rpe_type = _resolve_variant(model_name)
    if attention_type in ("softmax", "baseline") and rpe_type in (
            "most_general", "kerple"):
        raise NotImplementedError(
            "KERPLE RPE is designed specifically for kernelized attention "
            "(FAVOR+/ReLU Performer) and cannot be used with standard softmax "
            "attention. For softmax attention, use RoPE or Circulant-STRING "
            "RPE instead."
        )
    for part in (attention_type, rpe_type):
        if part in NOT_PORTED:
            raise NotImplementedError(
                f"{model_name}: {part!r} is not ported to PyTorch yet; it "
                f"comes with {NOT_PORTED[part]}")

    cfg = config.to_dict() if isinstance(config, ExperimentConfig) else dict(config)
    cfg.update(overrides)

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
    )
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    model.reset_parameters(generator)
    return model.to(device).eval()

