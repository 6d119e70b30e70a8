"""Typed dataclass configuration system.

Value-for-value copy of `efficient_rpe_vit_tpu/configs/base.py` (the port
keeps its own copy so it never imports the JAX package): frozen
dataclasses whose flat-dict view (`ExperimentConfig.to_dict()`) uses the
same lowercase keys the factory consumes.

Three-layer precedence: dataclass defaults -> dataset config constructor
-> kwargs overrides.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


# Per-mechanism defaults
DEFAULT_ATTENTION_PARAMS: Dict[str, Dict[str, Any]] = {
    "softmax": {},
    "favor_plus": {
        "num_features": None,  # auto: floor(head_dim * ln(head_dim))
        "use_orthogonal": True,
        "feature_redraw_interval": None,
    },
    "relu": {
        "num_features": None,
        "use_orthogonal": True,
        "feature_redraw_interval": None,
    },
}

DEFAULT_RPE_PARAMS: Dict[str, Dict[str, Any]] = {
    "most_general": {},
    "circulant_string": {"coord_dim": 2, "block_size": None},
    "rope": {"theta": 10000.0},
}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters."""

    image_size: int
    in_channels: int
    patch_size: int
    num_classes: int
    dim: int = 64
    depth: int = 3
    heads: int = 4
    mlp_dim: int = 256
    dropout: float = 0.1

    def __post_init__(self):
        if self.image_size % self.patch_size != 0:
            raise ValueError(
                f"image_size {self.image_size} must be divisible by "
                f"patch_size {self.patch_size}"
            )
        if self.dim % self.heads != 0:
            raise ValueError(
                f"dim {self.dim} must be divisible by heads {self.heads}"
            )

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.patch_size * self.patch_size

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def seq_len(self) -> int:
        """Sequence length including the CLS token."""
        return self.num_patches + 1


@dataclass(frozen=True)
class TrainConfig:
    """Optimisation hyperparameters."""

    batch_size: int = 32
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    epochs: int = 10
    warmup_epochs: int = 0
    optimizer: str = "adam"  # adam | adamw | sgd
    scheduler: str = "cosine"  # cosine | warmup_cosine | step | constant
    seed: int = 42
    # dtype policy: params fp32; compute dtype for activations and matmuls
    compute_dtype: str = "float32"  # float32 | bfloat16


@dataclass(frozen=True)
class DataConfig:
    """Dataset identity + preprocessing."""

    dataset: str = "mnist"
    mean: Tuple[float, ...] = (0.0,)
    std: Tuple[float, ...] = (1.0,)
    augmentation: bool = False
    data_dir: Optional[str] = None  # None -> search default locations
    allow_synthetic: bool = True  # fall back to synthetic data when raw missing


@dataclass(frozen=True)
class ExperimentConfig:
    """Bundle of model/train/data plus per-mechanism overrides."""

    model: ModelConfig
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    attention_params: Dict[str, Dict[str, Any]] = field(
        default_factory=lambda: {k: dict(v) for k, v in DEFAULT_ATTENTION_PARAMS.items()}
    )
    rpe_params: Dict[str, Dict[str, Any]] = field(
        default_factory=lambda: {k: dict(v) for k, v in DEFAULT_RPE_PARAMS.items()}
    )

    def to_dict(self) -> Dict[str, Any]:
        """Flat lowercase dict of every section's fields."""
        out: Dict[str, Any] = {}
        for section in (self.model, self.train, self.data):
            for f in dataclasses.fields(section):
                out[f.name] = getattr(section, f.name)
        out["attention_params"] = {k: dict(v) for k, v in self.attention_params.items()}
        out["rpe_params"] = {k: dict(v) for k, v in self.rpe_params.items()}
        return out

    def replace(self, **kwargs) -> "ExperimentConfig":
        """Override any leaf field by name.

        Model/train/data fields are routed to their section automatically.
        """
        model_kw, train_kw, data_kw, top_kw = {}, {}, {}, {}
        model_fields = {f.name for f in dataclasses.fields(ModelConfig)}
        train_fields = {f.name for f in dataclasses.fields(TrainConfig)}
        data_fields = {f.name for f in dataclasses.fields(DataConfig)}
        for k, v in kwargs.items():
            if v is None:
                continue
            if k in model_fields:
                model_kw[k] = v
            elif k in train_fields:
                train_kw[k] = v
            elif k in data_fields:
                data_kw[k] = v
            else:
                top_kw[k] = v
        return dataclasses.replace(
            self,
            model=dataclasses.replace(self.model, **model_kw) if model_kw else self.model,
            train=dataclasses.replace(self.train, **train_kw) if train_kw else self.train,
            data=dataclasses.replace(self.data, **data_kw) if data_kw else self.data,
            **top_kw,
        )
