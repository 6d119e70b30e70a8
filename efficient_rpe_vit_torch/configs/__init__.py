from .base import (
    ModelConfig,
    TrainConfig,
    DataConfig,
    ExperimentConfig,
    DEFAULT_ATTENTION_PARAMS,
    DEFAULT_RPE_PARAMS,
)
from .datasets import (
    mnist_config,
    cifar10_config,
)

__all__ = [
    "ModelConfig",
    "TrainConfig",
    "DataConfig",
    "ExperimentConfig",
    "DEFAULT_ATTENTION_PARAMS",
    "DEFAULT_RPE_PARAMS",
    "mnist_config",
    "cifar10_config",
]
