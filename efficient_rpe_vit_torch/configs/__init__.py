from .base import (
    ModelConfig,
    TrainConfig,
    DataConfig,
    ExperimentConfig,
    DEFAULT_ATTENTION_PARAMS,
    DEFAULT_RPE_PARAMS,
)
from .datasets import (
    CIFAR10_CONFIG,
    DATASET_CONFIGS,
    MNIST_CONFIG,
    cifar10_config,
    get_dataset_config,
    mnist_config,
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
    "DATASET_CONFIGS",
    "get_dataset_config",
    "MNIST_CONFIG",
    "CIFAR10_CONFIG",
]
