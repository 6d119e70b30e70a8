"""Dataset configurations, value-for-value with the JAX package's.

MNIST:    28px, 1ch, patch 7 -> 16 patches, dim 32, depth 3, heads 2,
          mlp 64, bs 32, lr 1e-3, 10 epochs, mean .1307 / std .3081.
CIFAR-10: 32px, 3ch, patch 8 -> 16 patches, dim 32, depth 3, heads 2,
          mlp 64, bs 64, lr 1e-3, wd .01, 20 epochs, warmup 2.
"""

from __future__ import annotations

from .base import DataConfig, ExperimentConfig, ModelConfig, TrainConfig


def mnist_config(**overrides) -> ExperimentConfig:
    cfg = ExperimentConfig(
        model=ModelConfig(
            image_size=28,
            in_channels=1,
            patch_size=7,
            num_classes=10,
            dim=32,
            depth=3,
            heads=2,
            mlp_dim=64,
            dropout=0.1,
        ),
        train=TrainConfig(
            batch_size=32,
            learning_rate=1e-3,
            weight_decay=0.0,
            epochs=10,
            warmup_epochs=0,
        ),
        data=DataConfig(
            dataset="mnist",
            mean=(0.1307,),
            std=(0.3081,),
            augmentation=False,
        ),
    )
    return cfg.replace(**overrides) if overrides else cfg


def cifar10_config(**overrides) -> ExperimentConfig:
    cfg = ExperimentConfig(
        model=ModelConfig(
            image_size=32,
            in_channels=3,
            patch_size=8,
            num_classes=10,
            dim=32,
            depth=3,
            heads=2,
            mlp_dim=64,
            dropout=0.1,
        ),
        train=TrainConfig(
            batch_size=64,
            learning_rate=1e-3,
            weight_decay=0.01,
            epochs=20,
            warmup_epochs=2,
            optimizer="adamw",
        ),
        data=DataConfig(
            dataset="cifar10",
            mean=(0.4914, 0.4822, 0.4465),
            std=(0.2470, 0.2435, 0.2616),
            augmentation=False,
        ),
    )
    return cfg.replace(**overrides) if overrides else cfg

