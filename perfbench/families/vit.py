"""The ViT family, the program's side: the port's `create_model` for the
configuration's `variant`, and the widths the CPU tests run it at.

It imports the port inside its functions only, so that the plain reference
can look the family up (`spec.family`) without loading the port.
"""

from __future__ import annotations

from ..reference.train import learning_rate


def _experiment_config(config: dict, mix: dict):
    from efficient_rpe_vit_torch.configs import (DataConfig, ExperimentConfig, ModelConfig,
                                                 TrainConfig)

    return ExperimentConfig(
        model=ModelConfig(image_size=mix["image_size"], in_channels=config["in_channels"],
                          patch_size=config["patch_size"], num_classes=config["num_classes"],
                          dim=config["dim"], depth=config["depth"], heads=config["heads"],
                          mlp_dim=config["mlp_dim"], dropout=config["dropout"]),
        train=TrainConfig(batch_size=mix["batch"],
                          learning_rate=learning_rate(config, mix, 0),
                          weight_decay=config["weight_decay"], epochs=config["epochs"],
                          warmup_epochs=0, optimizer=config["optimizer"],
                          scheduler=config["scheduler"], compute_dtype=config["compute_dtype"]),
        data=DataConfig(dataset="synthetic", mean=tuple(config["mean"]),
                        std=tuple(config["std"])))


def build(config: dict, mix: dict, device, generator):
    """(model, experiment config): the port's ViT of the configuration's
    `variant`, its own initial weights drawn from `generator`."""
    from efficient_rpe_vit_torch.models import create_model

    exp = _experiment_config(config, mix)
    attention_config = ({"num_features": config["num_features"]}
                        if "num_features" in config else None)
    model = create_model(config["variant"], exp, attention_config=attention_config,
                         device=device, generator=generator)
    return model, exp


def tiny(config: dict, mix: dict):
    """(config, mix) at a width a CPU test holds: dim 32, depth 2, N = 17."""
    config = dict(config, dim=32, depth=2, heads=2, mlp_dim=64, patch_size=4, num_classes=10)
    if "num_features" in config:
        config["num_features"] = 12
    return config, dict(mix, image_size=16, batch=4, fused_steps=3, held_images=24)
