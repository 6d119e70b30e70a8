"""The SAM image-encoder family, the program's side: the port's
`SamImageEncoder` (what `create_model("sam_vit_h", ...)` builds) at the
configuration's sizes, and the sizes the CPU tests run it at.

It imports the port inside its functions only, so that the plain reference
can look the family up (`spec.family`) without loading the port.
"""

from __future__ import annotations

from ..reference.train import learning_rate

# the architecture fields the configuration gives `SamImageEncoder`
ARCH = ("dim", "depth", "heads", "mlp_dim", "patch_size", "window_size",
        "global_attn_indexes", "out_chans")


def _experiment_config(config: dict, mix: dict):
    from efficient_rpe_vit_torch.configs import (DataConfig, ExperimentConfig, ModelConfig,
                                                 TrainConfig)

    return ExperimentConfig(
        model=ModelConfig(image_size=mix["image_size"], in_channels=config["in_channels"],
                          patch_size=config["patch_size"], num_classes=config["num_classes"],
                          dim=config["dim"], depth=config["depth"], heads=config["heads"],
                          mlp_dim=config["mlp_dim"], dropout=0.0),
        train=TrainConfig(batch_size=mix["batch"],
                          learning_rate=learning_rate(config, mix, 0),
                          weight_decay=config["weight_decay"], epochs=config["epochs"],
                          warmup_epochs=0, optimizer=config["optimizer"],
                          scheduler=config["scheduler"], compute_dtype=config["compute_dtype"]),
        data=DataConfig(dataset="synthetic", mean=tuple(config["mean"]),
                        std=tuple(config["std"])))


def build(config: dict, mix: dict, device, generator):
    """(model, experiment config): the port's SAM encoder at the
    configuration's sizes, made on the meta device and given uninitialised
    storage on `device`: the runner loads every leaf by name, so no draw is
    made (`generator` is not used). `create_model` would draw every weight
    on the host first, 637M of them at ViT-H."""
    import torch

    from efficient_rpe_vit_torch.models.sam import SamImageEncoder

    exp = _experiment_config(config, mix)
    arch = {k: config[k] for k in ARCH}
    arch["global_attn_indexes"] = tuple(arch["global_attn_indexes"])
    with torch.device("meta"):
        model = SamImageEncoder(mix["image_size"], config["in_channels"],
                                config["num_classes"], dtype=config["compute_dtype"], **arch)
    return model.to_empty(device=device).eval(), exp


def tiny(config: dict, mix: dict):
    """(config, mix) at a width a CPU test holds, both block kinds kept: 32
    px images in patches of 4 (an 8 x 8 grid, padded to 9 x 9 for windows
    of 3), 4 blocks with global blocks 1 and 3, dim 32, 2 heads."""
    config = dict(config, dim=32, depth=4, heads=2, mlp_dim=64, patch_size=4, window_size=3,
                  global_attn_indexes=[1, 3], out_chans=16, num_classes=10)
    return config, dict(mix, image_size=32, batch=4, fused_steps=3, held_images=24)
