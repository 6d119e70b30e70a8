#!/usr/bin/env python
"""Import a reference (PyTorch) checkpoint into the port.

Counterpart of `experiments/import_checkpoint.py` (the JAX package's
tool), with its flags. It reads a torch checkpoint written by the
reference's `save_checkpoint` (a dict with 'model_state_dict', 'epoch',
'metrics', ...) or a bare state_dict, loads the weights into the port's
model under the reference's own names (the port's modules use them, so
no name is mapped), and writes the port's native single-file checkpoint
(`train.save_checkpoint`) with metadata {model_name, dataset,
imported_from}, which `experiments.predict --checkpoint` serves.

    python -m efficient_rpe_vit_torch.experiments.import_checkpoint \\
        --torch-checkpoint ref_ckpt.pt --model baseline --dataset mnist \\
        --output imported.pt

The model is built on the GPU unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import pickle

import torch


def read_reference(path: str):
    """(state_dict, epoch, metrics) of a reference checkpoint file: its
    `save_checkpoint` dict or a bare state_dict. The file is read with
    `weights_only=True` when it holds only tensors and plain containers;
    one that pickles other objects is read in full, as the JAX tool reads
    every file."""
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        return blob["model_state_dict"], int(blob.get("epoch", 0)), blob.get("metrics", {})
    return blob, 0, {}


@torch.no_grad()
def load_reference_weights(model: torch.nn.Module, state_dict) -> torch.nn.Module:
    """Copy the reference's weights into `model` by name, in place: every
    parameter must be there with the model's shape; Omega is taken when
    the file has it, else the model keeps its own draw (the JAX importer's
    rule); the redraw counters and names the model lacks are left alone."""
    params = dict(model.named_parameters())
    for name, t in model.state_dict().items():
        if name not in state_dict:
            if name in params:
                raise ValueError(f"the reference checkpoint has no {name}")
            continue
        if name.endswith("redraw_counter"):
            continue
        value = torch.as_tensor(state_dict[name])
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {name}: ours {tuple(t.shape)} vs "
                             f"reference {tuple(value.shape)}")
        t.copy_(value)
    return model


def main(argv=None):
    p = argparse.ArgumentParser(description="Import a reference (PyTorch) checkpoint")
    p.add_argument("--torch-checkpoint", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--dataset", default="mnist", choices=["mnist", "cifar10"])
    p.add_argument("--output", required=True)
    p.add_argument("--cpu", action="store_true", help="build the model on the CPU")
    args = p.parse_args(argv)

    from ..configs import get_dataset_config
    from ..models import create_model
    from ..train import create_train_state, save_checkpoint
    from ..utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    sd, epoch, metrics = read_reference(args.torch_checkpoint)
    config = get_dataset_config(args.dataset)
    model = load_reference_weights(create_model(args.model, config, device=device), sd)
    state = create_train_state(model, config)
    path = save_checkpoint(
        args.output, state, epoch, metrics=metrics,
        metadata={"model_name": args.model, "dataset": args.dataset,
                  "imported_from": args.torch_checkpoint},
    )
    print(f"Imported {args.torch_checkpoint} -> {path}")
    return path


if __name__ == "__main__":
    main()
