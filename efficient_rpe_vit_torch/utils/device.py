"""Device resolution for the port's entry points: the GPU unless the
caller names another device, and never a silent fall back to the CPU."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """None -> the current CUDA device, raising when there is none; anything
    else is taken as given (e.g. "cpu" for the CPU tests), with a bare
    "cuda" pinned to the current device's index."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU by "
                "default, pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
