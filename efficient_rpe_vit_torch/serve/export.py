"""Ahead-of-time export of the deterministic forward with `torch.export`.

Counterpart of `efficient_rpe_vit_tpu/serve/export.py`:

  * **Weights are inside.** The exported program holds the trained
    parameters and buffers (Omega included) as its own state, so the
    artifact is self-contained: `load_exported` and call.
  * **Symbolic batch.** The batch dim is exported as a `torch.export.Dim`
    of min 1, so one artifact serves every batch size.
  * **Reduced weights.** `weights_dtype="bfloat16"` stores every floating
    parameter and persistent buffer in bf16 (JAX casts the whole variables
    tree); the program casts them back to the model's parameter dtype
    before use, so it computes the model on bf16-rounded weights.
    `weights_dtype="int8"` stores the trained parameters of ndim >= 2 as
    `_quantize_int8_params` does: weight-only, symmetric, per output
    channel, dequantized inside the program.
  * **The kernels stay kernels.** Each hand-written forward kernel is a
    custom op of the `efficient_rpe_vit` namespace (`ops/kernels/
    _library.py`) with a shape-only fake version, so the program holds one
    node per kernel call and, on the card, launches the kernel. Unlike a
    StableHLO blob, a program with custom ops needs their library
    registered in the process that loads it: importing this package does
    that, and nothing of `models/`, `configs/` or `train/` is needed.
  * **Export on the CPU, serve on the card.** The JAX artifact lowers for
    ("cpu", "tpu") at once; here a program exported on the CPU holds the
    same custom-op nodes, and `load_exported` moves it to the card
    (`torch.export.passes.move_to_device_pass`), where they launch the
    kernels.

The sidecar `<path>.meta.json` carries the JAX sidecar's keys, with the
device the program was exported on in place of `platforms`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..ops import kernels as _kernels  # noqa: F401 (registers the custom ops)
from ..utils.device import resolve_device

_EXPORT_SUFFIX = ".meta.json"
QUANTIZATION = ("weight-only symmetric per-output-channel int8 (float params with "
                "ndim>=2; constants and bias/norm vectors stay fp32)")
_WEIGHTS_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16,
                   "int8": torch.int8}


def _weights_dtype(weights_dtype) -> Optional[torch.dtype]:
    """None, a name in _WEIGHTS_DTYPES or one of those torch dtypes."""
    if isinstance(weights_dtype, torch.dtype) and weights_dtype in _WEIGHTS_DTYPES.values():
        return weights_dtype
    if weights_dtype not in _WEIGHTS_DTYPES:
        raise ValueError(f"weights_dtype must be one of {list(_WEIGHTS_DTYPES)}, "
                         f"got {weights_dtype!r}")
    return _WEIGHTS_DTYPES[weights_dtype]


def quantize_int8(a: torch.Tensor, channel_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(round(a / s) clipped to [-127, 127] as int8, s fp32) with s = amax /
    127 over every dim but `channel_dim` (1 where amax is 0), kept as size-1
    dims: `_quantize_int8_params`'s scheme."""
    a = a.detach().float()
    dims = [d for d in range(a.dim()) if d != channel_dim % a.dim()]
    amax = a.abs().amax(dim=dims, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8), scale


def _channel_dims(model: nn.Module) -> Dict[str, int]:
    """Each parameter's output-channel dim: the first for Linear weights
    (stored [out, in], the flax kernel transposed), the last for the rest,
    which keep the flax layout."""
    linear = {f"{name}.weight" if name else "weight"
              for name, m in model.named_modules() if isinstance(m, nn.Linear)}
    return {name: 0 if name in linear else -1 for name, _ in model.named_parameters()}


class ServedForward(nn.Module):
    """The eval forward of `model` on weights stored in `weights_dtype`.

    Every parameter and buffer of the model is held here as a buffer (dots
    in names become "__"): int8 values and their fp32 scales for the
    quantized parameters, bf16 copies of the floating state for
    "bfloat16", the tensors as they are otherwise. `forward` rebuilds the
    model's tensors from them (dequantized, or cast back to their dtype;
    a parameter its module lists in `keeps_param_dtype` stays bf16, since
    the module computes in its dtype as flax does) and calls the model
    through `torch.func.functional_call`. The model itself is not a
    submodule, so none of its own tensors enters an exported program.
    """

    def __init__(self, model: nn.Module, weights_dtype=None,
                 device: Optional[torch.device] = None):
        super().__init__()
        wd = _weights_dtype(weights_dtype)
        self._model = (model,)
        persistent = set(model.state_dict())
        channel = _channel_dims(model)
        own_dtype = {f"{prefix}.{name}" if prefix else name
                     for prefix, m in model.named_modules()
                     for name in getattr(m, "keeps_param_dtype", ())}
        self.kinds: Dict[str, Tuple[str, torch.dtype]] = {}
        tensors = dict(model.named_parameters())
        tensors.update(model.named_buffers())
        for name, t in tensors.items():
            key = name.replace(".", "__")
            t = t.detach().to(device)
            kind = "as_is"
            if wd == torch.int8 and name in channel and t.is_floating_point() and t.dim() >= 2:
                q, scale = quantize_int8(t, channel[name])
                self.register_buffer(key + "__q", q)
                self.register_buffer(key + "__scale", scale)
                kind = "int8"
            elif wd == torch.bfloat16 and name in persistent and t.is_floating_point():
                self.register_buffer(key, t.to(torch.bfloat16))
                kind = "as_is" if name in own_dtype else "bf16"
            else:
                self.register_buffer(key, t.clone())
            self.kinds[name] = (kind, t.dtype)

    @property
    def model(self) -> nn.Module:
        return self._model[0]

    def stored(self, name: str) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """What is held for the model's tensor `name`: (int8 values, scales)
        for a quantized parameter, else the stored tensor."""
        key = name.replace(".", "__")
        if self.kinds[name][0] == "int8":
            return getattr(self, key + "__q"), getattr(self, key + "__scale")
        return getattr(self, key)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tensors = {}
        for name, (kind, dtype) in self.kinds.items():
            held = self.stored(name)
            if kind == "int8":
                q, scale = held
                held = q.float() * scale
            tensors[name] = held.to(dtype) if kind != "as_is" else held
        return torch.func.functional_call(self.model, tensors, (x,))


def export_forward(model: nn.Module, *, image_size: int, in_channels: int,
                   weights_dtype=None, device=None) -> torch.export.ExportedProgram:
    """Export `model`'s deterministic forward with its weights inside.

    Args:
        model: a port ViT (any factory variant); it is traced in eval mode
            and left in the mode it was in.
        image_size / in_channels: the input geometry: NHWC float32 images
            [b, image_size, image_size, in_channels], b symbolic (>= 1).
        weights_dtype: None / "float32" (the weights as they are),
            "bfloat16" or "int8" (module docstring).
        device: where the program is traced and its weights live; None
            means the GPU, and raises when there is none.
    Returns:
        torch.export.ExportedProgram (save with `torch.export.save`).
    """
    device = resolve_device(device)
    served = ServedForward(model, weights_dtype, device)
    x = torch.zeros(2, image_size, image_size, in_channels, device=device)
    batch = torch.export.Dim("b", min=1)
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return torch.export.export(served, (x,), dynamic_shapes=({0: batch},),
                                       strict=False)
    finally:
        model.train(training)


def _exported_device(exported: torch.export.ExportedProgram) -> Optional[torch.device]:
    for t in (*exported.state_dict.values(), *exported.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    return None


def save_exported(path: str, model: nn.Module, *, image_size: int, in_channels: int,
                  weights_dtype=None, metadata: Optional[Dict[str, Any]] = None,
                  device=None) -> str:
    """Export (`export_forward`), then write `path` (`torch.export.save`)
    and `path.meta.json`. Returns path."""
    exported = export_forward(model, image_size=image_size, in_channels=in_channels,
                              weights_dtype=weights_dtype, device=device)
    for node in exported.graph.nodes:
        # the exporting process's source lines: they name its files
        node.meta.pop("stack_trace", None)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(exported, path)
    wd = _weights_dtype(weights_dtype)
    outputs = [n for n in exported.graph.nodes if n.op == "output"][0].args[0]
    meta = {
        "format": "torch.export",
        "device": str(_exported_device(exported)),
        "weights_dtype": str(wd).removeprefix("torch.") if wd is not None else "unchanged",
        **({"quantization": QUANTIZATION} if wd == torch.int8 else {}),
        "input_shape": ["b", image_size, image_size, in_channels],
        "out_avals": [
            {"shape": [str(s) if isinstance(s, int) else "b" for s in o.meta["val"].shape],
             "dtype": str(o.meta["val"].dtype).removeprefix("torch.")}
            for o in outputs
        ],
        "metadata": metadata or {},
    }
    with open(path + _EXPORT_SUFFIX, "w") as f:
        json.dump(meta, f, indent=2)
    return path


def load_exported(path: str, device=None) -> Tuple[Callable[[torch.Tensor], torch.Tensor],
                                                     Dict[str, Any]]:
    """Load an artifact written by `save_exported`.

    Args:
        device: where to serve; None means the GPU, and raises when there is
            none. A program exported on another device is moved there.
    Returns:
        (fn, meta): `fn(x) -> logits`, run under `torch.inference_mode()`,
        and the sidecar's dict ({} if the sidecar is missing).
    """
    device = resolve_device(device)
    exported = torch.export.load(path)
    if _exported_device(exported) != device:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, device)
    module = exported.module()
    meta: Dict[str, Any] = {}
    if os.path.exists(path + _EXPORT_SUFFIX):
        with open(path + _EXPORT_SUFFIX) as f:
            meta = json.load(f)

    def fn(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return module(x)

    return fn, meta
