"""Checkpoint save / load: the model, the optimiser, the EMA shadow, and a
metadata sidecar.

Counterpart of `efficient_rpe_vit_tpu/train/checkpoint.py`'s single-file
format: `<path>` is one `torch.save` file of plain tensors and numbers
(`step`, the model's `state_dict()` — parameters and the Omega / redraw
counter buffers, the JAX package's params, constants and mutable state —
the optimiser's `state_dict()`, and `ema_params` only when an EMA is
tracked), read back with `weights_only=True`; `<path>.meta.json` is the
JAX sidecar `{epoch, metrics, metadata}`. A resumed run starts at
meta['epoch'] + 1. A state on a mesh (`parallel.create_sharded_train_state`)
saves the same single file: every rank takes part in gathering the whole
model, optimiser state and EMA shadow, and the coordinator alone writes;
loading one reads it on the coordinator, broadcasts it and keeps each
rank's part. So a checkpoint saved under a mesh loads into a single-device
run and the other way round. Sharded (per-rank) files are not ported.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist


def save_checkpoint(
    path: str,
    state,
    epoch: int,
    metrics: Optional[Dict[str, Any]] = None,
    metadata: Optional[Dict[str, Any]] = None,
) -> str:
    """Write `<path>` (torch.save) and `<path>.meta.json` for a TrainState;
    for a state on a mesh every rank calls it and the coordinator writes."""
    if getattr(state, "mesh", None) is not None:
        from ..parallel.train_parallel import full_payload

        payload = full_payload(state)
        if dist.get_rank() != 0:
            return path
    else:
        payload = {
            "step": int(state.step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
        }
        # key present only when EMA is tracked, as in the JAX format
        if state.ema_params is not None:
            payload["ema_params"] = state.ema_params
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path)
    meta = {
        "epoch": int(epoch),
        "metrics": metrics or {},
        "metadata": metadata or {},
    }
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2, default=float)
    return path


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor],
               what: str) -> None:
    if set(dst) != set(src):
        missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
        raise ValueError(f"checkpoint {what} does not fit the template: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    with torch.no_grad():
        for name, t in dst.items():
            if t.shape != src[name].shape:
                raise ValueError(f"checkpoint {what} {name}: shape "
                                 f"{tuple(src[name].shape)}, template {tuple(t.shape)}")
            t.copy_(src[name])


def _load_optimizer(optimizer: torch.optim.Optimizer, saved: Dict[str, Any]) -> None:
    """`optimizer.load_state_dict(saved)`, keeping the template's own
    objects: its groups' options (the learning rate object, `capturable`,
    which depend on the device and are set again before every update) and
    the state tensors it already holds, which get the saved values copied
    in, so that a CUDA graph that captured them reads the restored state."""
    kept = {id(p): dict(optimizer.state[p]) for g in optimizer.param_groups
            for p in g["params"] if p in optimizer.state}
    options = [{k: v for k, v in g.items() if k != "params"}
               for g in optimizer.param_groups]
    optimizer.load_state_dict(saved)
    with torch.no_grad():
        for group, own in zip(optimizer.param_groups, options):
            group.update(own)
            for p in group["params"]:
                state = optimizer.state[p]
                for key, t in kept.get(id(p), {}).items():
                    new = state.get(key)
                    if isinstance(t, torch.Tensor) and isinstance(new, torch.Tensor):
                        t.copy_(new)
                        state[key] = t


def load_checkpoint(path: str, state) -> Tuple[Any, Dict[str, Any]]:
    """Restore a checkpoint into a template TrainState, in place; returns
    (state, meta dict).

    The file is mapped onto the device of the template's model (a
    checkpoint written on the card loads into a CPU run and the other way
    round). Parameters, buffers, the EMA shadow and the optimiser state are
    copied into the template's own tensors, whose addresses a captured CUDA
    graph holds. A checkpoint saved without an EMA loads into a state that
    tracks one: the shadow starts at the restored parameters. Every rank of
    a state on a mesh calls it: the coordinator reads the file, broadcasts
    it, and each rank keeps its part.
    """
    if getattr(state, "mesh", None) is not None:
        from ..parallel.train_parallel import local_payload

        box = [torch.load(path, map_location="cpu", weights_only=True)
               if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        payload = local_payload(state, box[0])
    else:
        device = next(state.model.parameters()).device
        payload = torch.load(path, map_location=device, weights_only=True)
    # the tensors the optimiser updates (the parameters, or a mesh state's
    # FSDP shards) stand in for the model's own
    stepped = dict(state._stepped())
    _copy_into({**state.model.state_dict(), **stepped}, payload["model"], "model")
    _load_optimizer(state.optimizer, payload["optimizer"])
    state.step = int(payload["step"])
    if state.ema_params is not None:
        ema = payload.get("ema_params")
        if ema is None:  # pre-EMA checkpoint: the shadow starts at the params
            ema = stepped
        _copy_into(state.ema_params, ema, "ema_params")
    meta_path = path + ".meta.json"
    meta: Dict[str, Any] = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


def model_kwargs_from_metadata(meta: Dict[str, Any]) -> Dict[str, Any]:
    """create_model kwargs recorded in a checkpoint's metadata sidecar.

    Checkpoints written by the train CLI's `--save-model` record the
    architecture knobs that the variant name alone does not carry (MoE
    MLPs, custom feature counts, depth), so consumers (the predict CLI) can
    rebuild the exact module the weights were trained in; a mismatched
    template fails the load loudly otherwise.
    """
    kwargs: Dict[str, Any] = {}
    if meta.get("mlp_type") == "moe":
        kwargs["mlp_config"] = {
            "mlp_type": "moe",
            "num_experts": int(meta.get("num_experts") or 4),
        }
    nf = meta.get("num_features")
    if nf is not None:
        kwargs["attention_config"] = {
            "num_features": nf if nf == "mxu" else int(nf)
        }
    if meta.get("depth"):
        kwargs["depth"] = int(meta["depth"])
    return kwargs
