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
run and the other way round.

`save_checkpoint_sharded` / `load_checkpoint_sharded` are the sharded
backend, the counterpart of the JAX `save_checkpoint_orbax` /
`load_checkpoint_orbax`: a directory of `torch.distributed.checkpoint`
files, `index.json` and `meta.json`. Under a mesh each rank writes only its
own parts, each a plain tensor keyed with its place in the full tensor,
and no rank assembles the whole model; a checkpoint written on one layout
loads into any other.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


# ─── the sharded backend: torch.distributed.checkpoint directories ──────

def _write_meta(path: str, epoch: int, metrics, metadata) -> None:
    meta = {"epoch": int(epoch), "metrics": metrics or {}, "metadata": metadata or {}}
    with open(path, "w") as f:
        json.dump(meta, f, indent=2, default=float)


def _read_meta(path: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _flat_boxes(shape: Sequence[int], a: int, b: int) -> List[Tuple[Tuple[int, ...],
                                                                   Tuple[int, ...]]]:
    """Boxes (offsets, sizes) that cover the row-major flat indices [a, b)
    of a tensor of `shape`, in order; each box is a contiguous run."""
    if a >= b:
        return []
    if not shape:
        return [((), ())]
    inner = math.prod(shape[1:])
    first, last = a // inner, (b - 1) // inner

    def row(r, lo, hi):
        return [((r, *o), (1, *z)) for o, z in _flat_boxes(shape[1:], lo, hi)]

    if first == last:
        return row(first, a - first * inner, b - first * inner)
    out = []
    if a % inner:
        out += row(first, a % inner, inner)
        first += 1
    whole = b // inner
    if whole > first:
        out.append(((first,) + (0,) * (len(shape) - 1), (whole - first, *shape[1:])))
    if b % inner:
        out += row(whole, 0, b % inner)
    return out


def _pieces(local: torch.Tensor, shape: Sequence[int], flat: Optional[Tuple[int, int]],
            layout) -> Tuple[List[Tuple[torch.Tensor, Tuple[int, ...]]], Tuple[int, ...]]:
    """This rank's parts of one tensor, each with its place in the full
    tensor: ([(view of `local`, offsets in the full tensor)], full shape).

    `shape` is the rank's tensor-parallel part (the tensor itself when it
    is not split); with `flat` = (a, b) the rank holds only its flat
    indices [a, b) of that part, `local` being the FSDP flat shard;
    `layout` (shard, dim, blocks) is the split over an axis
    (`parallel.mesh.param_layouts`): the part holds, along `dim`, this
    rank's slice of each of `blocks` equal blocks."""
    shape = tuple(shape)
    if flat is None:
        boxes = [((0,) * len(shape), local)]
    else:
        a = flat[0]
        boxes = []
        for off, size in _flat_boxes(shape, *flat):
            start = sum(o * math.prod(shape[d + 1:]) for d, o in enumerate(off)) - a
            boxes.append((off, local[start:start + math.prod(size)].view(size)))
    if layout is None:
        return [(view, off) for off, view in boxes], shape
    shard, dim, blocks = layout
    width = shape[dim] // blocks  # this rank's slice of one block
    full = list(shape)
    full[dim] = shape[dim] * shard.count
    out = []
    for off, view in boxes:
        t, end = off[dim], off[dim] + view.shape[dim]
        while t < end:
            seg = min(end, (t // width + 1) * width) - t
            place = list(off)
            place[dim] = (t // width) * width * shard.count + shard.index * width + t % width
            out.append((view.narrow(dim, t - off[dim], seg), tuple(place)))
            t += seg
    return out, tuple(full)


def _box_key(key: str, offsets: Sequence[int]) -> str:
    """The checkpoint key of one saved piece: its tensor's key and offsets."""
    return f"{key}@{','.join(str(int(o)) for o in offsets)}"


def _sharded_items(state, ema: bool, saving: bool) -> Dict[str, Tuple[list, Tuple[int, ...]]]:
    """Every tensor of the payload this rank holds, by checkpoint key, with
    its pieces (`_pieces`): `model.<name>` (parameters and buffers: Omega,
    the redraw counters), `optimizer.<parameter>.<key>` (moments, momentum
    traces, step counts) and, with `ema`, `ema.<parameter>`. A pipeline
    stage other than the first leaves out the tensors every stage holds
    (embedding and head) when `saving`: the first stage writes them."""
    mesh = getattr(state, "mesh", None)
    layouts, fsdp, skip = {}, None, set()
    if mesh is not None:
        from ..parallel.mesh import param_layouts

        layouts, fsdp = param_layouts(state.model), state.fsdp
        stage = getattr(state.model, "stage", None)
        if saving and stage is not None and stage.shard.index > 0:
            skip = {n for n in state.model.state_dict()
                    if not n.startswith("transformer_blocks.")}
    owned = dict(state._stepped())

    def pieces(name, t):
        if fsdp is not None and name in fsdp.meta:
            shape, n, per = fsdp.meta[name]
            a = fsdp.shard.index * per
            flat = (min(a, n), min(a + per, n))
            return _pieces(t, shape, flat, layouts.get(name))
        return _pieces(t, t.shape, None, layouts.get(name))

    items = {}
    for name, t in state.model.state_dict().items():
        if name not in skip:
            items[f"model.{name}"] = pieces(name, owned.get(name, t))
    for name, p in owned.items():
        if name in skip:
            continue
        for key, value in state.optimizer.state.get(p, {}).items():
            if torch.is_tensor(value):
                items[f"optimizer.{name}.{key}"] = (pieces(name, value) if value.dim() > 0
                                                    else _pieces(value, (), None, None))
        if ema:
            items[f"ema.{name}"] = pieces(name, state.ema_params[name])
    return {k: v for k, v in items.items() if v[0]}


def _materialise_optimizer(state, index, saved) -> None:
    """Make the optimiser state entries that the checkpoint holds and a
    fresh optimiser has not made yet (torch's Adam makes its moments and
    step count at the first update), as `Optimizer.load_state_dict` would:
    zeros shaped like the tensor they belong to, a step count on the
    parameter's device when the group is capturable, else on the CPU."""
    groups = {id(p): g for g in state.optimizer.param_groups for p in g["params"]}
    for name, p in state._stepped():
        per = state.optimizer.state[p]
        prefix = f"optimizer.{name}."
        for key, entry in index.items():
            if not key.startswith(prefix) or key[len(prefix):] in per:
                continue
            dtype = saved[_box_key(key, entry["boxes"][0][0])].properties.dtype
            if not entry["shape"]:
                group = groups[id(p)]
                device = p.device if group.get("capturable") or group.get("fused") else "cpu"
                per[key[len(prefix):]] = torch.zeros((), dtype=dtype, device=device)
            else:
                per[key[len(prefix):]] = torch.zeros_like(p, dtype=dtype)


def _no_dist(state) -> bool:
    return getattr(state, "mesh", None) is None


def save_checkpoint_sharded(
    path: str,
    state,
    epoch: int,
    metrics: Optional[Dict[str, Any]] = None,
    metadata: Optional[Dict[str, Any]] = None,
) -> str:
    """Write a sharded checkpoint directory at `path`: the counterpart of
    the JAX `save_checkpoint_orbax`, with `torch.distributed.checkpoint`
    in place of Orbax. Its payload is the single-file checkpoint's: the
    step, the model (parameters, Omega, the redraw counters), the
    optimiser state and, when an EMA is tracked, the EMA shadow; beside it
    `meta.json` holds {epoch, metrics, metadata}.

    For a state on a mesh every rank calls it, and each rank writes only
    its own parts (its tensor-parallel slices, FSDP flat shards, pipeline
    stage's blocks), each a plain tensor under its key and its offsets in
    the full tensor (`model.<name>@<offsets>`); what several ranks hold
    alike is written once. `index.json` lists each tensor's full shape and
    its pieces' boxes. No rank gathers the whole model. A single-device
    state writes the whole payload alone."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    sd, index = {}, {}
    for key, (pieces, full) in _sharded_items(state, state.ema_params is not None,
                                              saving=True).items():
        index[key] = {"shape": list(full), "boxes": []}
        for view, off in pieces:
            sd[_box_key(key, off)] = view.detach().clone(memory_format=torch.contiguous_format)
            index[key]["boxes"].append([list(off), list(view.shape)])
    sd["step"] = torch.tensor(int(state.step), dtype=torch.int64)
    dcp.save(sd, checkpoint_id=path, no_dist=_no_dist(state))
    if not _no_dist(state):
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, index)
        index = {}
        for part in ranks:
            for key, entry in part.items():
                boxes = index.setdefault(key, {"shape": entry["shape"], "boxes": []})["boxes"]
                boxes += [b for b in entry["boxes"] if b not in boxes]
    if _no_dist(state) or dist.get_rank() == 0:
        with open(os.path.join(path, "index.json"), "w") as f:
            json.dump(index, f)
        _write_meta(os.path.join(path, "meta.json"), epoch, metrics, metadata)
    return path


def load_checkpoint_sharded(path: str, state) -> Tuple[Any, Dict[str, Any]]:
    """Restore a sharded checkpoint directory into a template TrainState, in
    place; returns (state, meta dict): the counterpart of the JAX
    `load_checkpoint_orbax`. Resume at meta['epoch'] + 1.

    Each rank of a state on a mesh reads only the saved pieces that
    overlap the parts its layout holds, whatever layout wrote them (a
    checkpoint saved on data=2 with FSDP loads into one process, one saved
    in one process onto model=2), and copies each overlap into the
    template's own tensors, whose addresses a captured CUDA graph holds. A
    checkpoint without an EMA shadow loads into a state that tracks one:
    the shadow starts at the restored parameters (the JAX pre-EMA
    fallback)."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    ema = state.ema_params is not None and any(k.startswith("ema.") for k in index)
    _materialise_optimizer(state, index, saved)
    sd, copies = {}, []
    for key, (pieces, full) in _sharded_items(state, ema, saving=False).items():
        if key not in index:
            raise ValueError(f"checkpoint {path} holds no {key}")
        if tuple(index[key]["shape"]) != full:
            raise ValueError(f"checkpoint {key}: shape {tuple(index[key]['shape'])}, "
                             f"template {full}")
        for view, off in pieces:
            covered = 0
            for boff, bsize in index[key]["boxes"]:
                lo = [max(a, b) for a, b in zip(off, boff)]
                hi = [min(a + n, b + m) for a, n, b, m in zip(off, view.shape, boff, bsize)]
                if any(l >= h for l, h in zip(lo, hi)):
                    continue
                name = _box_key(key, boff)
                if name not in sd:
                    sd[name] = torch.empty(bsize, dtype=saved[name].properties.dtype,
                                           device=view.device)
                copies.append((view[tuple(slice(l - o, h - o) for l, h, o in zip(lo, hi, off))],
                               sd[name][tuple(slice(l - o, h - o)
                                              for l, h, o in zip(lo, hi, boff))]))
                covered += math.prod(h - l for l, h in zip(lo, hi))
            if covered != view.numel():  # the saved boxes are disjoint
                raise ValueError(f"checkpoint {path} covers {covered} of the "
                                 f"{view.numel()} elements of {key} at {off}")
    sd["step"] = torch.zeros((), dtype=torch.int64)
    dcp.load(sd, checkpoint_id=path, no_dist=_no_dist(state))
    with torch.no_grad():
        for view, part in copies:
            view.copy_(part)
        if state.ema_params is not None and not ema:  # pre-EMA: shadow := params
            for name, p in state._stepped():
                state.ema_params[name].copy_(p)
    state.step = int(sd["step"])
    return state, _read_meta(os.path.join(path, "meta.json"))


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
