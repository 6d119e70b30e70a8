"""The mesh of ranks and the sharding rules of the port's parameters.

Counterpart of `efficient_rpe_vit_tpu/parallel/mesh.py`. A `Mesh` lays
the world's ranks out row-major on named axes, as the JAX package lays out
devices:

  * 'data'   batch (data parallel: gradients are averaged over it);
  * 'model'  tensor parallel (Megatron): `attention.qkv` and `mlp.0` split
    their output features, `attention.proj` and `mlp.3` their input
    features, `omega`, `rpe.rel_pos_bias` and `rpe.circulant_coeffs` their
    heads; one all-reduce after each block's attention and MLP;
  * 'seq'    context parallel inside the attention core (`seq_mesh`);
  * 'expert' the soft-MoE experts (`expert_mesh`).

Each axis has one process group per slice of the grid (`dist.new_group`
over the ranks that differ only on that axis), built once by every rank,
so the same mesh serves gloo on the CPU, gloo over ranks that share a
card and NCCL; `init_device_mesh` would tie the mesh to one device type
and set each rank's current device.

`make_param_specs` gives every tensor of a model's state dict a `Spec`;
`shard_model` applies the 'model' rules to a model in place. The port's
`qkv` weight is [3 * dim, dim] with q, k and v blocks, so a rank takes its
heads' rows from each block (`Spec.blocks` = 3), where the JAX layout
P(None, 'model') is resharded by GSPMD. A rule that does not divide
replicates, as in JAX; the attention's tensors split together only when
the heads divide over the axis.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..utils.device import resolve_device
from .comm import Shard, _gather


class Mesh:
    """The world's ranks on named axes, row-major; `get_group(name)` is the
    process group of this rank's slice along `name`."""

    def __init__(self, shape: Mapping[str, int],
                 device: Union[str, torch.device, None] = None):
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs a process group: call "
                               "parallel.initialize_multihost first")
        self.axis_names = tuple(shape)
        self.shape = {name: int(n) for name, n in shape.items()}
        sizes = tuple(self.shape.values())
        world = dist.get_world_size()
        if int(np.prod(sizes)) != world:
            raise ValueError(f"mesh {self.shape} needs {int(np.prod(sizes))} ranks, the "
                             f"world has {world}")
        self.device = resolve_device(device)
        rank = dist.get_rank()
        grid = np.arange(world).reshape(sizes)
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(rank, sizes))))
        self._groups = {}
        for axis, name in enumerate(self.axis_names):
            for ranks in np.moveaxis(grid, axis, -1).reshape(-1, sizes[axis]):
                group = dist.new_group([int(r) for r in ranks])
                if rank in ranks:
                    self._groups[name] = group

    def __contains__(self, name: str) -> bool:
        return name in self.shape

    def __deepcopy__(self, memo):
        return self

    def get_group(self, name: str):
        return self._groups[name]

    def size(self, name: str) -> int:
        """The axis size; 1 for an axis the mesh lacks."""
        return self.shape.get(name, 1)

    def index(self, name: str) -> int:
        """This rank's coordinate on the axis; 0 for an axis the mesh lacks."""
        return self.coords.get(name, 0)

    def shard(self, name: str) -> Shard:
        return Shard(self.get_group(name), self.index(name), self.size(name))


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              axis_names: Tuple[str, str] = ("data", "model"),
              device: Union[str, torch.device, None] = None) -> Mesh:
    """A 2-D (data, model) mesh over every rank; pure data parallel by
    default. `device` is where the ranks' tensors live (None: the GPU)."""
    n_total = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        if n_total % n_model != 0:
            raise ValueError(f"{n_total} ranks not divisible by n_model={n_model}")
        n_data = n_total // n_model
    if n_data * n_model != n_total:
        raise ValueError(f"mesh {n_data}x{n_model} != {n_total} ranks")
    return Mesh(dict(zip(axis_names, (n_data, n_model))), device)


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """'data=2,seq=2' -> {'data': 2, 'seq': 2}."""
    try:
        pairs = [kv.split("=") for kv in spec.split(",")]
        return {name.strip(): int(n) for name, n in pairs}
    except ValueError:
        raise ValueError(f"mesh spec {spec!r} is not 'axis=size[,axis=size...]'") from None


def make_mesh_from_spec(spec: str, device: Union[str, torch.device, None] = None) -> Mesh:
    """The mesh of a CLI spec such as 'data=2,seq=2' over every rank."""
    return Mesh(parse_mesh_spec(spec), device)


# ─── sharding rules ─────────────────────────────────────────────────────

class Spec(NamedTuple):
    """How a tensor lies on the mesh: `dims` names the mesh axis each of its
    dims is split over (None: whole); the split dim holds `blocks` equal
    blocks, each split over the axis (qkv's q, k and v); `fsdp` is the axis
    it is flat-sharded over at rest."""

    dims: Tuple[Optional[str], ...] = ()
    blocks: int = 1
    fsdp: Optional[str] = None

    @property
    def axis(self) -> Optional[str]:
        return next((a for a in self.dims if a is not None), None)

    @property
    def dim(self) -> Optional[int]:
        return next((d for d, a in enumerate(self.dims) if a is not None), None)


def batch_spec(data_axis: str = "data") -> Spec:
    """Batch-dim sharding for inputs and labels."""
    return Spec((data_axis,))


_ATTENTION = ("attention.qkv.weight", "attention.qkv.bias", "attention.proj.weight",
              "attention.omega", "rpe.rel_pos_bias", "rpe.circulant_coeffs")
_MLP = ("mlp.0.weight", "mlp.0.bias", "mlp.3.weight")
_EXPERTS = ("mlp.w1", "mlp.b1", "mlp.w2", "mlp.b2")


def _model_spec(suffix: str, ndim: int, axis: str) -> Spec:
    if suffix == "attention.qkv.weight":
        return Spec((axis, None), blocks=3)
    if suffix == "attention.qkv.bias":
        return Spec((axis,), blocks=3)
    if suffix in ("attention.proj.weight", "mlp.3.weight"):
        return Spec((None, axis))
    return Spec((axis,) + (None,) * (ndim - 1))


def _blocks(names: Iterable[str]) -> Dict[str, Dict[str, str]]:
    """block prefix ('transformer_blocks.3.') -> {rule suffix: name}."""
    out: Dict[str, Dict[str, str]] = {}
    for name in names:
        for suffix in _ATTENTION + _MLP + _EXPERTS:
            if name.endswith(suffix):
                out.setdefault(name[: -len(suffix)], {})[suffix] = name
    return out


def make_param_specs(model_or_state_dict: Union[nn.Module, Mapping[str, torch.Tensor]],
                     mesh: Mesh, model_axis: str = "model",
                     fsdp_axis: Optional[str] = None,
                     expert_axis: str = "expert") -> Dict[str, Spec]:
    """A `Spec` for every tensor of a model's state dict (parameters and
    Omega): the Megatron rules over `model_axis` (see the module
    docstring), the MoE experts over `expert_axis`, the rest replicated.
    As in JAX, a rule splits only over an axis of more than one rank.

    A block's attention tensors split only when its heads (a model's
    `attention.heads`, or the leading dim of a head-structured tensor in a
    state dict) and the qkv blocks divide over the axis; its MLP tensors
    when the hidden width does. With `fsdp_axis`, every parameter is also
    flat-sharded over that axis at rest (`train_parallel`): a layout only,
    which differs from the JAX package's split of the largest divisible
    dim.
    """
    if isinstance(model_or_state_dict, nn.Module):
        state = model_or_state_dict.state_dict()
        params = {n for n, _ in model_or_state_dict.named_parameters()}
        heads = {name[: -len("attention")]: m.heads
                 for name, m in model_or_state_dict.named_modules()
                 if name.endswith("attention") and hasattr(m, "heads")}
    else:
        state = dict(model_or_state_dict)
        params = {n for n in state if not n.endswith(("omega", "redraw_counter"))}
        heads = {}
    size = mesh.size(model_axis) if mesh.size(model_axis) > 1 else 0
    specs = {name: Spec() for name in state}
    for prefix, found in _blocks(state).items():
        if size:
            attn = [s for s in _ATTENTION if s in found]
            qkv = state[found["attention.qkv.weight"]] if "attention.qkv.weight" in found else None
            h = heads.get(prefix)
            if h is None:
                h = next((state[found[s]].shape[0] for s in _ATTENTION[3:] if s in found), None)
            if (qkv is not None and (qkv.shape[0] // 3) % size == 0
                    and (h is None or h % size == 0)):
                for s in attn:
                    specs[found[s]] = _model_spec(s, state[found[s]].dim(), model_axis)
            fc1 = found.get("mlp.0.weight")
            if fc1 is not None and state[fc1].shape[0] % size == 0:
                for s in _MLP:
                    specs[found[s]] = _model_spec(s, state[found[s]].dim(), model_axis)
        if mesh.size(expert_axis) > 1:
            for s in _EXPERTS:
                if s in found:
                    specs[found[s]] = Spec((expert_axis,) + (None,) * (state[found[s]].dim() - 1))
    if fsdp_axis is not None and fsdp_axis in mesh:
        specs = {name: s._replace(fsdp=fsdp_axis) if name in params else s
                 for name, s in specs.items()}
    return specs


def local_slice(t: torch.Tensor, dim: int, blocks: int, index: int, count: int) -> torch.Tensor:
    """Rank `index`'s part of a full tensor split over `count` ranks along
    `dim`, which holds `blocks` equal blocks each split separately."""
    return torch.cat([b.chunk(count, dim)[index] for b in t.chunk(blocks, dim)], dim)


def join_slices(parts, dim: int, blocks: int) -> torch.Tensor:
    """The full tensor from every rank's `local_slice`, in rank order."""
    per_block = [p.chunk(blocks, dim) for p in parts]
    return torch.cat([torch.cat([p[b] for p in per_block], dim) for b in range(blocks)], dim)


def shard_pytree(tree: Mapping[str, torch.Tensor], specs: Mapping[str, Spec],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's part of each full tensor by its spec's split (the flat
    FSDP shard is `train_parallel`'s)."""
    out = {}
    for name, t in tree.items():
        s = specs.get(name, Spec())
        if s.axis is not None:
            t = local_slice(t, s.dim, s.blocks, mesh.index(s.axis), mesh.size(s.axis))
        out[name] = t
    return out


# ─── sharding a model ───────────────────────────────────────────────────

Layout = Tuple[Shard, int, int]  # (the axis's shard, split dim, blocks)


def param_layouts(model: nn.Module) -> Dict[str, Layout]:
    """The split tensors of a sharded model, by state-dict name: what
    `shard_model` split over 'model' and the experts an `expert_mesh` MoE
    holds (each module's `split`)."""
    out: Dict[str, Layout] = {}
    for name, m in model.named_modules():
        for leaf, layout in getattr(m, "split", {}).items():
            out[f"{name}.{leaf}" if name else leaf] = layout
    return out


def gather_full(local: torch.Tensor, layout: Layout) -> torch.Tensor:
    """The full tensor from every rank's part (a collective over the
    layout's axis)."""
    shard, dim, blocks = layout
    parts = _gather(local.contiguous(), shard.group, dim).chunk(shard.count, dim)
    return join_slices(parts, dim, blocks)


@torch.no_grad()
def shard_model(model: nn.Module, mesh: Mesh, model_axis: str = "model") -> nn.Module:
    """Make `model` (the full model, the same on every rank) this rank's
    tensor-parallel part, in place, by `make_param_specs`' rules over
    `model_axis`: each split tensor is replaced by its slice (and recorded
    in its module's `split`), the attention modules and their RPEs keep
    heads / P heads of width dim / P, and the split attention and MLP
    layers run the Megatron collectives (their `tp`). The residual stream
    stays `dim` wide. A mesh without the axis, or a model split already,
    is left as it is. Call it before the optimiser is made."""
    from ..models.layers import Mlp, TransformerBlock

    if model_axis not in mesh or any(getattr(m, "tp", None) is not None
                                     for m in model.modules()):
        return model  # nothing to split, or split already
    shard = mesh.shard(model_axis)
    for name, s in make_param_specs(model, mesh, model_axis).items():
        if s.axis != model_axis:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        full = getattr(owner, leaf)
        local = local_slice(full, s.dim, s.blocks, shard.index, shard.count).clone()
        if leaf in owner._parameters:
            owner._parameters[leaf] = nn.Parameter(local, requires_grad=full.requires_grad)
        else:
            owner._buffers[leaf] = local
        owner.__dict__.setdefault("split", {})[leaf] = (shard, s.dim, s.blocks)
    for block in model.modules():
        if not isinstance(block, TransformerBlock):
            continue
        attn, mlp = block.attention, block.mlp
        if "weight" in getattr(attn.qkv, "split", {}):
            attn.heads //= shard.count
            attn.inner //= shard.count
            attn.qkv.out_features //= shard.count
            attn.proj.in_features //= shard.count
            attn.tp = shard
            if block.rpe is not None:
                block.rpe.heads //= shard.count
        if isinstance(mlp, Mlp) and "weight" in getattr(mlp[0], "split", {}):
            mlp[0].out_features //= shard.count
            mlp[3].in_features //= shard.count
            mlp[2].shard = (shard.index, shard.count)
            mlp.tp = shard
    return model
