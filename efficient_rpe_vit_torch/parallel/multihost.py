"""Joining a multi-process run, and each process's share of the data.

Counterpart of `efficient_rpe_vit_tpu/parallel/multihost.py`. Here every
rank is one process with one device (or a share of one):

  * `initialize` joins the process group, once, before any mesh is made:
    with no address it reads torchrun's `env://` variables (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT); `host:port` with an explicit
    size and rank is the train CLI's `--distributed COORD`;
  * data: every process computes the same global permutation (the seeds
    are the same) and keeps its data rank's rows (`host_batch_slice`,
    `global_batch`);
  * IO: checkpoints, metrics and logs are written once, on the
    coordinator (`is_coordinator`).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend() -> str:
    """NCCL when every rank can own a card, else gloo (the CPU, or several
    ranks sharing a card)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if torch.cuda.is_available() and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def local_device(cpu: bool = False) -> torch.device:
    """This rank's device: the CPU, or card local_rank mod the card count
    (ranks beyond the cards share them)."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join this process into a multi-process run; a second call is a
    no-op, as in the JAX package.

    With no address, torchrun's environment gives the rendezvous, size and
    rank; with 'host:port', `num_processes` and `process_id` are needed.
    `backend` None takes `default_backend()`; with NCCL the process's
    current card is set to `local_device()` first.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None:
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise RuntimeError("initialize() without an address reads torchrun's "
                               f"environment; {', '.join(missing)} not set")
        init, size, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator address needs num_processes "
                             "and process_id")
        init, size, rank = f"tcp://{coordinator_address}", num_processes, process_id
        os.environ.setdefault("WORLD_SIZE", str(size))
    backend = backend or default_backend()
    if backend == "nccl":
        os.environ.setdefault("LOCAL_RANK", str(rank))
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method=init, world_size=size, rank=rank)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """True on exactly one process (rank 0): gate file writes and the
    logs people read on it."""
    return process_index() == 0


def host_batch_slice(global_batch_size: int, mesh=None, axis: str = "data") -> slice:
    """This rank's contiguous rows of the global batch: its coordinate on
    the mesh's `axis` (ranks that share it run the same rows), or its
    process index without a mesh. A ragged split raises early (it would
    deadlock the collectives mid-epoch instead)."""
    n, i = ((mesh.size(axis), mesh.index(axis)) if mesh is not None
            else (process_count(), process_index()))
    if global_batch_size % n:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by {n} "
            f"{'data ranks' if mesh is not None else 'processes'}: pick a batch "
            "size that is (each rank feeds an equal share)")
    per = global_batch_size // n
    return slice(i * per, (i + 1) * per)


def global_batch(local_tree, mesh, axis: str = "data"):
    """The tensors a data-parallel step takes on this rank: each leaf of
    `local_tree` (a tensor or array, or a dict / list / tuple of them)
    holding this rank's rows of the global batch (`host_batch_slice`),
    as tensors on the mesh's device. The JAX package assembles one global
    array from such pieces; here the rows stay with their rank."""
    if isinstance(local_tree, dict):
        return {k: global_batch(v, mesh, axis) for k, v in local_tree.items()}
    if isinstance(local_tree, (list, tuple)):
        return type(local_tree)(global_batch(v, mesh, axis) for v in local_tree)
    return torch.as_tensor(np.asarray(local_tree) if not torch.is_tensor(local_tree)
                           else local_tree, device=mesh.device)


def broadcast_scalar(value, root: int = 0):
    """Agree on one Python scalar across processes (an epoch's seed, a
    resume epoch read from disk by the coordinator)."""
    box = [value]
    dist.broadcast_object_list(box, src=root)
    return box[0]


def sync(tag: str = "sync") -> None:
    """Barrier across processes (`tag` names it in logs only)."""
    dist.barrier()
