"""Data, tensor (Megatron), FSDP, context and expert parallelism on
`torch.distributed`: the counterpart of `efficient_rpe_vit_tpu/parallel/`
without its GPipe pipeline (`pipeline.py`), which is not ported."""

from .mesh import (
    Mesh,
    Spec,
    batch_spec,
    make_mesh,
    make_mesh_from_spec,
    make_param_specs,
    shard_model,
    shard_pytree,
)
from .multihost import (
    global_batch,
    host_batch_slice,
    initialize as initialize_multihost,
    is_coordinator,
)
from .seq_parallel import (
    ring_kerple_attention,
    ring_softmax_attention,
    seq_parallel_linear_attention,
)
from .train_parallel import (
    ParallelTrainState,
    create_sharded_train_state,
    make_parallel_eval_step,
    make_parallel_multi_step,
    make_parallel_train_step,
    parallel_train_epoch,
)

__all__ = [
    "global_batch",
    "host_batch_slice",
    "initialize_multihost",
    "is_coordinator",
    "make_mesh",
    "make_param_specs",
    "shard_pytree",
    "batch_spec",
    "make_parallel_train_step",
    "make_parallel_multi_step",
    "create_sharded_train_state",
    "parallel_train_epoch",
    "seq_parallel_linear_attention",
    "ring_kerple_attention",
    "ring_softmax_attention",
    "Mesh",
    "Spec",
    "ParallelTrainState",
    "make_mesh_from_spec",
    "make_parallel_eval_step",
    "shard_model",
]
