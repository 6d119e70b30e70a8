"""JAX side of the port's parallel tests: the JAX package's sharded step
on a mesh of the simulated CPU devices, and the shared batch and
tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as JaxMesh

from efficient_rpe_vit_tpu.configs import mnist_config as jax_mnist_config
from efficient_rpe_vit_tpu.models import create_model as jax_create_model
from efficient_rpe_vit_tpu.parallel import (
    create_sharded_train_state as jax_sharded_state,
    make_parallel_train_step as jax_parallel_step,
)
from efficient_rpe_vit_torch.utils.import_flax import flax_to_state_dict

DEPTH = 1
BATCH = 8
PARAM_ATOL = 1e-5
LOSS_ATOL = 1e-5


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def batch(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, BATCH, 28, 28, 1)).astype(np.float32)
    y = (np.arange(BATCH) % 10).astype(np.int64)[None]
    return x, y


def jax_mesh(shape, names):
    n = int(np.prod(shape))
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def jax_step(shape, names, name, fsdp=False, moe=None, seq=False):
    """One JAX sharded step: (the flax variables it started from, loss,
    correct, the params after it as a port state dict)."""
    mesh = jax_mesh(shape, names)
    cfg = jax_mnist_config(dropout=0.0, depth=DEPTH)
    mlp = None
    if moe:
        mlp = {"mlp_type": "moe", "num_experts": moe}
        if "expert" in names:
            mlp.update(expert_mesh=mesh, expert_axis="expert")
    model = jax_create_model(name, cfg, mlp_config=mlp,
                             rpe_config={"method": "dense"} if "most_general" in name else None,
                             attention_config=({"seq_mesh": mesh, "seq_axis": "seq"}
                                               if seq else None))
    state, specs = jax_sharded_state(model, cfg, jax.random.PRNGKey(0),
                                     jnp.zeros((2, 28, 28, 1)), mesh, steps_per_epoch=10,
                                     fsdp=fsdp)
    variables = (np_tree(state.params), np_tree(state.constants)
                 if state.constants is not None else None)
    x, y = batch()
    new, loss, correct = jax_parallel_step(model, mesh, specs, donate=False)(
        state, jnp.asarray(x[0]), jnp.asarray(y[0]), jax.random.PRNGKey(5))
    after = {n: t.numpy() for n, t in flax_to_state_dict(np_tree(new.params)).items()}
    return variables, float(loss), int(correct), after



def jax_pipeline_step(shape, names, name, depth, microbatches=None, grad_accum=1, batch_size=8):
    """One JAX GPipe step (`make_pipeline_train_step`) from a fresh state:
    (the flax variables it started from, loss, correct, the params after it
    as a port state dict). A mesh with a 'model' axis keeps the state
    sharded by its specs, as the JAX package's DP x PP x TP test does."""
    from efficient_rpe_vit_tpu.parallel.pipeline import make_pipeline_train_step
    from efficient_rpe_vit_tpu.train import create_train_state

    mesh = jax_mesh(shape, names)
    cfg = jax_mnist_config(dropout=0.0, depth=depth)
    model = jax_create_model(name, cfg, rpe_config={"method": "dense"}
                             if "most_general" in name else None)
    sample = jnp.zeros((2, 28, 28, 1))
    specs = None
    if "model" in names:
        state, specs = jax_sharded_state(model, cfg, jax.random.PRNGKey(0), sample, mesh,
                                         steps_per_epoch=10)
    else:
        state = create_train_state(model, cfg, jax.random.PRNGKey(0), sample,
                                   steps_per_epoch=10)
    variables = (np_tree(state.params), np_tree(state.constants)
                 if state.constants is not None else None)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(batch_size, 28, 28, 1)).astype(np.float32)
    y = (np.arange(batch_size) % 10).astype(np.int64)
    step = make_pipeline_train_step(model, mesh, n_microbatches=microbatches,
                                    state_specs=specs, grad_accum=grad_accum)
    new, loss, correct = step(state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(5))
    after = {n: t.numpy() for n, t in flax_to_state_dict(np_tree(new.params)).items()}
    return variables, x, y, float(loss), int(correct), after


def ok(result):
    assert "error" not in result, result.get("error")
    return result
