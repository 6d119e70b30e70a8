"""Feature redraw inside the K-step CUDA-graph programs: the host logic,
on the CPU.

On the GPU `make_multi_step`, `make_gather_multi_step`, the ensemble
programs and `make_parallel_multi_step` capture K steps of a model that
redraws Omega: the host reads the redraw counters once a call
(`training._HostCounts`), keys the graph by each count modulo its
interval, and runs the body (the same Python the graph captures) with
each attention module's `host_count` set, so that no call reads the card
and the graph holds the QR draws of the steps that redraw. Here that body
runs eagerly on the CPU, K = 4 steps of `performer_favor` at
mnist_config(dropout=0.0) with interval 2 and 3, from counters 0 and 1:

  * the steps that redraw are the JAX package's: each step of the JAX
    train step (the counter oracle of `tests/test_training.py::
    test_multi_step_threads_redraw_state`) redraws where its Omega
    changes, and after K steps the JAX multi-step's counters equal the
    port's;
  * the body equals the same K steps run deciding each redraw by reading
    the counter, bit for bit: parameters, Adam moments, Omega, counters
    and the generator's state after the call (on the card chip_smoke.py
    holds the replays to eager `make_train_step` calls).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_rpe_vit_tpu.configs import mnist_config as jax_mnist_config
from efficient_rpe_vit_tpu.models import create_model as jax_create_model
from efficient_rpe_vit_tpu.train import training as jax_training
from efficient_rpe_vit_torch.configs import mnist_config
from efficient_rpe_vit_torch.models import create_model
from efficient_rpe_vit_torch.train import create_train_state, make_train_step
from efficient_rpe_vit_torch.train import training as port_training
from efficient_rpe_vit_torch.utils import load_flax_variables

torch.set_num_threads(2)

K = 4
NAME = "performer_favor"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(steps):
    rng = np.random.default_rng(5)
    return (rng.normal(size=(steps, 4, 28, 28, 1)).astype(np.float32),
            rng.integers(0, 10, (steps, 4)).astype(np.int64))


def _jax_positions(interval, start):
    """The steps among `start` .. `start + K - 1` in which the JAX train
    step redraws Omega, the JAX multi-step's counters after the K steps,
    and the flax variables the run started from."""
    cfg = jax_mnist_config(dropout=0.0)
    model = jax_create_model(NAME, cfg, attention_config={"feature_redraw_interval": interval})
    state = jax_training.create_train_state(model, cfg, jax.random.PRNGKey(0),
                                            jnp.zeros((2, 28, 28, 1)), steps_per_epoch=10)
    variables = (_np_tree(state.params), _np_tree(state.constants),
                 _np_tree(state.mutable_state))
    xs, ys = _data(start + K)
    step = jax_training.make_train_step(model)
    positions = []
    for i in range(start + K):
        if i == start:
            multi_from = state
        new, _, _ = step(state, jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                         jax.random.PRNGKey(i))
        before = np.asarray(jax.tree_util.tree_leaves(state.constants)[0])
        after = np.asarray(jax.tree_util.tree_leaves(new.constants)[0])
        if i >= start and not np.array_equal(before, after):
            positions.append(i - start)
        state = new
    multi, _, _ = jax_training.make_multi_step(model, donate=False)(
        multi_from, jnp.asarray(xs[start:]), jnp.asarray(ys[start:]), jax.random.PRNGKey(9))
    counters = [int(c) for c in jax.tree_util.tree_leaves(multi.mutable_state)]
    return positions, counters, variables


def _port(interval, variables):
    cfg = mnist_config(dropout=0.0)
    model = create_model(NAME, cfg, attention_config={"feature_redraw_interval": interval},
                         device="cpu")
    load_flax_variables(model, *variables)
    return model, create_train_state(model, cfg, steps_per_epoch=10)


@pytest.mark.parametrize("start", [0, 1])
@pytest.mark.parametrize("interval", [2, 3])
def test_host_counts_redraw_where_jax_does(interval, start):
    jpositions, jcounters, variables = _jax_positions(interval, start)
    xs, ys = (torch.from_numpy(a) for a in _data(start + K))
    graphed_model, graphed = _port(interval, variables)
    eager_model, eager = _port(interval, variables)
    step = make_train_step(graphed_model, device="cpu")
    eager_step = make_train_step(eager_model, device="cpu")
    gen, eager_gen = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    for i in range(start):
        step(graphed, xs[i], ys[i], gen)
        eager_step(eager, xs[i], ys[i], eager_gen)

    host = port_training._HostCounts([graphed_model])
    counts = host.read()
    assert counts == (start,) * len(graphed_model.transformer_blocks)
    assert host.key(counts) == (start % interval,) * len(counts)
    redrawn = []
    for block in graphed_model.transformer_blocks:
        attn = block.attention
        own = attn.draw_omega

        def spy(generator, attn=attn, own=own):
            if attn is graphed_model.transformer_blocks[0].attention:
                redrawn.append(attn.host_count - 1 - start)
            return own(generator)

        attn.draw_omega = spy
    body = port_training._k_step_body(port_training._step_body(graphed_model, 1, 0.0),
                                      graphed, K)
    def lrs():  # each run its own table: a CPU optimiser keeps the tensor it is given
        return torch.from_numpy(port_training._lr_table(graphed.schedule, graphed.step, K))

    host.wrap(body, counts)(xs[start:], ys[start:], lrs(), gen)
    assert all(b.attention.host_count is None for b in graphed_model.transformer_blocks)
    assert redrawn == jpositions == [i for i in range(K) if (start + i) % interval == 0]
    assert list(host.read()) == jcounters == [start + K] * len(counts)

    # the same K steps deciding each redraw by reading the counter
    port_training._k_step_body(port_training._step_body(eager_model, 1, 0.0), eager, K)(
        xs[start:], ys[start:], lrs(), eager_gen)
    sd = eager_model.state_dict()
    for name, t in graphed_model.state_dict().items():
        assert torch.equal(t, sd[name]), name
    for p, q in zip(graphed_model.parameters(), eager_model.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(graphed.optimizer.state[p][key],
                               eager.optimizer.state[q][key]), key
    assert torch.equal(gen.get_state(), eager_gen.get_state())
