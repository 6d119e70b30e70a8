"""The port's ensemble over a mesh against the JAX package's, on the CPU.

`make_ensemble_train_step(models, mesh=mesh, member_axis="data")` shards S
members over the mesh's 'data' axis (the JAX step's `mesh=`): rank r
holds members r * S / P .. (r + 1) * S / P - 1, runs their steps with no
collective, and one all-gather gives every rank the whole ensemble's
losses and corrects. Here S = 4 members of `performer_favor_most_general`
and `baseline` at mnist_config(depth=1, dropout=0.0), fp32, in one 2-rank
gloo world (`tests/torch_parallel_worker.py`), start from the JAX members'
flax weights and take one step on a shared batch; the JAX side is
`make_ensemble_train_step(mesh=)` on a 2-device CPU mesh. Losses match at
1e-5, corrects exactly, every parameter within atol 1e-5 (the tolerances
of `tests/test_torch_ensemble.py`). Each rank's members are bit for bit
the same members of the single-process ensemble, the step makes exactly
one collective (the all-gather of its results), and 3 members on 2 ranks
are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from efficient_rpe_vit_tpu.train import training as jax_training
from efficient_rpe_vit_torch.utils import flax_to_state_dict

import torch_parallel_worker as worker
from torch_parallel_jax import jax_mesh, np_tree
from efficient_rpe_vit_tpu.configs import mnist_config as jax_mnist_config
from efficient_rpe_vit_tpu.models import create_model as jax_create_model

S = 4
KERPLE = "performer_favor_most_general"
NAMES = [KERPLE, "baseline"]
TOL = 1e-5


def _batch():
    rng = np.random.default_rng(1)
    return (rng.normal(size=(8, 28, 28, 1)).astype(np.float32),
            (np.arange(8) % 10).astype(np.int64))


def _jax(name):
    """The JAX members' flax variables, and the sharded JAX step's losses,
    corrects and members' parameters after it."""
    cfg = jax_mnist_config(dropout=0.0, depth=1)
    model = jax_create_model(name, cfg, **({"rpe_config": {"method": "dense"}}
                                           if name == KERPLE else {}))
    rngs = [jax.random.fold_in(jax.random.PRNGKey(0), i) for i in range(S)]
    ens = jax_training.create_ensemble_train_state(model, cfg, rngs, jnp.zeros((2, 28, 28, 1)),
                                                   steps_per_epoch=10)
    members = []
    for i in range(S):
        m = jax_training.ensemble_member(ens, i)
        members.append((np_tree(m.params), np_tree(m.constants)))
    x, y = _batch()
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), 100 + i) for i in range(S)])
    step = jax_training.make_ensemble_train_step(model, mesh=jax_mesh((2,), ("data",)))
    ens, losses, corrects = step(ens, jnp.asarray(x), jnp.asarray(y), keys)
    after = [{n: np.asarray(t) for n, t in flax_to_state_dict(
        np_tree(jax_training.ensemble_member(ens, i).params)).items()} for i in range(S)]
    return members, np.asarray(losses), np.asarray(corrects), after


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    x, y = _batch()
    jax_side = {name: _jax(name) for name in NAMES}
    cases = [(name, "ensemble_mesh", dict(name=name, members=jax_side[name][0], x=x, y=y,
                                          n_members=S)) for name in NAMES]
    cases.append(("refusals", "ensemble_mesh_refusals", {}))
    world = worker.run_world(2, cases, tmp_path_factory.mktemp("ensemble_mesh"))
    return jax_side, world


def _ok(result):
    assert "error" not in result, result.get("error")
    return result


@pytest.mark.parametrize("name", NAMES)
def test_ensemble_over_a_mesh_matches_jax(runs, name):
    jax_side, world = runs
    _, jlosses, jcorrects, jafter = jax_side[name]
    for rank, result in enumerate(world[name]):
        _ok(result)
        np.testing.assert_allclose(result["losses"], jlosses, atol=TOL, rtol=0)
        np.testing.assert_array_equal(result["corrects"], jcorrects)
        for j, i in enumerate(result["mine"]):
            for n, got in result["params"][j].items():
                np.testing.assert_allclose(got, jafter[i][n], atol=TOL, rtol=0,
                                           err_msg=f"rank {rank} member {i} {n}")


@pytest.mark.parametrize("name", NAMES)
def test_mesh_members_are_the_single_process_members(runs, name):
    """Rank r's members are members 2r, 2r + 1 of the single-process
    ensemble, bit for bit, and every rank returns the whole ensemble's
    losses and corrects in member order, those of the single process."""
    _, world = runs
    assert [r["mine"] for r in world[name]] == [[0, 1], [2, 3]]
    for result in world[name]:
        assert _ok(result)["bitwise_single"]
        np.testing.assert_array_equal(result["losses"], result["single_losses"])
        np.testing.assert_array_equal(result["corrects"], result["single_corrects"])
        assert result["dtypes"] == ("torch.float32", "torch.int64")


def test_mesh_step_makes_one_collective(runs):
    """The members' steps make no collective call: the one all-gather of the
    losses and corrects after them is all the step sends."""
    _, world = runs
    for name in NAMES:
        for result in world[name]:
            assert result["collectives"] == {"all_gather_into_tensor": 1}, result["collectives"]


def test_members_that_do_not_divide_are_refused(runs):
    _, world = runs
    for result in world["refusals"]:
        assert "3 ensemble members do not divide over the 'data' axis of 2 ranks" in \
            _ok(result)["members"]
