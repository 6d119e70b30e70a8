"""The port's sharded train steps against the JAX package's, on the CPU.

The port's ranks are gloo processes (`tests/torch_parallel_worker.py`, a
few worlds per file); the JAX package runs the same mesh on as many of
the 8 simulated CPU devices (`tests/conftest.py`). Both start from the
flax variables of the JAX sharded state (the port's ranks load them and
keep their parts), at mnist_config widths, depth 1, dropout 0, and take
one step on the same global batch: the loss to 1e-5, the correct count
exactly, and every parameter after the step to atol 1e-5 (the JAX
package's own DP-vs-single-device tolerance, tests/test_parallel.py:108),
for DP, TP (three variants), FSDP, DP x TP, DP x TP with FSDP and expert
parallelism (the context-parallel steps are in test_torch_seq_parallel.py).
`make_param_specs`' rules on the port's names are held to the JAX rules
on the flax names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from efficient_rpe_vit_tpu.configs import mnist_config as jax_mnist_config
from efficient_rpe_vit_tpu.models import create_model as jax_create_model
from efficient_rpe_vit_tpu.parallel import make_param_specs as jax_param_specs
from efficient_rpe_vit_torch.utils.import_flax import flax_to_state_dict

import torch_parallel_worker as worker
from torch_parallel_jax import DEPTH, LOSS_ATOL, PARAM_ATOL, batch, jax_mesh, jax_step, ok

# (case, world size, port mesh, JAX mesh shape, JAX axis names, variant, options)
STEPS = [
    ("dp", 2, "data=2", (2, 1), ("data", "model"), "performer_favor_most_general", {}),
    ("tp_kerple", 2, "model=2", (1, 2), ("data", "model"), "performer_favor_most_general", {}),
    ("tp_baseline", 2, "model=2", (1, 2), ("data", "model"), "baseline", {}),
    ("tp_circulant", 2, "model=2", (1, 2), ("data", "model"), "performer_relu_circulant", {}),
    ("fsdp", 2, "data=2", (2, 1), ("data", "model"), "baseline", {"fsdp": True}),
    ("ep", 2, "data=1,expert=2", (1, 2), ("data", "expert"), "performer_favor",
     {"moe": 4}),
    ("dp_tp", 4, "data=2,model=2", (2, 2), ("data", "model"),
     "performer_favor_most_general", {}),
    ("dp_tp_fsdp", 4, "data=2,model=2", (2, 2), ("data", "model"), "performer_favor",
     {"fsdp": True}),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every JAX step, then the port's worlds of 2, 4 and 8 ranks."""
    x, y = batch()
    jax_out, cases = {}, {}
    for case, world, spec, shape, names, variant, opts in STEPS:
        variables, *jax_out[case] = jax_step(shape, names, variant, **opts)
        cases.setdefault(world, []).append(
            (case, "step", dict(spec=spec, name=variant, x=x, y=y, variables=variables,
                                depth=DEPTH, **opts)))
    cases[2] += [("specs_tp", "specs", dict(spec="model=2", name="performer_favor_most_general")),
                 ("specs_fsdp", "specs", dict(spec="data=2", name="baseline")),
                 ("specs_ep", "specs", dict(spec="data=1,expert=2", name="performer_favor",
                                            moe=4))]
    port = {}
    for world, todo in sorted(cases.items()):
        port.update(worker.run_world(world, todo, tmp_path_factory.mktemp(f"world{world}")))
    return jax_out, port


@pytest.mark.parametrize("case", [c[0] for c in STEPS])
def test_sharded_step_matches_jax(runs, case):
    jax_out, port = runs
    loss, correct, after = jax_out[case]
    ranks = [ok(r) for r in port[case]]
    for r in ranks:  # every rank returns the global batch's numbers
        assert abs(r["loss"][0] - loss) < LOSS_ATOL, (r["loss"], loss)
        assert r["correct"][0] == correct
    got = ranks[0]["params"]
    for name, want in after.items():
        np.testing.assert_allclose(got[name], want, atol=PARAM_ATOL, rtol=0, err_msg=name)
    # every rank assembles the same whole model
    for r in ranks[1:]:
        for name in after:
            np.testing.assert_array_equal(r["params"][name], got[name], err_msg=name)


def _jax_specs(name, n_model=2, fsdp=False, moe=None):
    cfg = jax_mnist_config(depth=DEPTH)
    model = jax_create_model(name, cfg, mlp_config=(
        {"mlp_type": "moe", "num_experts": moe} if moe else None))
    params = model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 28, 28, 1)))["params"]
    mesh = jax_mesh((2 // n_model, n_model), ("data", "model"))
    return params, jax_param_specs(params, mesh, fsdp_axis="data" if fsdp else None)


def _flax_name(path):
    return "/".join(str(getattr(p, "key", p)) for p in path)


def _sd_name(params, path):
    """The port's state-dict name of the flax leaf at `path`: the one
    tensor of flax_to_state_dict that carries a mark put on that leaf."""
    marked = jax.tree_util.tree_map_with_path(
        lambda p, v: np.full(np.shape(v), 7.0 if p == path else 0.0, np.float32), params)
    names = [n for n, t in flax_to_state_dict(marked).items() if bool((t == 7.0).all())]
    assert len(names) == 1, (path, names)
    return names[0]


def test_tp_rules_match_jax(runs):
    _, port = runs
    specs = ok(port["specs_tp"][0])["specs"]
    params, jspecs = _jax_specs("performer_favor_most_general")
    flat = jax.tree_util.tree_leaves_with_path(
        jspecs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert len(flat) == len(jax.tree_util.tree_leaves(params))
    for path, jspec in flat:
        flax = _flax_name(path)
        dims, blocks, _ = specs[_sd_name(params, path)]
        split = tuple(jspec)
        if flax.endswith("kernel"):  # flax kernels are [in, out], torch weights [out, in]
            split = (tuple(split) + (None,) * (2 - len(split)))[::-1]
        want = tuple(split) + (None,) * (len(dims) - len(split))
        assert tuple(dims) == want or (not any(want) and dims == ()), (flax, dims, jspec)
        assert blocks == (3 if "qkv" in flax and any(want) else 1), flax
    # the head-structured Omega (a JAX constant) splits with its heads; the
    # projections' biases are added once, after the sum
    assert specs["transformer_blocks.0.attention.omega"][0] == ("model", None, None)
    assert specs["transformer_blocks.0.attention.proj.bias"][0] == ()
    assert specs["transformer_blocks.0.mlp.3.bias"][0] == ()


def test_fsdp_and_expert_rules(runs):
    _, port = runs
    fsdp = ok(port["specs_fsdp"][0])["specs"]
    for name, (dims, _, axis) in fsdp.items():
        assert axis == ("data" if not name.endswith("omega") else None), name
        assert dims == (), name
    ep = ok(port["specs_ep"][0])["specs"]
    for name, (dims, _, _) in ep.items():
        if name.rsplit(".", 1)[-1] in ("w1", "b1", "w2", "b2"):
            assert dims[0] == "expert", name
        else:
            assert dims == (), name


def test_shard_pytree_keeps_what_shard_model_keeps(runs):
    """`shard_pytree` of the whole state dict by `make_param_specs` gives each
    rank what `shard_model` leaves it (TP: the qkv blocks' heads, Omega's
    heads, the MLP units), and `batch_spec` splits the batch over 'data'."""
    from efficient_rpe_vit_torch.parallel import Spec, batch_spec

    _, port = runs
    for rank in ok_all(port["specs_tp"]):
        assert rank["shard_pytree"]
    assert batch_spec() == Spec(("data",)) and batch_spec().axis == "data"


def ok_all(results):
    return [ok(r) for r in results]
