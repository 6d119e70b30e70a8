"""The port's GPipe pipeline against the JAX package's sequential model, on
the CPU.

Four gloo ranks (`tests/torch_parallel_worker.py`) run pipe=4 over a
depth-4 model at mnist_config widths, carrying the flax variables of the
JAX model they are held to. The forward of each of the four variants of
JAX's own pipeline test, at M = 4 and 8, and of a soft-MoE model is held
to the JAX sequential `model.apply` at JAX's tolerance (rtol = atol =
2e-5, tests/test_pipeline.py:57). The gradients of sum(logits ** 2),
every parameter's, the embedding's and the head's included, are held to
`jax.grad` of the sequential model (JAX's 5e-4 / 5e-5). On a data=4,
pipe=1 mesh each data rank runs its rows of the microbatch and the
gathered logits are the port's own forward's. Then the bad
shapes' refusals, dropout (two runs from one seed are bitwise equal, the
loss falls over five steps, and two microbatches share each block's
draw) and a pipe run's checkpoint, which loads into the single-process
model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_rpe_vit_tpu.configs import mnist_config as jax_mnist_config
from efficient_rpe_vit_tpu.models import create_model as jax_create_model
from efficient_rpe_vit_torch.utils.import_flax import flax_to_state_dict

import torch_parallel_worker as worker
from torch_parallel_jax import np_tree, ok

DEPTH = 4
BATCH = 8
FWD_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
VARIANTS = ["baseline", "baseline_rope", "performer_relu_circulant",
            "performer_favor_most_general"]
MICROBATCHES = [4, 8]
FLAGSHIP = "performer_favor_most_general"


def _jax_model(name, moe=None):
    cfg = jax_mnist_config(dropout=0.0, depth=DEPTH)
    return jax_create_model(name, cfg, mlp_config=(
        {"mlp_type": "moe", "num_experts": moe} if moe else None))


def _variables(variables):
    return (np_tree(variables["params"]),
            np_tree(variables["constants"]) if "constants" in variables else None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX sequential forwards and gradients, then one 4-rank world."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (BATCH, 28, 28, 1)))
    jax_out, cases = {}, []
    for name, moe in [(v, None) for v in VARIANTS] + [("performer_favor", 2)]:
        model = _jax_model(name, moe)
        variables = model.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                               deterministic=True)
        want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, deterministic=True))(
            variables, x))
        label = name if moe is None else f"{name}_moe{moe}"
        jax_out[label] = want
        for m in (MICROBATCHES if moe is None else [4]):
            grads = name == FLAGSHIP and m == 4
            cases.append((f"{label}_m{m}", "pipe_forward", dict(
                spec="pipe=4", name=name, x=x, variables=_variables(variables), depth=DEPTH,
                microbatches=m, grads=grads, moe=moe)))
        if name == FLAGSHIP:
            consts = {k: v for k, v in variables.items() if k != "params"}

            def loss(p):
                return jnp.sum(model.apply({**consts, "params": p}, x, deterministic=True) ** 2)

            g = jax.jit(jax.grad(loss))(variables["params"])
            jax_out["grads"] = {n: t.numpy() for n, t in
                                flax_to_state_dict(np_tree(g)).items()}
            cases.append(("ends", "pipe_forward", dict(
                spec="data=4,pipe=1", name=name, x=x, variables=_variables(variables),
                depth=DEPTH, microbatches=1)))
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(1, BATCH, 28, 28, 1)).astype(np.float32)
    ys = (np.arange(BATCH) % 10).astype(np.int64)[None]
    for run in ("a", "b"):
        cases.append((f"dropout_{run}", "pipe_step", dict(
            spec="pipe=4", name=FLAGSHIP, x=xs, y=ys, depth=DEPTH, steps=5, gen_seed=7,
            dropout=0.1)))
    twice = np.concatenate([xs[0, :BATCH // 2]] * 2)
    cases.append(("shared_masks", "pipe_shared_masks", dict(
        spec="data=2,pipe=2", name=FLAGSHIP, x=twice, depth=DEPTH)))
    ckpt = tmp_path_factory.mktemp("ckpt") / "pipe.pt"
    cases += [("refusals", "pipe_refusals", dict(name=FLAGSHIP)),
              ("checkpoint", "pipe_checkpoint", dict(spec="pipe=4", name=FLAGSHIP,
                                                     path=str(ckpt), x=xs[0], y=ys[0],
                                                     depth=DEPTH))]
    port = worker.run_world(4, cases, tmp_path_factory.mktemp("world4"))
    return jax_out, port, (ckpt, xs, ys)


@pytest.mark.parametrize("microbatches", MICROBATCHES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_pipeline_matches_jax_sequential(runs, variant, microbatches):
    jax_out, port, _ = runs
    ranks = [ok(r) for r in port[f"{variant}_m{microbatches}"]]
    assert [r["stage"] for r in ranks] == [(s, s + 1) for s in range(4)]
    for r in ranks:  # every pipe rank returns the whole batch's logits
        np.testing.assert_allclose(r["logits"], jax_out[variant], rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_array_equal(r["logits"], ranks[0]["logits"])


def test_pipeline_moe_matches_jax_sequential(runs):
    jax_out, port, _ = runs
    for r in port["performer_favor_moe2_m4"]:
        np.testing.assert_allclose(ok(r)["logits"], jax_out["performer_favor_moe2"],
                                   rtol=FWD_TOL, atol=FWD_TOL)


def test_pipeline_gradients_match_jax_grad(runs):
    """Each stage holds its blocks' gradients; the embedding's (stage 0's,
    summed over the pipe group) and the head's (the one loss's, not 4x)
    are the same on every rank and equal jax.grad's."""
    jax_out, port, _ = runs
    ranks = [ok(r) for r in port[f"{FLAGSHIP}_m4"]]
    got = {}
    for s, r in enumerate(ranks):
        for name, g in r["grads"].items():
            if name.startswith("transformer_blocks."):
                assert name.startswith(f"transformer_blocks.{s}."), name
            elif name in got:
                np.testing.assert_array_equal(g, got[name], err_msg=name)
            got.setdefault(name, g)
    want = jax_out["grads"]
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
    assert np.abs(want["mlp_head.1.weight"]).max() > 1e-3  # the head's is not trivial
    assert np.abs(want["patch_embedding.weight"]).max() > 1e-6


def test_embed_and_head_are_the_models(runs):
    """A data=4, pipe=1 mesh: the model's ends (`ViT.embed`, `ViT.head`)
    around the pipelined blocks give the sequential forward's logits, each
    data rank running two rows and the logits gathered over 'data'."""
    _, port, _ = runs
    for r in port["ends"]:
        r = ok(r)
        np.testing.assert_allclose(r["logits"], r["sequential"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("key,match", [
    ("depth", "ValueError: depth 5 not divisible by 4 stages"),
    ("batch", "ValueError: batch 5 not divisible by 4 microbatches"),
    ("accum", "ValueError: batch 8 not divisible by grad_accum 3"),
    ("unstaged", "ValueError: the model is not staged"),
    ("remote", "RuntimeError: transformer block"),
    ("no_pipe", "ValueError: the mesh {'data': 4} has no 'pipe' axis"),
    ("seq", "ValueError: a 'pipe' axis does not compose with a 'seq' axis"),
])
def test_pipeline_refusals(runs, key, match):
    _, port, _ = runs
    for r in port["refusals"]:
        assert ok(r)[key] is not None and ok(r)[key].startswith(match), r[key]


def test_dropout_runs_repeat_and_the_loss_falls(runs):
    """At dropout 0.1 (one draw per block, shared by the microbatches),
    two runs from one generator seed are bitwise equal, and the loss on
    one batch falls over five steps, as JAX's test_pipeline_train_step
    asserts."""
    _, port, _ = runs
    a = [ok(r) for r in port["dropout_a"]]
    b = [ok(r) for r in port["dropout_b"]]
    assert a[0]["loss"] == b[0]["loss"]
    for name, t in a[0]["params"].items():
        np.testing.assert_array_equal(t, b[0]["params"][name], err_msg=name)
    losses = a[0]["loss"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert all(r["loss"] == losses for r in a)  # the global loss on every rank


def test_microbatches_share_each_blocks_dropout_draw(runs):
    """The JAX rule (one draw per block, shared by the microbatches): a
    batch whose two microbatches hold the same images gives the two the
    same train-mode logits, on a data=2, pipe=2 mesh, while dropout is on
    (they differ from the eval-mode logits)."""
    _, port, _ = runs
    for r in port["shared_masks"]:
        r = ok(r)
        half = BATCH // 2
        np.testing.assert_array_equal(r["train"][:half], r["train"][half:])
        assert np.abs(r["train"] - r["eval"]).max() > 1e-4


def test_pipe_checkpoint_loads_into_one_process(runs):
    """The checkpoint of a pipe=4 run is the whole model: it loads into the
    single-process model and the predict side unchanged, and back into a
    fresh pipe run, which then steps as the run that saved it."""
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.train import create_train_state, load_checkpoint

    _, port, (ckpt, _, _) = runs
    r = ok(port["checkpoint"][0])
    model = create_model(FLAGSHIP, mnist_config(dropout=0.0, depth=DEPTH), device="cpu")
    state = create_train_state(model, mnist_config(dropout=0.0, depth=DEPTH), ema_decay=0.9)
    state, meta = load_checkpoint(str(ckpt), state)
    assert meta["epoch"] == 1 and state.step == 1
    for name, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), r["saved"][name], err_msg=name)
    moments = [s["exp_avg"] for s in state.optimizer.state.values()]
    assert len(moments) == len(list(model.parameters()))
    assert all(torch.any(m != 0) for m in moments)
    assert r["resumed"]["step"] == r["continued"]["step"] == 2
    assert r["resumed"]["loss"] == r["continued"]["loss"]
    for name, t in r["continued"]["params"].items():
        np.testing.assert_array_equal(r["resumed"]["params"][name], t, err_msg=name)
