"""The port's ensemble engine against the JAX package's, on the CPU.

The JAX engine stacks S members' train states and vmaps one member's
program over them (`create_ensemble_train_state`, `make_ensemble_*`); the
port keeps S models, each with its own optimiser and generator, and runs
each member's own steps (on the GPU all of them in one CUDA graph, which
chip_smoke.py holds against sequential runs). Here S = 3 members of
`performer_favor_most_general` and `baseline` at mnist_config(dropout=0.0),
fp32, start from the JAX members' flax weights (`load_flax_variables`;
KERPLE on its dense arm in JAX): after one ensemble step on a shared batch
losses match at 1e-5, corrects exactly and every parameter within atol
1e-5 (the JAX `test_ensemble_step_matches_independent_members` is the
oracle); after K = 2 gather-fused steps with each member's own order the
losses and corrects as well, and the parameters by the engine tests' rule
for trajectories (`_assert_members_near_jax`).
Within the port, each member equals its own standalone run bit for bit, at
dropout 0.1 too (the same model, generator and order), and a train state
reset in place (`reset_train_state`, the benchmark's `shared` reuse)
equals a fresh one bit for bit.
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
from efficient_rpe_vit_torch.data import DeviceDataset
from efficient_rpe_vit_torch.models import create_model
from efficient_rpe_vit_torch.train import (
    create_ensemble_train_state,
    create_train_state,
    ensemble_evaluate,
    ensemble_member,
    ensemble_train_epoch,
    evaluate,
    make_ensemble_gather_multi_eval,
    make_ensemble_gather_multi_step,
    make_ensemble_train_step,
    make_eval_step,
    make_gather_multi_eval,
    make_gather_multi_step,
    make_train_step,
    reset_train_state,
    train_epoch,
)
from efficient_rpe_vit_torch.utils import flax_to_state_dict, load_flax_variables

torch.set_num_threads(2)

S = 3
KERPLE = "performer_favor_most_general"
NAMES = [KERPLE, "baseline"]
TOL = 1e-5
PARAM_REL_TOL = 2e-3  # tests/test_torch_engine.py's
MEAN, STD = (0.1307,), (0.3081,)


def _np_tree(tree):
    return None if tree is None else jax.tree_util.tree_map(np.asarray, tree)


def _jax_model(name):
    cfg = jax_mnist_config(dropout=0.0)
    rpe = {"rpe_config": {"method": "dense"}} if name == KERPLE else {}
    return jax_create_model(name, cfg, **rpe), cfg


def _ensembles(name, steps_per_epoch=4):
    """(jax model, jax ensemble state, port ensemble state holding the JAX
    members' weights)."""
    jmodel, jcfg = _jax_model(name)
    rngs = [jax.random.fold_in(jax.random.PRNGKey(0), i) for i in range(S)]
    jens = jax_training.create_ensemble_train_state(
        jmodel, jcfg, rngs, jnp.zeros((2, 28, 28, 1)), steps_per_epoch=steps_per_epoch)
    cfg = mnist_config(dropout=0.0)
    models = []
    for i in range(S):
        member = jax_training.ensemble_member(jens, i)
        models.append(load_flax_variables(create_model(name, cfg, device="cpu"),
                                          _np_tree(member.params), _np_tree(member.constants),
                                          _np_tree(member.mutable_state)))
    return jmodel, jens, create_ensemble_train_state(models, cfg, steps_per_epoch=steps_per_epoch)


def _jax_params(jens, i):
    return flax_to_state_dict(_np_tree(jax_training.ensemble_member(jens, i).params))


def _assert_members_near_jax(state, jens, start=None):
    """Every parameter within atol TOL of the JAX member's; with `start`
    (the members' parameters before the steps), each tensor's distance
    from the JAX one at most PARAM_REL_TOL of how far the JAX tensor moved,
    the engine tests' rule for trajectories: from the second Adam update on
    an element whose gradient is near Adam's eps moves by a different
    fraction of its step in each framework."""
    for i, member in enumerate(state.members):
        want = _jax_params(jens, i)
        for n, p in member.model.named_parameters():
            got = p.detach().numpy()
            if start is None:
                np.testing.assert_allclose(got, want[n].numpy(), atol=TOL, rtol=0,
                                           err_msg=f"member {i} {n}")
                continue
            moved = np.linalg.norm(want[n].numpy() - start[i][n].numpy())
            diff = np.linalg.norm(got - want[n].numpy())
            assert moved > 0 and diff <= PARAM_REL_TOL * moved, (i, n, diff, moved)


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 28, 28, 1), dtype=np.uint8),
            rng.integers(0, 10, n).astype(np.int32))


def _dataset(n, batch, seed=0, shuffle=False, augment=None, data_seed=0):
    images, labels = _images(n, data_seed)
    return DeviceDataset(images, labels, MEAN, STD, batch, shuffle=shuffle,
                         drop_last=shuffle, augment=augment, seed=seed, device="cpu")


# ─── the port against the JAX engine ────────────────────────────────────

@pytest.mark.parametrize("name", NAMES)
def test_ensemble_step_matches_jax(name):
    jmodel, jens, state = _ensembles(name)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 28, 28, 1)).astype(np.float32)
    y = (np.arange(8) % 10).astype(np.int32)
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), 100 + i) for i in range(S)])
    jens, jlosses, jcorrects = jax_training.make_ensemble_train_step(jmodel)(
        jens, jnp.asarray(x), jnp.asarray(y), keys)
    step = make_ensemble_train_step([m.model for m in state.members], device="cpu")
    state, losses, corrects = step(state, torch.from_numpy(x), torch.from_numpy(y),
                                   [torch.Generator() for _ in range(S)])
    assert losses.shape == corrects.shape == (S,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(corrects.numpy(), np.asarray(jcorrects))
    assert [m.step for m in state.members] == [1] * S
    _assert_members_near_jax(state, jens)


def test_ensemble_gather_steps_and_evaluate_match_jax():
    """K = 2 gather-fused steps, each member on its own rows; then the
    ensemble evaluation equals JAX's, and each member's own evaluate."""
    jmodel, jens, state = _ensembles(KERPLE)
    start = [_jax_params(jens, i) for i in range(S)]
    K, B = 2, 8
    ds = _dataset(3 * K * B, B)
    idx = np.stack([np.random.default_rng(i).permutation(ds.n)[:K * B].reshape(K, B)
                    for i in range(S)]).astype(np.int32)
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), 100 + i) for i in range(S)])
    jimages, jlabels = jnp.asarray(ds.images.numpy()), jnp.asarray(ds.labels.numpy())
    jmean, jstd = jnp.asarray(ds.mean.numpy()), jnp.asarray(ds.std.numpy())
    jens, jlosses, jcorrects = jax_training.make_ensemble_gather_multi_step(
        jmodel, donate=False, per_member_order=True)(
        jens, jimages, jlabels, jmean, jstd, jnp.asarray(idx), keys)
    models = [m.model for m in state.members]
    step = make_ensemble_gather_multi_step(models, per_member_order=True, device="cpu")
    state, losses, corrects = step(state, ds.images, ds.labels, ds.mean, ds.std, idx,
                                   [torch.Generator() for _ in range(S)])
    assert losses.shape == (S, K)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(corrects.numpy(), np.asarray(jcorrects))
    _assert_members_near_jax(state, jens, start)

    eval_ds = _dataset(40, 16, data_seed=2)  # two full batches and a tail of 8
    got = ensemble_evaluate(make_ensemble_gather_multi_eval(models, device="cpu"), eval_ds, S,
                            fused_steps=2)
    jeval = jax_training.make_ensemble_gather_multi_eval(jmodel)
    jds = type("DS", (), dict(images=jnp.asarray(eval_ds.images.numpy()),
                              labels=jnp.asarray(eval_ds.labels.numpy()), mean=jmean,
                              std=jstd, n=eval_ds.n, batch_size=16, drop_last=False))
    want = jax_training.ensemble_evaluate(jens, jeval, jds, S, fused_steps=2)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL, atol=TOL)
    assert got["accuracy"] == pytest.approx(want["accuracy"]) and got["samples"] == 40
    for i, model in enumerate(models):
        own = evaluate(make_eval_step(model, device="cpu"), eval_ds,
                       gather_eval=make_gather_multi_eval(model, device="cpu"), fused_steps=2)
        assert own["loss"] == got["loss"][i] and own["accuracy"] == got["accuracy"][i]


# ─── each member is its own run, bit for bit ────────────────────────────

def _seeded_models(n, dropout, depth=1):
    cfg = mnist_config(dropout=dropout, depth=depth)
    return [create_model(KERPLE, cfg, device="cpu", generator=torch.Generator().manual_seed(s))
            for s in range(n)], cfg


def _assert_bitwise(a, b):
    theirs = b.state_dict()
    for n, t in a.state_dict().items():
        assert torch.equal(t, theirs[n]), n


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_members_equal_standalone_gather_runs_bitwise(dropout):
    """Two chunks (K = 3, then a K = 1 tail of another shape) of the
    ensemble's gather-fused step, augmenting, against each member's
    standalone make_gather_multi_step over the same order and generator:
    losses, corrects, parameters and generator states bit for bit."""
    models, cfg = _seeded_models(2, dropout)
    twins, _ = _seeded_models(2, dropout)
    state = create_ensemble_train_state(models, cfg, steps_per_epoch=4)
    step = make_ensemble_gather_multi_step(models, augment="mnist", per_member_order=True,
                                           device="cpu")
    own = [create_train_state(t, cfg, steps_per_epoch=4) for t in twins]
    singles = [make_gather_multi_step(t, augment="mnist", device="cpu") for t in twins]
    gens = [torch.Generator().manual_seed(10 + i) for i in range(2)]
    twin_gens = [torch.Generator().manual_seed(10 + i) for i in range(2)]
    ds = _dataset(64, 8)
    orders = [np.random.default_rng(i).permutation(ds.n)[:32].reshape(4, 8) for i in range(2)]
    for rows in (slice(0, 3), slice(3, 4)):
        state, losses, corrects = step(state, ds.images, ds.labels, ds.mean, ds.std,
                                       np.stack([o[rows] for o in orders]), gens)
        for i in range(2):
            _, want_l, want_c = singles[i](own[i], ds.images, ds.labels, ds.mean, ds.std,
                                           orders[i][rows], twin_gens[i])
            assert torch.equal(losses[i], want_l) and torch.equal(corrects[i], want_c)
            assert torch.equal(gens[i].get_state(), twin_gens[i].get_state())
    for member, twin, twin_state in zip(state.members, twins, own):
        _assert_bitwise(member.model, twin)
        assert member.step == twin_state.step == 4


def test_ensemble_train_step_members_bitwise():
    models, cfg = _seeded_models(2, 0.1)
    twins, _ = _seeded_models(2, 0.1)
    state = create_ensemble_train_state(models, cfg, ema_decay=0.9)
    step = make_ensemble_train_step(models, label_smoothing=0.1, device="cpu")
    gens = [torch.Generator().manual_seed(i) for i in range(2)]
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(6, 28, 28, 1)).astype(np.float32))
    y = torch.arange(6) % 10
    for _ in range(2):
        state, losses, corrects = step(state, x, y, gens)
    for i, twin in enumerate(twins):
        own = create_train_state(twin, cfg, ema_decay=0.9)
        single = make_train_step(twin, label_smoothing=0.1, device="cpu")
        g = torch.Generator().manual_seed(i)
        for _ in range(2):
            _, loss, correct = single(own, x, y, g)
        assert torch.equal(losses[i], loss) and torch.equal(corrects[i], correct)
        _assert_bitwise(state.members[i].model, twin)
        _assert_bitwise(ensemble_member(state, i).eval_view(), own.eval_view())


def test_ensemble_epoch_and_evaluate_equal_members_own_loops():
    """ensemble_train_epoch with member_rngs default_rng(seed_i) against
    train_epoch of each member over a DeviceDataset seeded seed_i (its
    shuffle stream), gather-fused at K = 3; then ensemble_evaluate against
    evaluate: every number and parameter bit for bit."""
    seeds = (42, 153)
    models, cfg = _seeded_models(2, 0.1)
    twins, _ = _seeded_models(2, 0.1)
    state = create_ensemble_train_state(models, cfg, steps_per_epoch=10)
    train_ds = _dataset(80, 8, seed=seeds[0], shuffle=True, augment="mnist")
    test_ds = _dataset(40, 16, data_seed=1)
    step = make_ensemble_gather_multi_step(models, augment="mnist", per_member_order=True,
                                           device="cpu")
    ens_eval = make_ensemble_gather_multi_eval(state.eval_view(), device="cpu")
    gens = [torch.Generator().manual_seed(s) for s in seeds]
    rngs = [np.random.default_rng(s) for s in seeds]
    for epoch in (1, 2):
        state, tm = ensemble_train_epoch(state, step, train_ds, gens, 2, epoch=epoch,
                                         fused_steps=3, member_rngs=rngs, verbose=False)
    em = ensemble_evaluate(ens_eval, test_ds, 2, fused_steps=3)
    assert tm["samples"] == 80 and em["samples"] == 40
    assert tm["loss"][0] != tm["loss"][1]
    for i, (twin, seed) in enumerate(zip(twins, seeds)):
        own = create_train_state(twin, cfg, steps_per_epoch=10)
        ds = _dataset(80, 8, seed=seed, shuffle=True, augment="mnist")
        g = torch.Generator().manual_seed(seed)
        single = make_gather_multi_step(twin, augment="mnist", device="cpu")
        for epoch in (1, 2):
            own, want = train_epoch(own, None, ds, g, epoch=epoch, verbose=False,
                                    gather_step=single, fused_steps=3)
        assert (tm["loss"][i], tm["accuracy"][i]) == (want["loss"], want["accuracy"])
        got = evaluate(make_eval_step(twin, device="cpu"), test_ds,
                       gather_eval=make_gather_multi_eval(twin, device="cpu"), fused_steps=3)
        assert (em["loss"][i], em["accuracy"][i]) == (got["loss"], got["accuracy"])
        _assert_bitwise(state.members[i].model, twin)
    with pytest.raises(ValueError, match="per_member_order"):
        ensemble_train_epoch(state, step, train_ds, gens, 2, fused_steps=3, verbose=False)


@pytest.mark.parametrize("optimizer,ema", [("adamw", 0.9), ("sgd", 0.0)])
def test_reset_train_state_equals_a_fresh_state(optimizer, ema):
    """A state trained, then reset in place from a fresh model of another
    seed, trains as a fresh state of that seed does, bit for bit, its
    tensors never moved."""
    cfg = mnist_config(dropout=0.1, depth=1, optimizer=optimizer)

    def build(seed):
        return create_model(KERPLE, cfg, device="cpu",
                            generator=torch.Generator().manual_seed(seed))

    x = torch.from_numpy(np.random.default_rng(4).normal(size=(6, 28, 28, 1)).astype(np.float32))
    y = torch.arange(6) % 10
    used = create_train_state(build(0), cfg, ema_decay=ema)
    step = make_train_step(used.model, device="cpu")
    for _ in range(2):
        step(used, x, y, torch.Generator().manual_seed(0))
    addresses = [p.data_ptr() for p in used.model.parameters()]
    reset_train_state(used, build(1))
    fresh = create_train_state(build(1), cfg, ema_decay=ema)
    fresh_step = make_train_step(fresh.model, device="cpu")
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    for _ in range(2):
        assert torch.equal(step(used, x, y, g1)[1], fresh_step(fresh, x, y, g2)[1])
    _assert_bitwise(used.model, fresh.model)
    _assert_bitwise(used.eval_view(), fresh.eval_view())
    assert used.step == fresh.step == 2
    assert [p.data_ptr() for p in used.model.parameters()] == addresses


# ─── refusals ───────────────────────────────────────────────────────────

def test_structure_mismatch_and_misuse_are_refused():
    cfg = mnist_config(depth=1)
    a = create_model(KERPLE, cfg, device="cpu")
    deeper = create_model(KERPLE, mnist_config(depth=2), device="cpu")
    other = create_model("baseline", cfg, device="cpu")
    for models in ([a, deeper], [a, other]):
        with pytest.raises(ValueError, match="structure"):
            create_ensemble_train_state(models, cfg)
    with pytest.raises(ValueError, match="own"):
        create_ensemble_train_state([a, a], cfg)
    b = create_model(KERPLE, cfg, device="cpu")
    state = create_ensemble_train_state([a, b], cfg)
    step = make_ensemble_gather_multi_step([a, b], per_member_order=True, device="cpu")
    ds = _dataset(16, 8)
    with pytest.raises(ValueError, match="generators"):
        step(state, ds.images, ds.labels, ds.mean, ds.std, np.zeros((2, 1, 8)),
             [torch.Generator()])
    with pytest.raises(ValueError, match="idx"):
        step(state, ds.images, ds.labels, ds.mean, ds.std, np.zeros((1, 8)),
             [torch.Generator(), torch.Generator()])
    with pytest.raises(ValueError, match="other models"):
        make_ensemble_train_step([b, a], device="cpu")(
            state, torch.zeros(2, 28, 28, 1), torch.zeros(2, dtype=torch.long),
            [torch.Generator(), torch.Generator()])


def test_mesh_is_not_ported():
    a = create_model(KERPLE, mnist_config(depth=1), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A #7"):
        make_ensemble_train_step([a], mesh=object(), device="cpu")
