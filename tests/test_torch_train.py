"""The port's training step against the JAX package's, on the CPU.

The JAX model is built with rpe_config={"method": "dense"} (its custom VJP
is the oracle of the KERPLE backward), initialised by flax, and its
variables are carried into the port with `load_flax_variables`; the port
runs its default KERPLE route, which on CPU tensors is the plain version
of the forward and backward kernels behind the same autograd Function the
GPU runs. Inputs come from numpy.

Tolerances: fp32 gradients agree to rtol 1e-4 plus atol 1e-4 times the
tensor's largest gradient (summation order only, through a few layers).
bf16: both frameworks round activations at slightly different places, so
each framework's bf16 gradients are held against the JAX fp32 ones and the
port's error must stay within BF16_ERROR_FACTOR times JAX's own. Schedules
and optimiser updates are compared with optax at rtol 1e-5 (optax works in
fp32, the port's schedules in Python floats). Three-step trajectories:
losses at rtol 1e-5; each parameter tensor's distance from the JAX one at
most PARAM_REL_TOL of how far the JAX tensor moved in the three steps.
Adam divides by the root of the second moment, so an element whose
gradient is near zero can take a visibly different step from a rounding
difference of 1e-7 (one element of 12288 moved 2e-4 against lr 1e-3);
the norm holds the update as a whole to 0.2%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from efficient_rpe_vit_tpu.configs import cifar10_config as jax_cifar10_config
from efficient_rpe_vit_tpu.configs import mnist_config as jax_mnist_config
from efficient_rpe_vit_tpu.models import create_model as jax_create_model
from efficient_rpe_vit_tpu.train import training as jax_training
from efficient_rpe_vit_tpu.utils.import_torch import state_dict_to_params
from efficient_rpe_vit_torch.configs import cifar10_config, mnist_config
from efficient_rpe_vit_torch.models import attention as port_attention
from efficient_rpe_vit_torch.models import create_model
from efficient_rpe_vit_torch.train import (
    TrainState,
    create_lr_scheduler,
    create_optimizer,
    create_train_state,
    cross_entropy_loss,
    make_train_step,
)
from efficient_rpe_vit_torch.utils import flax_to_state_dict, load_flax_variables

torch.set_num_threads(2)

VARIANTS = ["performer_favor_most_general", "performer_relu_most_general",
            "performer_favor", "performer_relu"]
SMALL = dict(dim=64, heads=2, depth=2, mlp_dim=128, dropout=0.0, patch_size=7)
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-4
BF16_ERROR_FACTOR = 2.0
PARAM_REL_TOL = 2e-3
CONFIGS = {"mnist": (mnist_config, jax_mnist_config),
           "cifar10": (cifar10_config, jax_cifar10_config)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(name, overrides, dtype="float32", attention_config=None,
          config="mnist"):
    """(jax model, its variables as numpy trees, port model with the same
    variables)."""
    port_cfg, jax_cfg = CONFIGS[config]
    jcfg = jax_cfg(**overrides, compute_dtype=dtype)
    jmodel = jax_create_model(name, jcfg, rpe_config={"method": "dense"},
                              attention_config=attention_config)
    m = jcfg.model
    sample = jnp.zeros((1, m.image_size, m.image_size, m.in_channels))
    variables = _np_tree(jmodel.init({"params": jax.random.PRNGKey(0)}, sample))
    tmodel = create_model(name, port_cfg(**overrides, compute_dtype=dtype),
                          attention_config=attention_config, device="cpu")
    load_flax_variables(tmodel, variables["params"], variables.get("constants"),
                        variables.get("state"))
    return jmodel, variables, tmodel


def _batch(cfg, batch, seed):
    m = cfg.model
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, m.image_size, m.image_size,
                         m.in_channels)).astype(np.float32)
    y = rng.integers(0, m.num_classes, size=batch).astype(np.int32)
    return x, y


def _jax_grads(jmodel, variables, x, y):
    """{torch name: gradient} of the mean cross-entropy, fp32 numpy."""
    def loss(params):
        logits = jmodel.apply({"params": params, "constants": variables["constants"]},
                              jnp.asarray(x), deterministic=True)
        return jax_training.cross_entropy_loss(logits.astype(jnp.float32),
                                               jnp.asarray(y))

    grads = jax.jit(jax.grad(loss))(variables["params"])
    return {k: v.numpy() for k, v in flax_to_state_dict(_np_tree(grads)).items()}


def _port_grads(tmodel, x, y):
    tmodel.train()
    tmodel.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(tmodel(torch.from_numpy(x), torch.Generator()),
                              torch.from_numpy(y).long())
    loss.backward()
    return {n: p.grad.float().numpy() for n, p in tmodel.named_parameters()}


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for name, g in got.items():
        scale = np.abs(want[name]).max()
        np.testing.assert_allclose(g, want[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_SCALE * scale, err_msg=name)


def _rel_errors(got, ref):
    return {n: np.linalg.norm(got[n] - ref[n]) / max(np.linalg.norm(ref[n]), 1e-30)
            for n in ref}


# ─── gradients ──────────────────────────────────────────────────────────

@pytest.mark.parametrize("name", VARIANTS)
def test_gradients_match_jax_fp32(name):
    jmodel, variables, tmodel = _pair(name, SMALL)
    x, y = _batch(jax_mnist_config(**SMALL), 3, seed=0)
    _assert_grads_close(_port_grads(tmodel, x, y), _jax_grads(jmodel, variables, x, y))


@pytest.mark.parametrize("name", VARIANTS)
def test_gradients_match_jax_bf16(name):
    overrides = dict(SMALL, patch_size=4)
    jmodel32, variables, _ = _pair(name, overrides)
    jmodel16, _, tmodel16 = _pair(name, overrides, dtype="bfloat16")
    x, y = _batch(jax_mnist_config(**overrides), 4, seed=1)
    ref = _jax_grads(jmodel32, variables, x, y)
    jax_err = _rel_errors(_jax_grads(jmodel16, variables, x, y), ref)
    port_err = _rel_errors(_port_grads(tmodel16, x, y), ref)
    assert 0 < max(jax_err.values()) < 0.5
    # the worst tensor and the typical tensor, each against JAX's own
    assert max(port_err.values()) <= BF16_ERROR_FACTOR * max(jax_err.values())
    assert np.median(list(port_err.values())) <= \
        BF16_ERROR_FACTOR * np.median(list(jax_err.values()))


def test_full_width_depth1_gradients_match_jax():
    """ViT-B/16 widths (dim 768, 12 heads, N=197, F=266), depth 1, fp32."""
    overrides = dict(image_size=224, patch_size=16, in_channels=3,
                     num_classes=1000, dim=768, depth=1, heads=12,
                     mlp_dim=3072, dropout=0.0)
    jmodel, variables, tmodel = _pair("performer_favor_most_general", overrides)
    assert variables["constants"]["block_0"]["attention"]["omega"].shape == (12, 64, 266)
    x, y = _batch(jax_mnist_config(**overrides), 2, seed=2)
    _assert_grads_close(_port_grads(tmodel, x, y), _jax_grads(jmodel, variables, x, y))


# ─── schedules and optimisers ───────────────────────────────────────────

SCHEDULES = [("cosine", 0), ("cosine", 1), ("warmup_cosine", 1), ("step", 0),
             ("constant", 0), ("none", 0)]


@pytest.mark.parametrize("scheduler,warmup", SCHEDULES)
def test_lr_schedule_matches_optax(scheduler, warmup):
    args = (scheduler, 0.1, 4, 5, warmup, 1, 0.5)  # lr, epochs, steps/epoch, warmup, step size, gamma
    port = create_lr_scheduler(*args)
    ref = jax_training.create_lr_scheduler(*args)
    got = [port(c) for c in range(25)]
    want = [float(ref(c)) for c in range(25)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


def test_lr_schedule_rejects_unknown_names():
    with pytest.raises(ValueError):
        create_lr_scheduler("linear", 0.1, 1, 1)
    with pytest.raises(ValueError):
        create_optimizer("lamb", nn.Linear(2, 2).parameters(), lambda c: 0.1)


@pytest.mark.parametrize("scheduler", ["cosine", "warmup_cosine", "step", "constant"])
@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd"])
def test_optimizer_matches_optax(optimizer, scheduler):
    """Three updates from identical gradients give the same parameters and
    use the same learning rate at each step; weight decay 0.05 is coupled
    for adam and sgd and decoupled for adamw, as in the JAX package."""
    rng = np.random.default_rng(5)
    w0 = rng.normal(size=(3, 4)).astype(np.float32)
    b0 = rng.normal(size=(3,)).astype(np.float32)
    grads = [(rng.normal(size=(3, 4)).astype(np.float32),
              rng.normal(size=(3,)).astype(np.float32)) for _ in range(3)]
    sched_args = (scheduler, 0.05, 3, 1, 1, 1, 0.5)

    tx = jax_training.create_optimizer(
        optimizer, jax_training.create_lr_scheduler(*sched_args), 0.05)
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    opt_state = tx.init(params)
    for gw, gb in grads:
        updates, opt_state = tx.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb)},
                                       opt_state, params)
        params = optax.apply_updates(params, updates)

    layer = nn.Linear(4, 3)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w0))
        layer.bias.copy_(torch.from_numpy(b0))
    schedule = create_lr_scheduler(*sched_args)
    state = TrainState(model=layer, optimizer=create_optimizer(
        optimizer, layer.parameters(), schedule, 0.05), schedule=schedule)
    for i, (gw, gb) in enumerate(grads):
        layer.weight.grad = torch.from_numpy(gw)
        layer.bias.grad = torch.from_numpy(gb)
        state.apply_gradients()
        assert state.optimizer.param_groups[0]["lr"] == schedule(i)
    assert state.step == 3
    np.testing.assert_allclose(layer.weight.detach().numpy(), np.asarray(params["w"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(layer.bias.detach().numpy(), np.asarray(params["b"]),
                               rtol=1e-5, atol=1e-6)


def test_sgd_with_a_device_style_lr_equals_the_float_one():
    """The sgd update takes its learning rate as a float (the CPU) or as a
    0-dim tensor it multiplies in without reading it (the card's capturable
    build): the same fp32 products, so bitwise the same parameters and
    momentum traces over a schedule; built capturable it passes the K-step
    programs' graph check."""
    from efficient_rpe_vit_torch.train import SGD
    from efficient_rpe_vit_torch.train import training as port_training

    rng = np.random.default_rng(6)
    w0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = [rng.normal(size=(5, 4)).astype(np.float32) for _ in range(4)]
    schedule = create_lr_scheduler("warmup_cosine", 0.05, 4, 1, 1)
    layers, states = [], []
    for lr in (schedule(0), torch.tensor(schedule(0), dtype=torch.float32)):
        layer = nn.Linear(4, 5, bias=False)
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(w0))
        opt = SGD(layer.parameters(), lr=lr, momentum=0.9, weight_decay=0.05,
                  capturable=isinstance(lr, torch.Tensor))
        layers.append(layer)
        states.append(TrainState(model=layer, optimizer=opt, schedule=schedule))
    for g in grads:
        for layer, state in zip(layers, states):
            layer.weight.grad = torch.from_numpy(g)
            state.apply_gradients()
    assert torch.equal(layers[0].weight, layers[1].weight)
    traces = [s.optimizer.state[l.weight]["momentum_buffer"] for s, l in zip(states, layers)]
    assert torch.equal(*traces)
    assert port_training._graph_blocker(layers[1], states[1].optimizer) is None
    assert "SGD is not capturable" in port_training._graph_blocker(layers[0],
                                                                   states[0].optimizer)


# ─── train steps ────────────────────────────────────────────────────────

STEP_CASES = {
    # config, grad_accum, label_smoothing, ema_decay
    "mnist_adam_cosine": ("mnist", 1, 0.0, 0.0),
    "accum2_smoothing": ("mnist", 2, 0.1, 0.0),
    "cifar_adamw_warmup_ema": ("cifar10", 1, 0.0, 0.9),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_three_train_steps_match_jax(case):
    config, accum, smoothing, ema = STEP_CASES[case]
    name = "performer_favor_most_general"
    overrides = dict(SMALL, patch_size=8 if config == "cifar10" else 7)
    jmodel, variables, tmodel = _pair(name, overrides, config=config)
    jcfg = CONFIGS[config][1](**overrides)
    sample = jnp.zeros((1, jcfg.model.image_size, jcfg.model.image_size,
                        jcfg.model.in_channels))
    jstate = jax_training.create_train_state(jmodel, jcfg, jax.random.PRNGKey(0),
                                             sample, steps_per_epoch=2,
                                             ema_decay=ema)
    jstep = jax_training.make_train_step(jmodel, grad_accum=accum,
                                         label_smoothing=smoothing)
    state = create_train_state(tmodel, CONFIGS[config][0](**overrides),
                               steps_per_epoch=2, ema_decay=ema)
    step = make_train_step(tmodel, grad_accum=accum, label_smoothing=smoothing,
                           device="cpu")
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        x, y = _batch(jcfg, 4, seed=10 + i)
        jstate, jloss, jcorrect = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                                        jax.random.PRNGKey(i))
        state, loss, correct = step(state, torch.from_numpy(x), torch.from_numpy(y), gen)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        assert correct.item() == int(jcorrect)
    assert state.step == int(jstate.step) == 3
    start = flax_to_state_dict(variables["params"])
    for got, want in ((tmodel, jstate.params),
                      (state.eval_view(), jstate.ema_params if ema else jstate.params)):
        want = flax_to_state_dict(_np_tree(want))
        for n, p in got.named_parameters():
            moved = np.linalg.norm(want[n].numpy() - start[n].numpy())
            diff = np.linalg.norm(p.detach().numpy() - want[n].numpy())
            assert moved > 0 and diff <= PARAM_REL_TOL * moved, (n, diff, moved)


def test_feature_redraw_matches_jax_counter():
    """Omega is redrawn on the train-mode calls where counter % k == 0 (the
    first call included), i.e. at steps 0, k and 2k; the counters track the
    JAX package's 'state' collection; eval never redraws."""
    k, steps = 2, 5
    name = "performer_favor_most_general"
    attn = {"feature_redraw_interval": k}
    jmodel, variables, tmodel = _pair(name, SMALL, attention_config=attn)
    assert int(tmodel.transformer_blocks[0].attention.redraw_counter) == 0
    jcfg = jax_mnist_config(**SMALL)
    sample = jnp.zeros((1, 28, 28, 1))
    jstate = jax_training.create_train_state(jmodel, jcfg, jax.random.PRNGKey(0), sample)
    jstep = jax_training.make_train_step(jmodel)
    state = create_train_state(tmodel, mnist_config(**SMALL))
    step = make_train_step(tmodel, device="cpu")
    gen = torch.Generator().manual_seed(0)
    attns = [blk.attention for blk in tmodel.transformer_blocks]
    redrawn = []
    for i in range(steps):
        x, y = _batch(jcfg, 2, seed=20 + i)
        jstate, _, _ = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(i))
        before = [a.omega.clone() for a in attns]
        step(state, torch.from_numpy(x), torch.from_numpy(y), gen)
        changed = [not torch.equal(b, a.omega) for b, a in zip(before, attns)]
        assert len(set(changed)) == 1  # every block redraws on the same calls
        redrawn.append(changed[0])
    assert [i for i, r in enumerate(redrawn) if r] == [0, k, 2 * k]
    jcounters = _np_tree(jstate.mutable_state)
    for i, a in enumerate(attns):
        assert int(a.redraw_counter) == int(jcounters[f"block_{i}"]["attention"]["redraw_counter"]) == steps
    omega = [a.omega.clone() for a in attns]
    tmodel.eval()
    with torch.inference_mode():
        tmodel(torch.zeros(2, 28, 28, 1))
    assert all(torch.equal(o, a.omega) for o, a in zip(omega, attns))
    assert all(int(a.redraw_counter) == steps for a in attns)


def test_feature_redraw_counts_each_microbatch():
    """With grad_accum=2 each microbatch's forward advances the counter, as
    the JAX scan threads it."""
    name = "performer_relu_most_general"
    attn = {"feature_redraw_interval": 3}
    jmodel, variables, tmodel = _pair(name, SMALL, attention_config=attn)
    jcfg = jax_mnist_config(**SMALL)
    jstate = jax_training.create_train_state(jmodel, jcfg, jax.random.PRNGKey(0),
                                             jnp.zeros((1, 28, 28, 1)))
    x, y = _batch(jcfg, 4, seed=30)
    jstate, _, _ = jax_training.make_train_step(jmodel, grad_accum=2)(
        jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    state = create_train_state(tmodel, mnist_config(**SMALL))
    make_train_step(tmodel, grad_accum=2, device="cpu")(
        state, torch.from_numpy(x), torch.from_numpy(y), torch.Generator())
    want = _np_tree(jstate.mutable_state)["block_0"]["attention"]["redraw_counter"]
    assert int(tmodel.transformer_blocks[0].attention.redraw_counter) == int(want) == 2


def test_dropout_is_live_in_train_mode_and_seeded():
    cfg = mnist_config(**dict(SMALL, dropout=0.3))
    model = create_model("performer_favor_most_general", cfg, device="cpu")
    x = torch.from_numpy(_batch(jax_mnist_config(**SMALL), 2, seed=3)[0])
    with torch.no_grad():
        e1, e2 = model.eval()(x), model(x, torch.Generator().manual_seed(9))
        t1 = model.train()(x, torch.Generator().manual_seed(1))
        t2 = model(x, torch.Generator().manual_seed(1))
        t3 = model(x, torch.Generator().manual_seed(2))
    assert torch.equal(e1, e2)  # eval: no dropout, the generator is unused
    assert torch.equal(t1, t2)  # the same seed gives the same masks
    assert not torch.equal(t1, t3) and not torch.equal(t1, e1)
    with pytest.raises(ValueError, match="generator"):
        model(x)


def test_same_generator_seed_gives_the_same_step():
    """Two models from one seed, stepped twice with generators of one seed
    (dropout and feature redraw live), end bitwise equal."""
    cfg = mnist_config(**dict(SMALL, dropout=0.2))
    attn = {"feature_redraw_interval": 1}
    x, y = (torch.from_numpy(a) for a in _batch(jax_mnist_config(**SMALL), 4, seed=4))
    runs = []
    for _ in range(2):
        model = create_model("performer_favor_most_general", cfg, device="cpu",
                             attention_config=attn,
                             generator=torch.Generator().manual_seed(5))
        state = create_train_state(model, cfg)
        step = make_train_step(model, device="cpu")
        gen = torch.Generator().manual_seed(6)
        losses = [step(state, x, y, gen)[1] for _ in range(2)]
        runs.append((losses, model.state_dict()))
    (l1, sd1), (l2, sd2) = runs
    assert all(torch.equal(a, b) for a, b in zip(l1, l2))
    assert all(torch.equal(sd1[k], sd2[k]) for k in sd1)


def test_phi_checkpoint_gives_identical_gradients(monkeypatch):
    """Recomputing phi in the backward (forced by a zero byte limit) gives
    bitwise the gradients of keeping it, and the KERPLE forward still runs
    once per block."""
    name = "performer_favor_most_general"
    _, _, tmodel = _pair(name, SMALL)
    x, y = _batch(jax_mnist_config(**SMALL), 3, seed=5)
    kept = _port_grads(tmodel, x, y)
    calls = []
    real = port_attention.checkpoint

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(port_attention, "PHI_CHECKPOINT_BYTES", 0)
    monkeypatch.setattr(port_attention, "checkpoint", counting)
    recomputed = _port_grads(tmodel, x, y)
    assert len(calls) == SMALL["depth"]
    for n in kept:
        np.testing.assert_array_equal(recomputed[n], kept[n], err_msg=n)
    # inference never checkpoints
    with torch.inference_mode():
        tmodel.eval()(torch.from_numpy(x))
    assert len(calls) == SMALL["depth"]


# ─── weights, state and entry points ────────────────────────────────────

def test_flax_state_collection_loads_into_redraw_counters():
    name = "performer_favor_most_general"
    attn = {"feature_redraw_interval": 3}
    _, variables, tmodel = _pair(name, SMALL, attention_config=attn)
    state = jax.tree_util.tree_map(lambda c: np.asarray(7, np.int32), variables["state"])
    load_flax_variables(tmodel, variables["params"], variables["constants"], state)
    for blk in tmodel.transformer_blocks:
        assert blk.attention.redraw_counter.dtype == torch.int32
        assert int(blk.attention.redraw_counter) == 7
    # strict: a redraw model needs its counters
    with pytest.raises(RuntimeError, match="redraw_counter"):
        load_flax_variables(tmodel, variables["params"], variables["constants"])
    # the JAX importer maps the state dict back onto params and constants
    back, back_consts = state_dict_to_params(tmodel.state_dict(), variables["params"],
                                             variables["constants"])
    for tree, orig in ((back, variables["params"]), (back_consts, variables["constants"])):
        want = dict(jax.tree_util.tree_leaves_with_path(orig))
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            np.testing.assert_array_equal(np.asarray(leaf), want[path], err_msg=str(path))


def test_train_step_checks_its_arguments():
    cfg = mnist_config(**SMALL)
    model = create_model("performer_favor", cfg, device="cpu")
    other = create_model("performer_favor", cfg, device="cpu")
    x, y = (torch.from_numpy(a) for a in _batch(jax_mnist_config(**SMALL), 3, seed=6))
    with pytest.raises(ValueError):
        make_train_step(model, grad_accum=0, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(model, grad_accum=2, device="cpu")(
            create_train_state(model, cfg), x, y, torch.Generator())
    with pytest.raises(ValueError, match="another model"):
        make_train_step(model, device="cpu")(
            create_train_state(other, cfg), x, y, torch.Generator())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_train_step(model)
