"""The port's training engine against the JAX package's, on the CPU.

K-step programs (`make_multi_step`, `make_gather_multi_step`,
`make_gather_multi_eval`), the epoch and evaluation loops, the metrics,
`Timer` and `bench_torch.py`'s FLOP count and its refusal without a GPU.

The JAX model is built with rpe_config={"method": "dense"}, initialised by
flax, and its variables carried into the port with `load_flax_variables`;
dropout 0 and no augmentation wherever the two frameworks are compared (their
RNGs differ). Tolerances are those of tests/test_torch_train.py's
three-step trajectories: losses at rtol 1e-5, each parameter tensor's
distance from the JAX one at most PARAM_REL_TOL of how far the JAX tensor
moved. Within the port the K-step programs run the same arithmetic as the
per-step train step on the CPU, so they are held to it bit for bit (with
dropout live, the masks drawn from one generator). On the GPU the K steps
are one CUDA graph; chip_smoke.py holds replays against eager steps.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_rpe_vit_tpu.configs import mnist_config as jax_mnist_config
from efficient_rpe_vit_tpu.data import pipeline as jax_pipeline
from efficient_rpe_vit_tpu.models import create_model as jax_create_model
from efficient_rpe_vit_tpu.train import metrics as jax_metrics
from efficient_rpe_vit_tpu.train import training as jax_training
from efficient_rpe_vit_torch.configs import mnist_config
from efficient_rpe_vit_torch.data import DeviceDataset
from efficient_rpe_vit_torch.models import create_model
from efficient_rpe_vit_torch.train import (
    compute_classification_metrics,
    create_lr_scheduler,
    create_optimizer,
    create_train_state,
    evaluate,
    make_eval_step,
    make_gather_multi_eval,
    make_gather_multi_step,
    make_multi_step,
    make_train_step,
    train_epoch,
)
from efficient_rpe_vit_torch.train import training as port_training
from efficient_rpe_vit_torch.utils import flax_to_state_dict, load_flax_variables
from efficient_rpe_vit_torch.utils.timing import Timer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench_torch  # noqa: E402

NAME = "performer_favor_most_general"
SMALL = dict(dim=64, heads=2, depth=2, mlp_dim=128, dropout=0.0, patch_size=7)
PARAM_REL_TOL = 2e-3
MEAN, STD = (0.1307,), (0.3081,)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(overrides=SMALL, attention_config=None):
    """(jax model, its train state, its initial params as numpy, the port
    model with the same variables, its train state)."""
    jcfg = jax_mnist_config(**overrides)
    jmodel = jax_create_model(NAME, jcfg, rpe_config={"method": "dense"},
                              attention_config=attention_config)
    sample = jnp.zeros((1, 28, 28, 1))
    variables = _np_tree(jmodel.init({"params": jax.random.PRNGKey(0)}, sample))
    jstate = jax_training.create_train_state(jmodel, jcfg, jax.random.PRNGKey(0), sample,
                                             steps_per_epoch=4)
    cfg = mnist_config(**overrides)
    tmodel = create_model(NAME, cfg, attention_config=attention_config, device="cpu")
    load_flax_variables(tmodel, variables["params"], variables.get("constants"),
                        variables.get("state"))
    return jmodel, jstate, variables["params"], tmodel, create_train_state(
        tmodel, cfg, steps_per_epoch=4)


def _twins(overrides, ema=0.0):
    """Two port models and states from one seed."""
    cfg = mnist_config(**overrides)
    models = [create_model(NAME, cfg, device="cpu", generator=torch.Generator().manual_seed(0))
              for _ in range(2)]
    return models, [create_train_state(m, cfg, steps_per_epoch=4, ema_decay=ema)
                    for m in models]


def _data(n, k=None, b=None, seed=0):
    rng = np.random.default_rng(seed)
    if k is None:
        return (rng.integers(0, 256, (n, 28, 28, 1), dtype=np.uint8),
                rng.integers(0, 10, n).astype(np.int32))
    return (rng.normal(size=(k, b, 28, 28, 1)).astype(np.float32),
            rng.integers(0, 10, (k, b)).astype(np.int32))


def _assert_bitwise(a, b):
    sb = b.state_dict()
    for n, t in a.state_dict().items():
        assert torch.equal(t, sb[n]), n


def _assert_params_near_jax(tmodel, jparams, start):
    want = flax_to_state_dict(_np_tree(jparams))
    start = flax_to_state_dict(start)
    for n, p in tmodel.named_parameters():
        moved = np.linalg.norm(want[n].numpy() - start[n].numpy())
        diff = np.linalg.norm(p.detach().numpy() - want[n].numpy())
        assert moved > 0 and diff <= PARAM_REL_TOL * moved, (n, diff, moved)


# ─── K steps per call ───────────────────────────────────────────────────

MULTI_CASES = {
    # optimizer, dropout, label smoothing, ema decay
    "adam": ("adam", 0.0, 0.0, 0.0),
    "adamw_dropout_smoothing_ema": ("adamw", 0.2, 0.1, 0.9),
    "sgd_dropout": ("sgd", 0.1, 0.0, 0.0),
}


@pytest.mark.parametrize("case", sorted(MULTI_CASES))
def test_multi_step_equals_train_steps_bitwise(case):
    optimizer, dropout, smoothing, ema = MULTI_CASES[case]
    overrides = dict(SMALL, dropout=dropout, optimizer=optimizer)
    (m1, m2), (s1, s2) = _twins(overrides, ema)
    xs, ys = (torch.from_numpy(a) for a in _data(0, k=3, b=4, seed=1))
    multi = make_multi_step(m1, label_smoothing=smoothing, device="cpu")
    step = make_train_step(m2, label_smoothing=smoothing, device="cpu")
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    for _ in range(2):
        s1, losses, corrects = multi(s1, xs, ys, g1)
        want = [step(s2, x, y, g2)[1:] for x, y in zip(xs, ys)]
        assert torch.equal(losses, torch.stack([w[0] for w in want]))
        assert torch.equal(corrects, torch.stack([w[1] for w in want]))
    assert s1.step == s2.step == 6
    _assert_bitwise(m1, m2)
    if ema:
        _assert_bitwise(s1.eval_view(), s2.eval_view())


def test_multi_step_matches_jax():
    jmodel, jstate, start, tmodel, state = _pair()
    xs, ys = _data(0, k=3, b=4, seed=2)
    jstate, jlosses, jcorrects = jax_training.make_multi_step(jmodel, donate=False)(
        jstate, jnp.asarray(xs), jnp.asarray(ys), jax.random.PRNGKey(1))
    state, losses, corrects = make_multi_step(tmodel, device="cpu")(
        state, torch.from_numpy(xs), torch.from_numpy(ys), torch.Generator())
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    np.testing.assert_array_equal(corrects.numpy(), np.asarray(jcorrects))
    assert state.step == int(jstate.step) == 3
    _assert_params_near_jax(tmodel, jstate.params, start)


@pytest.mark.parametrize("scheduler,warmup", [("cosine", 0), ("warmup_cosine", 1),
                                              ("step", 0), ("constant", 0)])
def test_lr_table_is_the_schedule(scheduler, warmup):
    """A replay's table entry i is schedule(step + i) rounded to fp32, the
    value the eager step's fill of the device lr writes."""
    schedule = create_lr_scheduler(scheduler, 0.1, 4, 5, warmup, 1, 0.5)
    table = port_training._lr_table(schedule, 3, 9)
    assert table.dtype == np.float32
    for i, lr in enumerate(table):
        assert lr == np.float32(schedule(3 + i))
        assert torch.tensor(0.0).fill_(schedule(3 + i)).item() == lr


def test_multi_step_advances_redraw_counters_by_k_as_jax():
    """Feature redraw on the CPU: K steps advance each counter by K, as the
    JAX scan threads it; the host reads the counters a GPU graph is keyed
    by (`_HostCounts`: each count modulo its interval) and no blocker
    refuses the model."""
    attn = {"feature_redraw_interval": 2}
    jmodel, jstate, _, tmodel, state = _pair(attention_config=attn)
    xs, ys = _data(0, k=4, b=4, seed=3)
    jnew, _, _ = jax_training.make_multi_step(jmodel, donate=False)(
        jstate, jnp.asarray(xs), jnp.asarray(ys), jax.random.PRNGKey(0))
    state, losses, _ = make_multi_step(tmodel, device="cpu")(
        state, torch.from_numpy(xs), torch.from_numpy(ys), torch.Generator())
    assert bool(torch.isfinite(losses).all())
    jcounters = _np_tree(jnew.mutable_state)
    for i, blk in enumerate(tmodel.transformer_blocks):
        want = int(jcounters[f"block_{i}"]["attention"]["redraw_counter"])
        assert int(blk.attention.redraw_counter) == want == 4
    host = port_training._HostCounts([tmodel])
    assert host.read() == (4,) * len(tmodel.transformer_blocks)
    assert host.key(host.read()) == (0,) * len(tmodel.transformer_blocks)
    capturable = torch.optim.Adam(tmodel.parameters(), lr=torch.tensor(0.1), capturable=True)
    assert port_training._graph_blocker(capturable) is None


def test_graph_blockers_and_the_gpu_default():
    model = create_model(NAME, mnist_config(**SMALL), device="cpu")
    params = list(model.parameters())
    schedule = lambda c: 0.1  # noqa: E731
    sgd = create_optimizer("sgd", params, schedule)
    assert "SGD is not capturable" in port_training._graph_blocker(sgd)
    capturable = torch.optim.Adam(params, lr=torch.tensor(0.1), capturable=True)
    assert port_training._graph_blocker(capturable) is None
    # off the card the optimiser keeps a float lr
    adam = create_optimizer("adam", params, schedule)
    assert adam.param_groups[0]["lr"] == 0.1 and not adam.param_groups[0]["capturable"]
    if not torch.cuda.is_available():
        for make in (make_multi_step, make_gather_multi_step, make_gather_multi_eval):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make(model)


def test_gather_multi_step_matches_jax():
    jmodel, jstate, start, tmodel, state = _pair()
    images, labels = _data(40, seed=4)
    idx = np.random.default_rng(5).permutation(40)[:12].reshape(3, 4).astype(np.int32)
    mean, std = np.asarray(MEAN, np.float32), np.asarray(STD, np.float32)
    jstate, jlosses, jcorrects = jax_training.make_gather_multi_step(jmodel, donate=False)(
        jstate, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(mean),
        jnp.asarray(std), jnp.asarray(idx), jax.random.PRNGKey(0))
    state, losses, corrects = make_gather_multi_step(tmodel, device="cpu")(
        state, torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(mean),
        torch.from_numpy(std), idx, torch.Generator())
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    np.testing.assert_array_equal(corrects.numpy(), np.asarray(jcorrects))
    assert state.step == int(jstate.step) == 3
    _assert_params_near_jax(tmodel, jstate.params, start)


def test_gather_multi_eval_matches_jax():
    jmodel, jstate, _, tmodel, _ = _pair()
    images, labels = _data(30, seed=6)
    idx = np.arange(24, dtype=np.int32).reshape(3, 8)
    mean, std = np.asarray(MEAN, np.float32), np.asarray(STD, np.float32)
    jl, jc, jp = jax_training.make_gather_multi_eval(jmodel)(
        jstate, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(mean),
        jnp.asarray(std), jnp.asarray(idx))
    losses, corrects, preds = make_gather_multi_eval(tmodel, device="cpu")(
        torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(mean),
        torch.from_numpy(std), idx)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_array_equal(corrects.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(jp))
    assert preds.shape == (3, 8)


# ─── the epoch and evaluation loops ─────────────────────────────────────

def _datasets(n, bs, port_device="cpu", **kw):
    images, labels = _data(n, seed=7)
    return (DeviceDataset(images, labels, MEAN, STD, bs, device=port_device, **kw),
            jax_pipeline.DeviceDataset(images, labels, MEAN, STD, bs, **kw))


def test_train_epoch_loops_agree_with_each_other_and_jax():
    """88 samples in batches of 16 with the partial batch kept: the per-batch
    loop, K=2 multi-step chunks (5 full batches: 2 + 2 + 1, then the tail
    of 8 as its own chunk) and gather-fused [K, B] chunks give bitwise the
    same parameters and the same metrics, and the JAX package's per-batch
    loop's at the trajectory tolerances."""
    kw = dict(shuffle=True, drop_last=False, seed=3)
    jmodel, jstate, start, _, _ = _pair()
    jstate, jmetrics = jax_training.train_epoch(
        jstate, jax_training.make_train_step(jmodel), _datasets(88, 16, **kw)[1],
        jax.random.PRNGKey(0), verbose=False)
    runs = []
    for drive in ({"train_step": "step"}, {"multi_step": "multi", "fused_steps": 2},
                  {"gather_step": "gather", "fused_steps": 2}):
        _, _, _, tmodel, state = _pair()
        steps = {"step": make_train_step, "multi": make_multi_step,
                 "gather": make_gather_multi_step}
        args = {key: steps[v](tmodel, device="cpu") if v in steps else v
                for key, v in drive.items()}
        args.setdefault("train_step", None)
        state, metrics = train_epoch(state, dataset=_datasets(88, 16, **kw)[0],
                                     generator=torch.Generator(), verbose=False, **args)
        assert state.step == 6
        runs.append((tmodel, metrics))
    (m0, r0), *rest = runs
    for m, r in rest:
        _assert_bitwise(m, m0)
        assert {k: r[k] for k in ("loss", "accuracy", "samples")} == \
            {k: r0[k] for k in ("loss", "accuracy", "samples")}
    assert r0["samples"] == jmetrics["samples"] == 88
    assert r0["loss"] == pytest.approx(jmetrics["loss"], rel=1e-5)
    assert r0["accuracy"] == jmetrics["accuracy"]
    _assert_params_near_jax(m0, jstate.params, start)


def test_train_epoch_prints_the_jax_progress_lines(capsys):
    _, _, _, tmodel, state = _pair()
    ds = _datasets(64, 16, shuffle=True, drop_last=True)[0]
    train_epoch(state, make_train_step(tmodel, device="cpu"), ds, torch.Generator(),
                epoch=2, log_interval_frac=0.5)
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(" loss")[0] for line in lines] == ["  epoch 2 [2/4]", "  epoch 2 [4/4]"]
    assert all("% (" in line and line.endswith("s)") for line in lines)


@pytest.mark.parametrize("step_augment,data_augment",
                         [(None, "mnist"), ("mnist", None), ("mnist", "mnist")])
def test_gather_epoch_takes_the_datasets_augmentation(step_augment, data_augment):
    """The gather-fused loop augments as the dataset says, like the other
    loops: a gather step built with another policy is refused."""
    models, states = _twins(SMALL)
    ds = DeviceDataset(*_data(32), MEAN, STD, 8, augment=data_augment, device="cpu")
    step = make_gather_multi_step(models[0], augment=step_augment, device="cpu")
    run = lambda: train_epoch(states[0], None, ds, torch.Generator(), verbose=False,  # noqa: E731
                              gather_step=step, fused_steps=2)
    if step_augment != data_augment:
        with pytest.raises(ValueError, match="augment"):
            run()
    else:
        assert run()[0].step == 4


def test_evaluate_detailed_matches_jax():
    """Percentage accuracy kept beside the detailed metrics; loss, accuracy
    and the confusion matrix as the JAX evaluate's; gather-fused chunks
    (with a tail) as the per-batch loop."""
    jmodel, jstate, _, tmodel, _ = _pair()
    port_ds, jax_ds = _datasets(44, 16)
    want = jax_training.evaluate(jstate, jax_training.make_eval_step(jmodel), jax_ds,
                                 num_classes=10, detailed=True)
    plain = evaluate(make_eval_step(tmodel, device="cpu"), port_ds, num_classes=10,
                     detailed=True)
    fused = evaluate(None, port_ds, num_classes=10, detailed=True,
                     gather_eval=make_gather_multi_eval(tmodel, device="cpu"), fused_steps=2)
    for got in (plain, fused):
        assert got["samples"] == want["samples"] == 44
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["accuracy"] == want["accuracy"] > 1.0  # percent, not a fraction
        assert got["confusion_matrix"] == want["confusion_matrix"]
        assert got["f1_macro"] == pytest.approx(want["f1_macro"], abs=1e-9)
    no_detail = evaluate(make_eval_step(tmodel, device="cpu"), port_ds)
    assert set(no_detail) == {"loss", "accuracy", "samples"}


def test_metrics_match_jax_on_the_same_predictions():
    rng = np.random.default_rng(8)
    preds, labels = rng.integers(0, 7, 200), rng.integers(0, 7, 200)
    for classes in (7, None):
        got = compute_classification_metrics(torch.from_numpy(preds), torch.from_numpy(labels),
                                             classes)
        want = jax_metrics.compute_classification_metrics(preds, labels, classes)
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_allclose(np.asarray(got[key]), np.asarray(value), rtol=1e-12,
                                       err_msg=key)


# ─── timing and the benchmark ───────────────────────────────────────────

def test_timer_waits_for_the_value_it_is_given():
    with Timer() as t:
        value = t.block_on({"x": torch.ones(3), "y": [torch.zeros(2)]})
        assert t.elapsed is None
    assert t.elapsed >= 0 and torch.equal(value["x"], torch.ones(3))


def test_bench_flop_count_matches_a_hand_count():
    """dim 32, 1 block, 2 heads (head dim 16, F = 44), mlp 64, 28x28 at
    patch 7 (16 patches of 49 values, N = 17), 10 classes, batch 2."""
    m = mnist_config(dim=32, depth=1, heads=2, mlp_dim=64, patch_size=7).model
    block = (2 * 17 * 32 * 96          # fused QKV
             + 2 * 2 * 2 * 17 * 16 * 44  # phi's x @ Omega for q and k
             + 2 * 2 * 17 * 17 * 44    # q' k'^T
             + 2 * 2 * 17 * 17 * 16    # W v
             + 2 * 17 * 32 * 32        # output projection
             + 2 * 2 * 17 * 32 * 64)   # MLP
    assert block == 443632
    forward = 2 * (block + 2 * 16 * 49 * 32 + 2 * 32 * 10)
    assert bench_torch.train_flops_per_step(m, 44, 2) == 3 * forward == 2966688


def test_bench_without_gpu_prints_one_error_line():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert "error" in result and "value" not in result and "mfu" not in result
