"""The port's entry points on the CPU: the train and predict CLIs, the
checkpoint, the inference benchmark and the lookups the CLIs import.

The train CLI (`efficient_rpe_vit_torch.experiments.train.main`) runs in
process on a tiny configuration (depth 1, batch 1024, one epoch, the
flagged synthetic MNIST) and is held to the JAX CLI (`experiments/train.py`)
run with the same flags: the metrics' key trees must be equal (the
inference section's keys that depend on the clock and the device,
`clipped_chains` and `peak_memory_bytes`, aside). The predict CLI serves
the train run's checkpoint and must reproduce its evaluation exactly. The
lookups (`get_dataset_config`, `list_available_models`, `get_model_info`,
`model_kwargs_from_metadata`) must return what the JAX package's return.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_rpe_vit_tpu.configs import get_dataset_config as jax_get_dataset_config
from efficient_rpe_vit_tpu.configs import DATASET_CONFIGS as JAX_DATASET_CONFIGS
from efficient_rpe_vit_tpu.models import create_model as jax_create_model
from efficient_rpe_vit_tpu.models import get_model_info as jax_get_model_info
from efficient_rpe_vit_tpu.models.factory import list_available_models as jax_list_models
from efficient_rpe_vit_tpu.train import training as jax_training
from efficient_rpe_vit_tpu.train.checkpoint import (
    model_kwargs_from_metadata as jax_model_kwargs_from_metadata,
)
from efficient_rpe_vit_torch.configs import DATASET_CONFIGS, get_dataset_config, mnist_config
from efficient_rpe_vit_torch.data import visualize_batch
from efficient_rpe_vit_torch.experiments import predict as port_predict
from efficient_rpe_vit_torch.experiments import train as port_train
from efficient_rpe_vit_torch.models import create_model, get_model_info, list_available_models
from efficient_rpe_vit_torch.train import (
    benchmark_inference,
    compute_aggregated_statistics,
    compute_convergence_metrics,
    create_train_state,
    load_checkpoint,
    make_inference_chain,
    make_train_step,
    model_kwargs_from_metadata,
    save_checkpoint,
    set_random_seeds,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
NAME = "performer_favor_most_general"
TINY = ["--dataset", "mnist", "--depth", "1", "--epochs", "1", "--batch-size", "1024",
        "--quiet", "--bench-warmup", "1", "--bench-iters", "2"]
# inference keys that depend on the clock (a chain too short for it) or on a
# device with memory counters
CLOCK_OR_DEVICE_KEYS = {"clipped_chains", "peak_memory_bytes"}


def _train(out, *flags, model=NAME, cpu=True):
    argv = ["--model", model, *TINY, "--output-dir", str(out), *flags]
    return port_train.main(argv + (["--cpu"] if cpu else []))


def _key_tree(value):
    if isinstance(value, dict):
        return {k: _key_tree(v) for k, v in value.items()
                if k not in CLOCK_OR_DEVICE_KEYS}
    if isinstance(value, list) and value and isinstance(value[0], dict):
        return [_key_tree(v) for v in value]
    return None


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One port train run with a checkpoint, detailed eval and plots."""
    out = tmp_path_factory.mktemp("port_train")
    metrics = _train(out, "--save-model", "--eval-detailed", "--save-plots", "--visualize")
    return out, metrics


def test_metrics_key_tree_equals_the_jax_cli(run, tmp_path):
    from experiments.train import main as jax_train_main

    out, metrics = run
    want = jax_train_main(["--model", NAME, *TINY, "--output-dir", str(tmp_path),
                           "--eval-detailed", "--cpu"])
    assert _key_tree(metrics) == _key_tree(want)
    on_disk = json.loads((out / f"{NAME}_mnist_metrics.json").read_text())
    assert _key_tree(on_disk) == _key_tree(want)
    meta = metrics["metadata"]
    assert meta["synthetic_data"] is True and meta["backend"] == "cpu"
    assert meta["config"] == want["metadata"]["config"]
    assert meta["num_parameters"] == want["metadata"]["num_parameters"]
    assert [e["epoch"] for e in metrics["per_epoch"]] == [1]
    assert metrics["aggregate"]["final_test_accuracy"] > 1.0  # percent scale
    for name in (f"{NAME}_mnist_best.pt", f"{NAME}_mnist_best.pt.meta.json",
                 f"{NAME}_mnist_curves.png", "mnist_sample_batch.png"):
        assert (out / name).exists(), name


def test_predict_reproduces_the_train_runs_evaluation(run, tmp_path):
    """The checkpoint's epoch: predict's test accuracy exactly, its loss to
    1e-6 relative (the same weights, split and batches); --input classifies
    a .npy file into --output."""
    out, metrics = run
    ckpt = str(out / f"{NAME}_mnist_best.pt")
    row = metrics["per_epoch"][0]
    result = port_predict.main(["--checkpoint", ckpt, "--cpu"])
    assert result["accuracy"] == row["test_accuracy"]
    assert result["loss"] == pytest.approx(row["test_loss"], rel=1e-6)
    images = np.random.default_rng(0).integers(0, 255, size=(5, 28, 28)).astype(np.uint8)
    np.save(tmp_path / "x.npy", images)
    preds = port_predict.main(["--checkpoint", ckpt, "--cpu", "--input",
                               str(tmp_path / "x.npy"), "--output", str(tmp_path / "p.json")])
    saved = json.loads((tmp_path / "p.json").read_text())
    assert saved["model"] == NAME and saved["predictions"] == preds.tolist()
    assert len(preds) == 5 and all(0 <= p < 10 for p in preds)


def test_resume_from_a_path(run, tmp_path):
    out, _ = run
    metrics = _train(tmp_path, "--resume", str(out / f"{NAME}_mnist_best.pt"),
                     "--epochs", "2")
    assert [e["epoch"] for e in metrics["per_epoch"]] == [2]


def test_resume_auto_finds_the_runs_checkpoint(run):
    out, _ = run
    metrics = _train(out, "--resume", "auto", "--epochs", "2")
    assert [e["epoch"] for e in metrics["per_epoch"]] == [2]


def test_resume_auto_fresh_and_attention_maps(tmp_path):
    """--resume auto with no checkpoint trains from epoch 1; the softmax
    checkpoint it keeps renders attention maps, which linear attention
    refuses."""
    metrics = _train(tmp_path, "--resume", "auto", "--save-model", model="baseline")
    assert [e["epoch"] for e in metrics["per_epoch"]] == [1]
    png = tmp_path / "maps.png"
    port_predict.main(["--checkpoint", str(tmp_path / "baseline_mnist_best.pt"), "--cpu",
                       "--attention-maps", str(png)])
    assert png.exists()


@pytest.mark.parametrize("flags,check", [
    (["--grad-accum", "2", "--ema-decay", "0.9", "--label-smoothing", "0.1",
      "--optimizer", "sgd"], None),
    (["--fused-steps", "3", "--mlp-type", "moe", "--num-experts", "2", "--remat",
      "--num-features", "mxu"], "moe"),
], ids=["accum_ema_smoothing_sgd", "fused_moe_remat_mxu"])
def test_train_cli_options(tmp_path, flags, check):
    metrics = _train(tmp_path, "--save-model", *flags)
    loss = metrics["per_epoch"][0]["train_loss"]
    assert np.isfinite(loss) and 0 < loss < 10
    if check == "moe":
        assert metrics["metadata"]["mlp_type"] == "moe"
        assert metrics["metadata"]["num_experts"] == 2
        meta = json.loads((tmp_path / f"{NAME}_mnist_best.pt.meta.json").read_text())
        kwargs = model_kwargs_from_metadata(meta["metadata"])
        assert kwargs == {"mlp_config": {"mlp_type": "moe", "num_experts": 2},
                          "attention_config": {"num_features": "mxu"}, "depth": 1}
        model = create_model(NAME, mnist_config(), device="cpu", **kwargs)
        assert model.transformer_blocks[0].attention.m == 128
        result = port_predict.main(["--checkpoint", str(tmp_path / f"{NAME}_mnist_best.pt"),
                                    "--cpu"])
        assert result["accuracy"] == metrics["per_epoch"][0]["test_accuracy"]


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "data=2"], "--mesh data=2 needs 2 processes in a process group, have 1"),
    (["--mesh", "data=2,pipe=2", "--grad-accum", "2", "--depth", "4"], "--mesh with a 'pipe' "
     "axis does not compose with --grad-accum"),
    (["--mesh", "data=2,pipe=2", "--label-smoothing", "0.1", "--depth", "4"], "--label-smoothing"),
    (["--mesh", "data=2,pipe=2"], "model depth 3 not divisible by pipe=2 stages"),
    (["--mesh", "pipe=2", "--depth", "4", "--microbatches", "3", "--batch-size", "256"],
     "batch size 256 not divisible by the 3-microbatch GPipe schedule"),
    (["--mesh", "data=2", "--microbatches", "4"], "--microbatches only applies to a --mesh "
     "with a 'pipe' axis"),
    (["--mesh", "data=2", "--fused-steps", "2"], "--fused-steps composes"),
    (["--distributed"], "--distributed: initialize.. without an address reads torchrun"),
    (["--num-processes", "2"], "--num-processes only applies to an explicit --distributed"),
    (["--process-id", "1"], "--process-id only applies to an explicit --distributed"),
    (["--distributed", "--num-processes", "2"], "--num-processes only applies"),
    (["--microbatches", "2"], "--microbatches only applies to a --mesh with a 'pipe' axis"),
    (["--fused-steps", "2", "--grad-accum", "2"], "--fused-steps"),
    (["--model", "baseline", "--num-features", "64"], "--num-features"),
])
def test_train_cli_refusals(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        port_train.main(["--cpu", "--output-dir", str(tmp_path), *argv])


def test_predict_cli_refusals(run):
    out, _ = run
    with pytest.raises(SystemExit, match="softmax"):
        port_predict.main(["--checkpoint", str(out / f"{NAME}_mnist_best.pt"), "--cpu",
                           "--attention-maps", "maps.png"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the run without a GPU")
@pytest.mark.parametrize("module", ["train", "predict"])
def test_cli_without_cpu_flag_needs_a_gpu(module, tmp_path):
    """No --cpu on a machine without a card: a non-zero exit with the
    device resolver's message, never a silent CPU run."""
    argv = ([sys.executable, "-m", f"efficient_rpe_vit_torch.experiments.{module}"]
            + (["--output-dir", str(tmp_path)] if module == "train"
               else ["--checkpoint", str(tmp_path / "none.pt")]))
    done = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert "no CUDA device is available" in done.stderr


# ─── checkpoints ────────────────────────────────────────────────────────

def _trained_state(ema_decay=0.0, seed=0, optimizer="adam"):
    cfg = mnist_config(dim=32, depth=1, heads=2, mlp_dim=64, dropout=0.1,
                       optimizer=optimizer)
    model = create_model(NAME, cfg, device="cpu", generator=torch.Generator().manual_seed(seed),
                         attention_config={"feature_redraw_interval": 2})
    state = create_train_state(model, cfg, ema_decay=ema_decay)
    step = make_train_step(model, device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 28, 28, 1)).astype(np.float32))
    for _ in range(3):
        state, _, _ = step(state, x, torch.arange(4), g)
    return state


def _assert_states_equal(a, b):
    assert a.step == b.step
    for (n, t), u in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(t, u), n
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for key, t in sa[i].items():
            assert torch.equal(torch.as_tensor(t), torch.as_tensor(sb[i][key])), (i, key)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_checkpoint_round_trip_in_place(tmp_path, optimizer):
    """Parameters, Omega, the redraw counters, the optimiser state and the
    step come back into the template's own tensors; the sidecar holds the
    JAX schema."""
    state = _trained_state(optimizer=optimizer)
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, state, epoch=3, metrics={"test_accuracy": 91.0},
                    metadata={"model_name": NAME})
    template = _trained_state(seed=5, optimizer=optimizer)
    template.step = 0
    ptrs = [t.data_ptr() for t in template.model.state_dict().values()]
    opt_ptrs = [t.data_ptr() for s in template.optimizer.state.values()
                for t in s.values() if isinstance(t, torch.Tensor)]
    restored, meta = load_checkpoint(path, template)
    assert restored is template
    assert meta == {"epoch": 3, "metrics": {"test_accuracy": 91.0},
                    "metadata": {"model_name": NAME}}
    _assert_states_equal(restored, state)
    assert [t.data_ptr() for t in restored.model.state_dict().values()] == ptrs
    assert [t.data_ptr() for s in restored.optimizer.state.values()
            for t in s.values() if isinstance(t, torch.Tensor)] == opt_ptrs


def test_ema_checkpoint_round_trip(tmp_path):
    state = _trained_state(ema_decay=0.9)
    path = str(tmp_path / "ema.pt")
    save_checkpoint(path, state, epoch=0)
    assert "ema_params" in torch.load(path, weights_only=True)
    restored, _ = load_checkpoint(path, _trained_state(ema_decay=0.9, seed=7))
    for n, t in state.ema_params.items():
        assert torch.equal(restored.ema_params[n], t), n
    for (n, p), q in zip(restored.eval_view().named_parameters(), state.ema_params.values()):
        assert torch.equal(p, q), n


def test_pre_ema_checkpoint_into_an_ema_state(tmp_path):
    """A checkpoint saved without an EMA loads into a state that tracks one:
    the shadow starts at the restored parameters."""
    state = _trained_state()
    path = str(tmp_path / "pre_ema.pt")
    save_checkpoint(path, state, epoch=0)
    assert "ema_params" not in torch.load(path, weights_only=True)
    restored, _ = load_checkpoint(path, _trained_state(ema_decay=0.99, seed=7))
    for n, p in restored.model.named_parameters():
        assert torch.equal(restored.ema_params[n], p), n
        assert torch.equal(p, dict(state.model.named_parameters())[n]), n


def test_checkpoint_of_another_model_is_refused(tmp_path):
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, _trained_state(), epoch=1)
    cfg = mnist_config(dim=32, depth=2, heads=2, mlp_dim=64)
    other = create_train_state(create_model(NAME, cfg, device="cpu"), cfg)
    with pytest.raises(ValueError, match="does not fit"):
        load_checkpoint(path, other)


@pytest.mark.parametrize("meta", [
    {},
    {"mlp_type": "moe", "num_experts": 8},
    {"mlp_type": "moe", "num_experts": None},
    {"mlp_type": "dense", "num_features": "mxu", "depth": 2},
    {"num_features": "96", "depth": None, "ema_decay": 0.99},
])
def test_model_kwargs_from_metadata_matches_jax(meta):
    assert model_kwargs_from_metadata(meta) == jax_model_kwargs_from_metadata(meta)


# ─── inference benchmark ────────────────────────────────────────────────

@pytest.fixture(scope="module")
def tiny_model():
    cfg = mnist_config(dim=32, depth=1, heads=2, mlp_dim=64)
    return create_model(NAME, cfg, device="cpu")


def test_benchmark_inference_keys_match_jax(tiny_model):
    """Both modes return the JAX function's keys (on the same tiny model),
    with the chain pinned at its base length by target_chain_time=0."""
    images = torch.zeros(8, 28, 28, 1)
    res = benchmark_inference(tiny_model, images, num_warmup=2, num_iterations=6,
                              num_chains=3, target_chain_time=0)
    per_iter = benchmark_inference(tiny_model, images, num_warmup=2, num_iterations=5,
                                   mode="per_iter")
    jcfg = jax_get_dataset_config("mnist", dim=32, depth=1, heads=2, mlp_dim=64)
    jmodel = jax_create_model(NAME, jcfg, rpe_config={"method": "dense"})
    jstate = jax_training.create_train_state(jmodel, jcfg, jax.random.PRNGKey(0),
                                             jnp.zeros((2, 28, 28, 1)))
    jimages = jnp.zeros((8, 28, 28, 1))
    want = jax_training.benchmark_inference(jstate, jmodel, jimages, num_warmup=2,
                                            num_iterations=6, num_chains=3,
                                            target_chain_time=0)
    want_per_iter = jax_training.benchmark_inference(jstate, jmodel, jimages, num_warmup=2,
                                                     num_iterations=5, mode="per_iter")
    assert set(res) - CLOCK_OR_DEVICE_KEYS == set(want) - CLOCK_OR_DEVICE_KEYS
    assert set(per_iter) == set(want_per_iter)
    assert res["mode"] == "chained" and res["chain_length"] == 2
    assert res["num_chains"] == 3 and res["num_iterations"] == 6 and res["batch_size"] == 8
    assert per_iter["mode"] == "per_iter" and per_iter["num_iterations"] == 5
    for r in (res, per_iter):
        assert r["throughput_images_per_sec"] > 0
        assert r["latency_p50_ms"] >= 0 and r["fetch_rt_ms"] > 0


def test_inference_chain_runs_length_forwards(tiny_model):
    """One chain function serves every length, and runs exactly `length`
    data-dependent forwards in eval mode without building a graph."""
    calls = []
    hook = tiny_model.register_forward_hook(lambda m, a, out: calls.append(
        (m.training, out.requires_grad)))
    chain = make_inference_chain(tiny_model)
    images = torch.randn(4, 28, 28, 1, generator=torch.Generator().manual_seed(0))
    for length in (1, 3, 7):
        calls.clear()
        total = chain(images, length)
        assert len(calls) == length and calls[0] == (False, False)
        assert total.shape == () and bool(torch.isfinite(total))
    hook.remove()


def test_benchmark_inference_calibrates_the_chain(tiny_model, monkeypatch):
    """The chain grows from its base length (6 // 3 = 2) until a chain
    takes the 20 ms target. The clock is the calibration's own: each
    forward of the model's chain advances it by 1 ms, so the base chain's
    probe (2 ms) falls below the target however loaded the machine is."""
    from efficient_rpe_vit_torch.train import training

    forward_us = 1000
    now_us = [0]
    chain = make_inference_chain(tiny_model)

    def counted_chain(images, length):
        out = chain(images, length)
        now_us[0] += forward_us * int(length)
        return out

    monkeypatch.setattr(training.time, "perf_counter", lambda: now_us[0] * 1e-6)
    res = benchmark_inference(tiny_model, torch.zeros(8, 28, 28, 1), num_iterations=6,
                              num_chains=3, chain_fn=counted_chain, target_chain_time=0.02)
    assert res["chain_length"] > 2
    assert res["num_iterations"] == 3 * res["chain_length"]


# ─── lookups and helpers ────────────────────────────────────────────────

@pytest.mark.parametrize("name", ["mnist", "cifar10", "CIFAR10"])
def test_get_dataset_config_matches_jax(name):
    overrides = dict(batch_size=None, epochs=3, learning_rate=None, dropout=0.2,
                     optimizer="sgd", compute_dtype=None, seed=5)
    assert (get_dataset_config(name, **overrides).to_dict()
            == jax_get_dataset_config(name, **overrides).to_dict())
    assert sorted(DATASET_CONFIGS) == sorted(JAX_DATASET_CONFIGS)
    with pytest.raises(ValueError, match="Unknown dataset"):
        get_dataset_config("imagenet")


def test_flat_config_views_match_jax():
    from efficient_rpe_vit_tpu.configs import CIFAR10_CONFIG as JAX_CIFAR10
    from efficient_rpe_vit_tpu.configs import MNIST_CONFIG as JAX_MNIST
    from efficient_rpe_vit_torch.configs import CIFAR10_CONFIG, MNIST_CONFIG

    assert MNIST_CONFIG == JAX_MNIST and CIFAR10_CONFIG == JAX_CIFAR10


def test_model_lookups_match_jax():
    assert list_available_models() == jax_list_models()
    for name in list_available_models():
        assert get_model_info(name) == jax_get_model_info(name)
    with pytest.raises(ValueError, match="Unknown model"):
        get_model_info("performer_favor_kerple_v2")


def test_benchmark_utils():
    rng = set_random_seeds(3)
    assert isinstance(rng, np.random.Generator)
    a = torch.rand(3)
    set_random_seeds(3)
    assert torch.equal(torch.rand(3), a)
    conv = compute_convergence_metrics([80.0, 91.0, 95.5, 95.5, 95.55])
    assert conv["epochs_to_90"] == 2 and conv["epochs_to_95"] == 3
    assert conv["epochs_to_99"] is None and conv["plateau_epoch"] == 3
    stats = compute_aggregated_statistics([{"acc": 90.0, "t": 1}, {"acc": 92.0, "t": None}])
    assert stats["num_runs"] == 2 and stats["acc"]["mean"] == 91.0
    assert stats["t"]["values"] == [1.0] and stats["t"]["std"] == 0.0


def test_visualize_batch_needs_matplotlib(tmp_path, monkeypatch):
    images = torch.rand(5, 28, 28, 1)
    labels = torch.arange(5)
    assert visualize_batch(images, labels, str(tmp_path / "b.png")) == str(tmp_path / "b.png")
    assert (tmp_path / "b.png").stat().st_size > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        visualize_batch(images, labels, str(tmp_path / "c.png"))


def _module_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_entry_points_import_neither_jax_nor_matplotlib_at_module_level():
    """The new modules import no JAX (an AST scan, as for the whole port in
    tests/test_torch_models.py) and import matplotlib only inside the
    functions that draw, so they load on a machine without it."""
    port = REPO / "efficient_rpe_vit_torch"
    files = [port / "experiments" / "train.py", port / "experiments" / "predict.py",
             port / "experiments" / "benchmark.py", port / "experiments" / "report.py",
             port / "experiments" / "charts.py", port / "train" / "training.py",
             port / "train" / "checkpoint.py", port / "train" / "benchmark_utils.py",
             port / "data" / "datasets.py", port / "models" / "layers.py",
             port / "serve" / "export.py", port / "experiments" / "export.py",
             port / "experiments" / "serve_bench.py"]
    for f in files:
        roots = set(_module_level_imports(f))
        assert not roots & {"jax", "jaxlib", "flax", "optax", "efficient_rpe_vit_tpu",
                            "matplotlib"}, (f, roots)
