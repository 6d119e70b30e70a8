"""The port's benchmark runner and static report on the CPU.

`efficient_rpe_vit_torch.experiments.benchmark.main` runs in process with
`--cpu --batch-size 128 --epochs 1` (depth 1, K = 4 steps per call, the
flagged synthetic MNIST), as the JAX CLI tests run the JAX runner: the
summary and the files it writes, `--skip-existing` per seed and, under
`--ensemble`, all or nothing, the refusals, unknown models, the train
CLI's `shared` reuse (a later seed equal to its run without it), one run
in a subprocess, and the results tree against a JAX benchmark run's (1
model x 1 seed x 1 epoch, the same flags): the per-seed metrics JSON,
`aggregated_stats.json` and `benchmark_config.json` key trees must be equal
(the inference keys that depend on the clock or the device aside; an
ensemble run adds `metadata.ensemble_size` and
`aggregate.time_is_shared_ensemble_wall`). Both the port's `build_report`
and the JAX `experiments/report.build_report` render the port's tree.
Ensemble members must equal the sequential runs of their seeds bit for bit.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

from efficient_rpe_vit_torch.experiments import benchmark
from efficient_rpe_vit_torch.experiments import report as port_report
from efficient_rpe_vit_torch.experiments import train as port_train

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
NAME = "performer_favor_most_general"
SEEDS = (42, 153)
FLAGS = ["--dataset", "mnist", "--epochs", "1", "--batch-size", "128", "--depth", "1",
         "--fused-steps", "4", "--quiet"]
PORT = ["--models", NAME, "--num-runs", "2", *FLAGS, "--cpu"]
METRIC_KEYS = ("epoch", "train_loss", "train_accuracy", "test_loss", "test_accuracy")
# inference keys that depend on the clock (a chain too short for it) or on a
# device with memory counters
CLOCK_OR_DEVICE_KEYS = {"clipped_chains", "peak_memory_bytes"}
ENSEMBLE_KEYS = {"metadata": "ensemble_size", "aggregate": "time_is_shared_ensemble_wall"}


def _key_tree(value):
    if isinstance(value, dict):
        return {k: _key_tree(v) for k, v in value.items() if k not in CLOCK_OR_DEVICE_KEYS}
    if isinstance(value, list) and value and isinstance(value[0], dict):
        return [_key_tree(v) for v in value]
    return None


def _run_json(out, i, seed=None, model=NAME):
    seed = SEEDS[i] if seed is None else seed
    return json.loads((Path(out) / model / f"run_{i}_seed_{seed}" /
                       f"{model}_mnist_metrics.json").read_text())


def _metrics_rows(metrics):
    return [[row[k] for k in METRIC_KEYS] for row in metrics["per_epoch"]]


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench_seq")
    return out, benchmark.main(PORT + ["--output-dir", str(out)])


@pytest.fixture(scope="module")
def ens(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench_ens")
    return out, benchmark.main(PORT + ["--output-dir", str(out), "--ensemble"])


def test_summary_and_files(seq):
    out, summary = seq
    assert list(summary) == [NAME] and summary[NAME]["num_runs"] == 2
    assert summary[NAME]["test_accuracy"]["values"] == [
        _run_json(out, i)["aggregate"]["final_test_accuracy"] for i in range(2)]
    config = json.loads((out / "benchmark_config.json").read_text())
    assert config["models"] == [NAME] and config["seeds"] == list(SEEDS)
    assert config["ensemble"] is False and config["fused_steps"] == 4
    agg = json.loads((out / NAME / "aggregated_stats.json").read_text())
    assert agg == summary[NAME] and "CUDA events" in agg["measurement_note"]
    for i, seed in enumerate(SEEDS):
        run = _run_json(out, i)
        meta = run["metadata"]
        assert (meta["seed"], meta["backend"], meta["synthetic_data"]) == (seed, "cpu", True)
        assert meta["config"]["seed"] == seed and [r["epoch"] for r in run["per_epoch"]] == [1]
    assert _metrics_rows(_run_json(out, 0)) != _metrics_rows(_run_json(out, 1))


def test_key_trees_equal_a_jax_benchmark_run(seq, ens, tmp_path):
    from experiments.benchmark import main as jax_benchmark_main

    jax_out = tmp_path / "jax"
    jax_benchmark_main(["--models", NAME, "--num-runs", "1", *FLAGS,
                        "--output-dir", str(jax_out)])
    want = _key_tree(_run_json(jax_out, 0))
    (out, _), (ens_out, _) = seq, ens
    assert _key_tree(_run_json(out, 1)) == want
    ensemble_run = _key_tree(_run_json(ens_out, 1))
    for section, key in ENSEMBLE_KEYS.items():
        assert key in ensemble_run[section]
        del ensemble_run[section][key]
    assert ensemble_run == want
    agg = f"{NAME}/aggregated_stats.json"
    assert _key_tree(json.loads((out / agg).read_text())) == _key_tree(
        json.loads((jax_out / agg).read_text()))
    config_keys = set(json.loads((jax_out / "benchmark_config.json").read_text()))
    assert set(json.loads((out / "benchmark_config.json").read_text())) == config_keys


def test_skip_existing_keeps_each_seeds_run(seq, tmp_path, capsys):
    out = tmp_path / "bench"
    shutil.copytree(seq[0], out)
    kept = (out / NAME / "run_0_seed_42" / f"{NAME}_mnist_metrics.json").read_text()
    redo = out / NAME / "run_1_seed_153" / f"{NAME}_mnist_metrics.json"
    redo.unlink()
    capsys.readouterr()
    summary = benchmark.main(PORT + ["--output-dir", str(out), "--skip-existing"])
    printed = capsys.readouterr().out
    assert f"[skip-existing] {NAME} seed 42" in printed
    assert f"[skip-existing] {NAME} seed 153" not in printed
    assert summary[NAME]["num_runs"] == 2 and redo.exists()
    assert (out / NAME / "run_0_seed_42" / f"{NAME}_mnist_metrics.json").read_text() == kept
    assert _metrics_rows(json.loads(redo.read_text())) == _metrics_rows(_run_json(seq[0], 1))


def test_ensemble_members_are_the_sequential_runs(seq, ens):
    """Each member of the ensemble run equals the sequential run of its
    seed (the same init, generator and data order, K = 4): every per-epoch
    metric bit for bit; the two members differ, and share the wall time."""
    (out, _), (ens_out, summary) = seq, ens
    assert summary[NAME]["num_runs"] == 2
    assert "Ensemble mode" in summary[NAME]["measurement_note"]
    runs = [_run_json(ens_out, i) for i in range(2)]
    for i, run in enumerate(runs):
        assert run["metadata"]["ensemble_size"] == 2 and run["metadata"]["seed"] == SEEDS[i]
        assert run["aggregate"]["time_is_shared_ensemble_wall"] is True
        assert run["inference"]["mode"] == "chained"
        assert _metrics_rows(run) == _metrics_rows(_run_json(out, i))
    assert runs[0]["aggregate"]["total_train_time"] == runs[1]["aggregate"]["total_train_time"]
    assert _metrics_rows(runs[0]) != _metrics_rows(runs[1])


def test_ensemble_skip_existing_is_all_or_nothing(ens, tmp_path, capsys):
    out = tmp_path / "bench"
    shutil.copytree(ens[0], out)
    argv = PORT + ["--output-dir", str(out), "--ensemble", "--skip-existing"]
    first = (out / NAME / "run_0_seed_42" / f"{NAME}_mnist_metrics.json")
    before = first.read_text()
    capsys.readouterr()
    assert benchmark.main(argv)[NAME]["num_runs"] == 2
    assert f"[skip-existing] {NAME} (ensemble, all seeds)" in capsys.readouterr().out
    assert first.read_text() == before
    (out / NAME / "run_1_seed_153" / f"{NAME}_mnist_metrics.json").unlink()
    assert benchmark.main(argv)[NAME]["num_runs"] == 2
    assert "[skip-existing]" not in capsys.readouterr().out
    rerun = json.loads(first.read_text())
    assert rerun["aggregate"]["total_train_time"] != json.loads(before)["aggregate"][
        "total_train_time"]  # seed 42 trained again, with seed 153
    assert _metrics_rows(rerun) == _metrics_rows(json.loads(before))


@pytest.mark.parametrize("flags,message", [
    (["--ensemble", "--subprocess"], "--subprocess"),
    (["--ensemble", "--grad-accum", "2"], "--grad-accum"),
    (["--ensemble", "--remat"], "--remat"),
    (["--ensemble", "--mesh", "data=2"], "--mesh"),
    (["--ensemble", "--microbatches", "2"], "--microbatches"),
    (["--mesh", "data=2"], "--mesh data=2 needs 2 processes, the runner has 1"),
    (["--mesh", "data=2,pipe=2", "--subprocess"], "--subprocess does not compose with --mesh"),
    (["--microbatches", "2"], "--microbatches only applies to a --mesh with a 'pipe' axis"),
    (["--num-processes", "2"], "--num-processes only applies to an explicit --distributed"),
])
def test_refusals(flags, message, tmp_path):
    with pytest.raises(SystemExit, match=message):
        benchmark.main(PORT + ["--output-dir", str(tmp_path / "b"), *flags])
    assert not (tmp_path / "b").exists()


def test_unknown_model_and_fused_steps_below_one(tmp_path, capsys):
    with pytest.raises(SystemExit, match="Unknown model"):
        benchmark.main(["--models", "not_a_model", "--output-dir", str(tmp_path), "--cpu"])
    args = benchmark.parse_args(PORT + ["--ensemble", "--fused-steps", "0"])
    with pytest.raises(ValueError, match="fused-steps"):
        benchmark.run_ensemble_benchmark(NAME, list(SEEDS), str(tmp_path), args)
    summary = benchmark.main(PORT + ["--ensemble", "--fused-steps", "0",
                                     "--output-dir", str(tmp_path / "b")])
    assert summary == {} and f"[ERROR] {NAME} ensemble" in capsys.readouterr().out


def test_shared_run_equals_a_fresh_run(tmp_path):
    """The second seed of a `shared` dict reuses the first's datasets, state
    (its tensors in place) and steps, and computes what it computes alone."""
    argv = ["--model", NAME, *FLAGS, "--cpu", "--ema-decay", "0.9"]
    shared = {}
    port_train.main(argv + ["--seed", "42", "--output-dir", str(tmp_path / "a")], shared=shared)
    state = shared["state"]
    addresses = [p.data_ptr() for p in state.model.parameters()]
    reused = port_train.main(argv + ["--seed", "153", "--output-dir", str(tmp_path / "b")],
                             shared=shared)
    assert shared["state"] is state
    assert [p.data_ptr() for p in state.model.parameters()] == addresses
    fresh = port_train.main(argv + ["--seed", "153", "--output-dir", str(tmp_path / "c")])
    assert _metrics_rows(reused) == _metrics_rows(fresh)
    for key in ("final_test_accuracy", "final_test_loss", "final_train_loss"):
        assert reused["aggregate"][key] == fresh["aggregate"][key]


def test_subprocess_runs(tmp_path):
    out = tmp_path / "bench"
    summary = benchmark.main(["--models", NAME, "--num-runs", "1", *FLAGS, "--cpu",
                              "--subprocess", "--output-dir", str(out)])
    assert summary[NAME]["num_runs"] == 1
    assert _run_json(out, 0)["metadata"]["backend"] == "cpu"
    args = benchmark.parse_args(["--models", "baseline", *FLAGS, "--cpu", "--subprocess",
                                 "--num-features", "8"])
    with pytest.raises(RuntimeError, match="rc=1(.|\n)*--num-features"):
        benchmark.run_single_training("baseline", 42, str(tmp_path / "fail"), args)


def test_reports_render_the_ports_tree(seq, tmp_path, monkeypatch):
    from experiments.report import build_report as jax_build_report

    out = tmp_path / "bench"
    shutil.copytree(seq[0], out)
    html = Path(port_report.build_report(str(out))).read_text()
    assert NAME in html and html.count("data:image/png;base64") == 5
    html = Path(jax_build_report(str(out))).read_text()
    assert NAME in html and "data:image/png;base64" in html
    data = port_report.load_benchmark_data(str(out))
    assert [r["num_runs"] for r in port_report.create_summary_table(data)] == [2]
    assert len(port_report.accuracy_percentiles(data["models"][NAME]["runs"])["runs"]) == 2
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        port_report.build_report(str(out))
