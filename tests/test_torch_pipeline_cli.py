"""The GPipe pipeline through the port's entry points, on the CPU.

  * the train CLI as four processes on `--mesh data=2,pipe=2` (`--distributed
    127.0.0.1:<port>`, depth 2, M = 4), the counterpart of the JAX
    package's tests/test_cli.py::test_train_cli_pipeline_mesh: it records
    the mesh, the whole model's parameter count and, at dropout 0, the
    single-process CLI's per-epoch losses to 1e-4 relative (the microbatch
    split changes the order of the sums, and an epoch of Adam steps carries
    it) and accuracies to within 0.5 points; its checkpoint is the whole
    model, which the predict CLI serves at the checkpointed epoch's test
    accuracy;
  * the benchmark runner as four processes with `--mesh` and
    `--microbatches`, which it forwards to each run; on two gloo ranks
    with its runs faked, the ranks decide together: `--skip-existing`
    takes the coordinator's files, and a run that fails on one rank stops
    the runner on both;
  * the multi-rank dry run (`parallel/dryrun.py`) at N = 4.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

from efficient_rpe_vit_torch.experiments import benchmark
from efficient_rpe_vit_torch.experiments import predict as port_predict
from efficient_rpe_vit_torch.experiments import train as port_train

import torch_parallel_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "performer_favor_most_general"
MESH = "data=2,pipe=2"
CLI = ["--model", NAME, "--epochs", "1", "--dropout", "0", "--batch-size", "256",
       "--depth", "2", "--bench-warmup", "1", "--bench-iters", "2", "--quiet", "--cpu"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(module, argv, n=4, timeout=300):
    """`python -m module *argv` as n processes joined on a free port."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "--distributed", f"127.0.0.1:{port}",
         "--num-processes", str(n), "--process-id", str(rank)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(n)]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * n, outs
    return outs


def test_train_cli_pipeline_mesh(tmp_path):
    _ranks("efficient_rpe_vit_torch.experiments.train",
           [*CLI, "--output-dir", str(tmp_path / "mesh"), "--mesh", MESH,
            "--microbatches", "4", "--save-model"])
    single = port_train.main([*CLI, "--output-dir", str(tmp_path / "one")])
    files = list((tmp_path / "mesh").glob("*_metrics.json"))
    assert len(files) == 1  # the coordinator alone writes
    mesh = json.loads(files[0].read_text())
    assert mesh["metadata"]["mesh"] == MESH
    assert mesh["metadata"]["num_parameters"] == single["metadata"]["num_parameters"]
    assert mesh["aggregate"]["final_test_accuracy"] > 1.0
    for got, want in zip(mesh["per_epoch"], single["per_epoch"], strict=True):
        for key in ("train_loss", "test_loss"):
            assert got[key] == pytest.approx(want[key], rel=1e-4), key
        for key in ("train_accuracy", "test_accuracy"):
            assert got[key] == pytest.approx(want[key], abs=0.5), key
    served = port_predict.main(["--checkpoint", str(tmp_path / "mesh" / f"{NAME}_mnist_best.pt"),
                                "--cpu"])
    assert served["accuracy"] == pytest.approx(mesh["per_epoch"][0]["test_accuracy"], abs=1e-9)


def test_benchmark_runner_forwards_the_mesh(tmp_path):
    args = benchmark.parse_args(["--models", NAME, "--mesh", MESH, "--microbatches", "4",
                                 "--distributed", "--cpu"])
    cli = benchmark.train_cli_args(NAME, 42, str(tmp_path), args)
    assert cli[cli.index("--mesh") + 1] == MESH
    assert cli[cli.index("--microbatches") + 1] == "4"
    assert "--distributed" in cli
    out = tmp_path / "bench"
    _ranks("efficient_rpe_vit_torch.experiments.benchmark",
           ["--models", NAME, "--num-runs", "1", "--epochs", "1", "--batch-size", "256",
            "--depth", "2", "--mesh", MESH, "--microbatches", "4", "--cpu", "--quiet",
            "--output-dir", str(out)])
    run = json.loads((out / NAME / "run_0_seed_42" / f"{NAME}_mnist_metrics.json").read_text())
    assert run["metadata"]["mesh"] == MESH
    stats = json.loads((out / NAME / "aggregated_stats.json").read_text())
    assert stats["num_runs"] == 1
    assert json.loads((out / "benchmark_config.json").read_text())["microbatches"] == 4


@pytest.fixture(scope="module")
def runner_world(tmp_path_factory):
    """One 2-rank world: the runner skipping, then failing (last, since a
    failure breaks the world's process group)."""
    tmp = tmp_path_factory.mktemp("runner")
    return worker.run_world(2, [
        ("skip", "runner_ranks", dict(out=str(tmp / "skip"), skip_existing=True)),
        ("fail", "runner_ranks", dict(out=str(tmp / "fail"), fail_rank=1))], tmp / "world")


def test_runner_ranks_skip_together(runner_world):
    """Only the coordinator finds seed 42's metrics: both ranks skip it and
    run seed 153 together."""
    for r in runner_world["skip"]:
        assert r == {"num_runs": 2, "calls": [153]}, r


def test_runner_stops_every_rank_when_one_fails(runner_world):
    """Rank 1's run raises while rank 0's waits in its collective: the
    runner re-raises on rank 1, rank 0's collective fails, and neither
    goes on to the next seed out of step."""
    first, second = runner_world["fail"]
    assert first["calls"] == [42] and second["calls"] == [42], runner_world["fail"]
    assert second["raised"] == "ValueError: rank 1 failed"
    assert first["raised"].startswith("RuntimeError"), first


def test_dryrun_on_four_ranks():
    from efficient_rpe_vit_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4)
