"""The sharded checkpoint backend (`save_checkpoint_sharded` /
`load_checkpoint_sharded`, the counterpart of the JAX
`save_checkpoint_orbax` / `load_checkpoint_orbax`) on the CPU.

  * one process: a round trip is bit for bit (parameters, Omega, the
    optimiser state, the EMA shadow, the step, `meta.json`), as the JAX
    `tests/test_training.py::test_orbax_checkpoint_roundtrip` holds Orbax;
    a checkpoint without an EMA loads into a state with one (shadow :=
    parameters, the JAX pre-EMA fallback); a resumed step equals the
    uninterrupted one;
  * one 2-rank gloo world (`tests/torch_parallel_worker.py`) on data=2
    with FSDP, model=2 and pipe=2 (GPipe): with the whole-model views
    (`full_payload`, `local_payload`, `join_stages`, `select_stage`) made
    to raise, each rank saves; each rank's file holds only pieces of its
    own layout, and the two files hold each byte once; a fresh state of
    the same mesh restores bit for bit and its next step equals the
    uninterrupted one bit for bit;
  * across layouts: the data=2 FSDP and the pipe=2 checkpoints load into
    one process, and one written by one process loads onto model=2, each
    equal bit for bit to what the single-file checkpoint of the same state
    gives;
  * the train CLI's `--checkpoint-backend orbax` with `--resume DIR` and
    `--resume auto`, in one process and saved by two.
"""

import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

from efficient_rpe_vit_torch.configs import mnist_config
from efficient_rpe_vit_torch.models import create_model
from efficient_rpe_vit_torch.train import (
    create_train_state,
    load_checkpoint,
    load_checkpoint_sharded,
    make_train_step,
    save_checkpoint,
    save_checkpoint_sharded,
)

import torch_parallel_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "performer_favor_most_general"
DEPTH = 2
LAYOUTS = {"fsdp": dict(spec="data=2", fsdp=True), "tp": dict(spec="model=2"),
           "pp": dict(spec="pipe=2", pipe=True)}


def _single(seed, ema=0.9):
    cfg = mnist_config(depth=DEPTH, dropout=0.0)
    model = create_model(NAME, cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, cfg, steps_per_epoch=10, ema_decay=ema)
    return state, make_train_step(model, device="cpu")


def _batches():
    rng = np.random.default_rng(4)
    return (rng.normal(size=(2, 8, 28, 28, 1)).astype(np.float32),
            (np.arange(16).reshape(2, 8) % 10).astype(np.int64))


def _trained(seed=1, ema=0.9):
    state, step = _single(seed, ema)
    x, y = _batches()
    state, _, _ = step(state, torch.from_numpy(x[0]), torch.from_numpy(y[0]),
                       torch.Generator().manual_seed(0))
    return state, step


# ─── one process ────────────────────────────────────────────────────────

@pytest.mark.parametrize("ema", [0.0, 0.9])
def test_round_trip_is_bitwise(tmp_path, ema):
    state, _ = _trained(ema=ema)
    path = str(tmp_path / "ckpt_orbax")
    save_checkpoint_sharded(path, state, epoch=3, metrics={"test_accuracy": 88.0},
                            metadata={"model_name": NAME})
    assert {".metadata", "index.json", "meta.json", "__0_0.distcp"} <= set(os.listdir(path))
    fresh, _ = _single(9, ema)
    assert worker._differ(worker.whole_payload(state), worker.whole_payload(fresh))
    fresh, meta = load_checkpoint_sharded(path, fresh)
    assert meta == {"epoch": 3, "metrics": {"test_accuracy": 88.0},
                    "metadata": {"model_name": NAME}}
    assert worker._differ(worker.whole_payload(state), worker.whole_payload(fresh)) == []
    assert fresh.step == 1


@pytest.mark.parametrize("case", ["wider", "deeper", "box_missing"])
def test_a_checkpoint_that_does_not_fit_is_refused(tmp_path, case):
    """A template of another MLP width or depth, or an index that lost one
    of a tensor's boxes, is refused before any saved value is copied."""
    state, _ = _trained()
    path = str(tmp_path / "ckpt_orbax")
    save_checkpoint_sharded(path, state, epoch=1)
    overrides = {"wider": dict(mlp_dim=128), "deeper": dict(depth=DEPTH + 1)}.get(case, {})
    cfg = mnist_config(**{"depth": DEPTH, "dropout": 0.0, **overrides})
    model = create_model(NAME, cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    fresh = create_train_state(model, cfg, steps_per_epoch=10, ema_decay=0.9)
    if case == "box_missing":
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)
        index["model.pos_embedding"]["boxes"] = []
        with open(os.path.join(path, "index.json"), "w") as f:
            json.dump(index, f)
    before = worker.whole_payload(fresh)
    message = {"wider": "shape", "deeper": "holds no", "box_missing": "covers 0"}[case]
    with pytest.raises(ValueError, match=message):
        load_checkpoint_sharded(path, fresh)
    # a fresh Adam's moments are made (zeros) before the checks; no value is copied
    assert [k for k in worker._differ(before, worker.whole_payload(fresh))
            if not k.startswith("optimizer.")] == []


def test_pre_ema_checkpoint_gives_the_shadow_the_parameters(tmp_path):
    state, _ = _trained(ema=0.0)
    path = str(tmp_path / "ckpt_orbax")
    save_checkpoint_sharded(path, state, epoch=1)
    fresh, _ = _single(9, ema=0.9)
    fresh, _ = load_checkpoint_sharded(path, fresh)
    for name, p in fresh.model.named_parameters():
        assert torch.equal(fresh.ema_params[name], p), name
        assert torch.equal(p, dict(state.model.named_parameters())[name]), name


def test_resumed_step_equals_the_uninterrupted_one(tmp_path):
    state, step = _trained()
    path = str(tmp_path / "ckpt_orbax")
    save_checkpoint_sharded(path, state, epoch=1)
    x, y = _batches()
    args = (torch.from_numpy(x[1]), torch.from_numpy(y[1]))
    state, loss, correct = step(state, *args, torch.Generator().manual_seed(1))
    fresh, fresh_step = _single(9)
    fresh, _ = load_checkpoint_sharded(path, fresh)
    fresh, fresh_loss, fresh_correct = fresh_step(fresh, *args, torch.Generator().manual_seed(1))
    assert torch.equal(loss, fresh_loss) and torch.equal(correct, fresh_correct)
    assert worker._differ(worker.whole_payload(state), worker.whole_payload(fresh)) == []


# ─── two ranks ──────────────────────────────────────────────────────────

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    x, y = _batches()
    # a one-process checkpoint, sharded and single-file, for model=2 to load
    state, _ = _trained()
    save_checkpoint_sharded(str(tmp / "single_orbax"), state, epoch=2)
    save_checkpoint(str(tmp / "single.pt"), state, epoch=2)
    cases = [(label, "sharded_checkpoint",
              dict(name=NAME, path=str(tmp / f"{label}_orbax"), single_path=str(tmp / f"{label}.pt"),
                   x=x, y=y, **kw)) for label, kw in LAYOUTS.items()]
    cases.append(("single_into_tp", "sharded_load",
                  dict(spec="model=2", name=NAME, path=str(tmp / "single_orbax"),
                       single_path=str(tmp / "single.pt"))))
    return tmp, worker.run_world(2, cases, tmp / "world")


def _ok(result):
    assert "error" not in result, result.get("error")
    return result


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_same_mesh_restore_is_bitwise(world, layout):
    _, runs = world
    for result in runs[layout]:
        assert _ok(result)["restore_differs"] == []
        assert result["meta"]["metadata"] == {"spec": LAYOUTS[layout]["spec"]}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_resumed_sharded_step_equals_the_uninterrupted_one(world, layout):
    _, runs = world
    for result in runs[layout]:
        assert _ok(result)["resumed_loss"] == result["loss"]
        assert result["resume_differs"] == []


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_each_rank_writes_only_its_parts(world, layout):
    """Every item in rank r's file is a piece of rank r's own layout (keyed
    with its offsets in the full tensor), what both ranks hold is written
    once (the files' tensor bytes add up to the whole payload's), and
    neither rank writes the whole payload."""
    tmp, runs = world
    md = dcp.FileSystemReader(str(tmp / f"{layout}_orbax")).read_metadata()
    written, nbytes = {}, {}
    for index, info in md.storage_data.items():
        key, _, offsets = index.fqn.partition("@")
        item = (key, tuple(int(o) for o in offsets.split(",") if o))
        written.setdefault(info.relative_path, []).append(item)
        tensor = md.state_dict_metadata[index.fqn]
        nbytes[info.relative_path] = (nbytes.get(info.relative_path, 0)
                                      + math.prod(tensor.size) * tensor.properties.dtype.itemsize)
    assert sorted(written) == ["__0_0.distcp", "__1_0.distcp"]
    whole = sum(math.prod(t.size) * t.properties.dtype.itemsize
                for t in md.state_dict_metadata.values())
    assert sum(nbytes.values()) == whole
    for rank, result in enumerate(runs[layout]):
        own = {(k, off) for k, off in _ok(result)["pieces"]}
        items = written[f"__{rank}_0.distcp"]
        assert all(item in own for item in items if item[0] != "step"), \
            sorted(set(items) - own)[:5]
        assert nbytes[f"__{rank}_0.distcp"] < (0.6 if layout == "fsdp" else 1.0) * whole
    all_items = [item for items in written.values() for item in items]
    assert len(all_items) == len(set(all_items))


@pytest.mark.parametrize("layout", ["fsdp", "pp"])
def test_mesh_checkpoint_loads_in_one_process(world, layout):
    """Written on data=2 with FSDP or on pipe=2, read by one process: equal
    bit for bit to the single-file checkpoint of the same state."""
    tmp, runs = world
    _ok(runs[layout][0])
    a, _ = _single(3)
    a, meta = load_checkpoint_sharded(str(tmp / f"{layout}_orbax"), a)
    b, _ = _single(4)
    b, _ = load_checkpoint(str(tmp / f"{layout}.pt"), b)
    assert meta["epoch"] == 1
    assert worker._differ(worker.whole_payload(a), worker.whole_payload(b)) == []


def test_one_process_checkpoint_loads_on_model2(world):
    _, runs = world
    for result in runs["single_into_tp"]:
        assert _ok(result)["differs"] == [] and result["step"] == 1
        assert result["meta"]["epoch"] == 2


# ─── the train CLI ──────────────────────────────────────────────────────

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CLI = ["--model", NAME, "--dataset", "mnist", "--batch-size", "1024", "--depth", "1",
       "--bench-warmup", "1", "--bench-iters", "2", "--cpu", "--quiet"]


def test_train_cli_orbax_backend_and_resume(tmp_path):
    """--checkpoint-backend orbax writes a sharded directory that --resume
    DIR takes (a directory: the sharded loader) and --resume auto finds;
    the port of the JAX `tests/test_cli.py::test_train_cli_orbax_backend_and_resume`."""
    from efficient_rpe_vit_torch.experiments import train as port_train

    out = str(tmp_path)
    port_train.main([*CLI, "--epochs", "1", "--output-dir", out, "--save-model",
                     "--checkpoint-backend", "orbax"])
    ckpt = os.path.join(out, f"{NAME}_mnist_best_orbax")
    assert os.path.isdir(ckpt) and os.path.exists(os.path.join(ckpt, "meta.json"))
    assert not os.path.exists(os.path.join(out, f"{NAME}_mnist_best.pt"))
    metrics = port_train.main([*CLI, "--epochs", "2", "--output-dir", out, "--resume", ckpt])
    # resumed at epoch 2: exactly one new epoch trained
    assert [e["epoch"] for e in metrics["per_epoch"]] == [2]
    metrics = port_train.main([*CLI, "--epochs", "2", "--output-dir", out,
                               "--checkpoint-backend", "orbax", "--resume", "auto"])
    assert [e["epoch"] for e in metrics["per_epoch"]] == [2]


def test_train_cli_orbax_on_two_processes_resumes_in_one(tmp_path):
    """Under --distributed on data=2 every rank saves its part of the
    directory (each rank writes a file); one process resumes from it."""
    from efficient_rpe_vit_torch.experiments import train as port_train

    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    argv = [*CLI, "--epochs", "1", "--batch-size", "512",
            "--output-dir", str(tmp_path), "--save-model", "--checkpoint-backend", "orbax"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "efficient_rpe_vit_torch.experiments.train", *argv,
         "--mesh", "data=2", "--distributed", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(rank)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    ckpt = tmp_path / f"{NAME}_mnist_best_orbax"
    assert {"__0_0.distcp", "__1_0.distcp", "meta.json"} <= set(os.listdir(ckpt))
    metrics = port_train.main([*argv, "--epochs", "2", "--resume", "auto"])
    assert [e["epoch"] for e in metrics["per_epoch"]] == [2]
