"""The port's parallel layer against itself on the CPU: gloo worlds of two
ranks (`tests/torch_parallel_worker.py`) held to the single-process port,
and the train CLI run as two processes.

  * the multihost helpers (`process_count`, `is_coordinator`,
    `host_batch_slice` and its ragged refusal, `broadcast_scalar`,
    `sync`, `global_batch`, a second `initialize` as a no-op);
  * `grad_accum` = 2 against the plain sharded step (loss to 1e-6,
    parameters to atol 1e-6); `make_parallel_multi_step` against K calls
    of the step (bitwise: on the CPU it is that loop); `parallel_train_epoch`
    per batch and fused against the single-process `train_epoch` (loss to
    rtol 1e-5, counts exactly, parameters to atol 1e-5);
  * a tensor-parallel feature redraw equals the single-process redraw's
    heads bit for bit, and the step's loss the single-process loss;
  * FSDP: each rank's bytes of parameters, Adam moments and EMA shadow at
    rest are at most half the replicated run's plus the padding;
  * the EMA shadow under a mesh equals the single-process one (atol 1e-6);
  * with dropout 0.1, the DP and TP steps of a linear-attention model
    equal the single-process steps (loss to 1e-6, parameters to atol 1e-5):
    every rank's masks are its part of the single-process masks;
  * a checkpoint saved under data=2 with FSDP resumes in one process (the
    whole model equal), and one saved in one process loads under model=2
    (model and moments equal, bitwise) and trains on;
  * the train CLI as two processes (`--mesh data=2 --distributed
    127.0.0.1:<port>`) gives the single-process CLI's per-epoch metrics
    (losses to 1e-5 relative, accuracies exactly);
  * the refusals of the parallel layer.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from efficient_rpe_vit_torch.configs import mnist_config
from efficient_rpe_vit_torch.data.pipeline import DeviceDataset
from efficient_rpe_vit_torch.experiments import train as port_train
from efficient_rpe_vit_torch.models import create_model
from efficient_rpe_vit_torch.train import (
    create_train_state,
    load_checkpoint,
    make_train_step,
    save_checkpoint,
    train_epoch,
)

import torch_parallel_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH = 2


def _cfg(**kw):
    kw.setdefault("dropout", 0.0)
    return mnist_config(depth=DEPTH, **kw)


def _batches(k=3, b=8, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, b, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(k, b)).astype(np.int64)
    return x, y


def _data(n=96, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 28, 28, 1), dtype=np.uint8),
            rng.integers(0, 10, n).astype(np.int64))


def _single(name, x, y, steps=1, ema=0.0, attention=None, **cfg):
    """The single-process port: losses, the state after the steps."""
    model = create_model(name, _cfg(**cfg), attention_config=attention, device="cpu")
    state = create_train_state(model, _cfg(**cfg), steps_per_epoch=10, ema_decay=ema)
    step = make_train_step(model, device="cpu")
    gen = torch.Generator().manual_seed(0)
    losses = []
    for i in range(steps):
        state, loss, _ = step(state, torch.from_numpy(x[i]), torch.from_numpy(y[i]), gen)
        losses.append(float(loss))
    return losses, state


def _sd(model):
    return {n: t.detach().float().numpy() for n, t in model.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    x, y = _batches()
    images, labels = _data()
    # a single-process checkpoint for the ranks to load
    _, state = _single("performer_favor_most_general", x, y, ema=0.9)
    single_ckpt = str(tmp / "single.pt")
    save_checkpoint(single_ckpt, state, epoch=3)
    mesh_ckpt = str(tmp / "mesh.pt")
    cases = [
        ("mh", "multihost", dict(batch=8)),
        ("accum1", "step", dict(spec="data=2", name="performer_favor", x=x, y=y)),
        ("accum2", "step", dict(spec="data=2", name="performer_favor", x=x, y=y, accum=2)),
        ("multi", "multistep", dict(spec="data=2", name="performer_favor_most_general",
                                    x=x, y=y)),
        ("epoch", "epoch", dict(spec="data=2", name="baseline", images=images,
                                labels=labels)),
        ("epoch_fused", "epoch", dict(spec="data=2", name="baseline", images=images,
                                      labels=labels, fused_steps=4)),
        ("redraw", "redraw", dict(spec="model=2", name="performer_favor", x=x, y=y)),
        ("bytes", "state_bytes", dict(spec="data=2", name="baseline", fsdp=False,
                                      x=x[0], y=y[0])),
        ("bytes_fsdp", "state_bytes", dict(spec="data=2", name="baseline", fsdp=True,
                                           x=x[0], y=y[0])),
        ("ema", "step", dict(spec="data=2", name="performer_favor", x=x, y=y, ema=0.9,
                             steps=2)),
        ("ckpt_save", "checkpoint_save", dict(spec="data=2", name="performer_favor_most_general",
                                              path=mesh_ckpt, x=x[0], y=y[0], fsdp=True,
                                              ema=0.9)),
        ("ckpt_load", "checkpoint_load", dict(spec="model=2", name="performer_favor_most_general",
                                              path=single_ckpt, x=x[1], y=y[1], ema=0.9)),
        ("refusals", "refusals", dict(name="performer_favor")),
        ("dp_dropout", "step", dict(spec="data=2", name="performer_favor", x=x, y=y,
                                    steps=2, dropout=0.1)),
        ("tp_dropout", "step", dict(spec="model=2", name="performer_favor", x=x, y=y,
                                    steps=2, dropout=0.1)),
    ]
    return worker.run_world(2, cases, tmp / "world"), dict(x=x, y=y, images=images,
                                                          labels=labels, single=single_ckpt,
                                                          mesh=mesh_ckpt)


def _ok(results):
    for r in results:
        assert "error" not in r, r["error"]
    return results


def test_multihost_helpers(runs):
    port, _ = runs
    for rank, r in enumerate(_ok(port["mh"])):
        assert (r["count"], r["index"], r["coordinator"]) == (2, rank, rank == 0)
        assert r["rows"] == r["mesh_rows"] == slice(4 * rank, 4 * rank + 4)
        assert r["seed"] == 1234
        assert "not divisible by 2" in r["ragged"]
        assert r["global_batch"] == ("Tensor", "cpu")


def test_grad_accum_matches_the_plain_step(runs):
    port, _ = runs
    one, two = _ok(port["accum1"])[0], _ok(port["accum2"])[0]
    assert one["loss"][0] == pytest.approx(two["loss"][0], abs=1e-6)
    assert one["correct"] == two["correct"]
    for n, p in one["params"].items():
        np.testing.assert_allclose(two["params"][n], p, atol=1e-6, rtol=0, err_msg=n)


def test_multi_step_equals_k_steps(runs):
    port, _ = runs
    for looped, fused in _ok(port["multi"]):
        assert fused["losses"] == looped["losses"] and fused["step"] == looped["step"] == 3
        for n, p in looped["params"].items():
            np.testing.assert_array_equal(fused["params"][n], p, err_msg=n)


@pytest.mark.parametrize("case,fused", [("epoch", 1), ("epoch_fused", 4)])
def test_parallel_epoch_matches_single_process(runs, case, fused):
    port, data = runs
    model = create_model("baseline", _cfg(), device="cpu")
    ds = DeviceDataset(data["images"], data["labels"], (0.1307,), (0.3081,), 16, shuffle=True,
                       drop_last=True, seed=0, device="cpu")
    state = create_train_state(model, _cfg(), steps_per_epoch=len(ds))
    state, metrics = train_epoch(state, make_train_step(model, device="cpu"), ds,
                                 torch.Generator().manual_seed(0), verbose=False)
    want = _sd(model)
    for r in _ok(port[case]):
        got = r["metrics"]
        assert got["samples"] == metrics["samples"] == 96
        assert got["accuracy"] == metrics["accuracy"]
        assert got["loss"] == pytest.approx(metrics["loss"], rel=1e-5)
        for n, p in r["params"].items():
            np.testing.assert_allclose(p, want[n], atol=1e-5, rtol=0, err_msg=n)


@pytest.mark.parametrize("shape", [(4096,), (6, 5), (4, 3, 8)])
def test_dropout_mask_is_a_part_of_the_whole_draw(shape):
    """A Dropout keeps its input's shape (a 1-D input too), draws the
    single-process mask alone, and under `batch_shard` / `shard` the part of
    the whole batch's and width's draw that the rank holds."""
    from efficient_rpe_vit_torch.models.dense import Dropout, batch_shard

    drop = Dropout(0.5).train()
    x = torch.ones(shape)
    alone = drop(x, torch.Generator().manual_seed(1))
    whole = torch.rand(shape, generator=torch.Generator().manual_seed(1)) < 0.5
    assert alone.shape == x.shape and torch.equal(alone != 0, whole)
    if len(shape) < 2:
        return
    big = list(shape)
    big[0] *= 2
    big[-1] *= 3
    whole = torch.rand(big, generator=torch.Generator().manual_seed(1)) < 0.5
    drop.shard = (2, 3)
    with batch_shard(1, 2):
        part = drop(x, torch.Generator().manual_seed(1))
    rows, cols = shape[0], shape[-1]
    assert torch.equal(part != 0, whole[rows:, ..., 2 * cols:])


@pytest.mark.parametrize("case", ["dp_dropout", "tp_dropout"])
def test_dropout_masks_are_the_single_process_masks(runs, case):
    """With dropout live, each rank draws the whole batch's and width's
    masks from the generator every rank shares and keeps its part, so a
    model without the flash kernel's seed (linear attention) trains as the
    single process does, up to summation order (the losses to 1e-6; the
    parameters after two Adam steps to atol 1e-5, the JAX package's DP
    tolerance: Adam's division by the root of the second moment can move
    an element whose gradient is near zero by ~1e-6 on a rounding
    difference)."""
    port, data = runs
    losses, state = _single("performer_favor", data["x"], data["y"], steps=2, dropout=0.1)
    want = _sd(state.model)
    for r in _ok(port[case]):
        np.testing.assert_allclose(r["loss"], losses, rtol=1e-6)
        for n, p in r["params"].items():
            np.testing.assert_allclose(p, want[n], atol=1e-5, rtol=0, err_msg=n)


def test_tensor_parallel_redraw_equals_the_single_process_heads(runs):
    port, data = runs
    _, state = _single("performer_favor", data["x"], data["y"],
                       attention={"feature_redraw_interval": 1})
    want = _sd(state.model)
    for r in _ok(port["redraw"]):
        assert len(r["omega"]) == DEPTH
        for n, omega in r["omega"].items():
            assert omega.shape == want[n].shape == (2, 16, 44)
            np.testing.assert_array_equal(omega, want[n], err_msg=n)


def test_fsdp_shrinks_the_state_per_rank(runs):
    port, _ = runs
    model = create_model("baseline", _cfg(), device="cpu")
    n_leaves = len(list(model.parameters()))
    padding = 4 * n_leaves * 1 * 4  # 4 kinds of state, up to P-1 = 1 padded float each
    replicated = [r["bytes"] for r in _ok(port["bytes"])]
    for r in _ok(port["bytes_fsdp"]):
        assert r["bytes"] <= replicated[0] / 2 + padding, (r["bytes"], replicated)
        assert r["bytes"] > 0.4 * replicated[0] / 2


def test_ema_under_a_mesh_equals_the_single_process_ema(runs):
    port, data = runs
    losses, state = _single("performer_favor", data["x"], data["y"], steps=2, ema=0.9)
    for r in _ok(port["ema"]):
        np.testing.assert_allclose(r["loss"], losses, rtol=1e-6)
        for n, e in state.ema_params.items():
            np.testing.assert_allclose(r["ema"][n], e.numpy(), atol=1e-6, rtol=0, err_msg=n)


def test_checkpoint_saved_under_a_mesh_resumes_in_one_process(runs):
    port, data = runs
    saved = _ok(port["ckpt_save"])
    assert saved[0]["exists"]
    model = create_model("performer_favor_most_general", _cfg(), device="cpu")
    state = create_train_state(model, _cfg(), steps_per_epoch=10, ema_decay=0.9)
    state, meta = load_checkpoint(data["mesh"], state)
    assert meta["epoch"] == 1 and state.step == 1
    for n, t in _sd(model).items():
        np.testing.assert_array_equal(t, saved[0]["params"][n], err_msg=n)
    step = make_train_step(model, device="cpu")
    _, loss, _ = step(state, torch.from_numpy(data["x"][1]), torch.from_numpy(data["y"][1]),
                      torch.Generator())
    assert np.isfinite(float(loss)) and state.step == 2


def test_single_process_checkpoint_loads_under_a_mesh(runs):
    port, data = runs
    want = torch.load(data["single"], weights_only=True)
    for r in _ok(port["ckpt_load"]):
        assert r["epoch"] == 3 and r["step"] == 2
        for n, t in want["model"].items():
            np.testing.assert_array_equal(r["loaded"][n], t.float().numpy(), err_msg=n)
        for i, per in want["optimizer"]["state"].items():
            np.testing.assert_array_equal(r["moments"][i], per["exp_avg"].numpy())
        assert np.isfinite(r["loss"])


@pytest.mark.parametrize("key,match", [
    ("mesh_product", "ValueError: mesh 3x1 != 2 ranks"),
    ("mesh_divides", "ValueError: 2 ranks not divisible by n_model=3"),
    ("spec_product", "ValueError: mesh {'data': 2, 'model': 2} needs 4 ranks"),
    ("fsdp_axis", "ValueError: fsdp over 'nope'"),
    ("seq_axis", "ValueError: seq_mesh {'data': 2} has no axis 'seq'"),
    ("experts", "ValueError: 3 experts do not split over 2 ranks"),
    ("seq_mask", "NotImplementedError: context-parallel softmax attention supports neither"),
    ("seq_maps", "NotImplementedError: context-parallel softmax attention supports neither"),
    ("seq_dropout", "NotImplementedError: context-parallel softmax attention does not "
                    "support attention-probability dropout"),
    ("foreign_state", "ValueError: the state was created for another model"),
])
def test_parallel_refusals(runs, key, match):
    port, _ = runs
    for r in _ok(port["refusals"]):
        assert r[key] is not None and r[key].startswith(match), r[key]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CLI = ["--model", "performer_favor_most_general", "--epochs", "1", "--dropout", "0",
       "--batch-size", "256", "--depth", "1", "--bench-warmup", "1", "--bench-iters", "2",
       "--quiet", "--cpu"]


def test_train_cli_as_two_processes_matches_one(tmp_path):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "efficient_rpe_vit_torch.experiments.train", *CLI,
         "--output-dir", str(tmp_path / "mesh"), "--mesh", "data=2",
         "--distributed", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(rank)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    single = port_train.main([*CLI, "--output-dir", str(tmp_path / "one")])
    files = list((tmp_path / "mesh").glob("*_metrics.json"))
    assert len(files) == 1  # the coordinator alone writes
    mesh = json.loads(files[0].read_text())
    assert mesh["metadata"]["num_parameters"] == single["metadata"]["num_parameters"]
    for got, want in zip(mesh["per_epoch"], single["per_epoch"], strict=True):
        for key in ("train_loss", "test_loss"):
            assert got[key] == pytest.approx(want[key], rel=1e-5), key
        for key in ("train_accuracy", "test_accuracy"):
            assert got[key] == want[key], key
