"""The port's tracing module (`utils/tracing.py`) on the CPU.

Off it records and launches nothing; on, host spans nest with their
parents, and the device spans' markers (kept in memory on the CPU, in
order) bracket each train step's gather, forward with one phi per layer,
backward with one phi backward per layer, and optimiser update, also where
phi is checkpointed and recomputed in the backward. Tracing changes no
number: losses and parameters are bit-identical with it on and off. The
marker kernels' names fall in no kernel group of the benchmark, and the
CUDA source defines the spans the module names.
"""

import re

import numpy as np
import pytest
import torch

from efficient_rpe_vit_torch.configs import mnist_config
from efficient_rpe_vit_torch.models import attention, create_model
from efficient_rpe_vit_torch.ops.kernels import _build
from efficient_rpe_vit_torch.train import create_train_state, make_gather_multi_step
from efficient_rpe_vit_torch.utils import tracing
from perfbench import spec

torch.set_num_threads(2)

DEPTH = 2
SMALL = dict(dim=64, heads=2, depth=DEPTH, mlp_dim=128, dropout=0.0, patch_size=7)
STEPS = 2


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.enable(False)
    tracing.clear()
    yield
    tracing.enable(False)
    tracing.clear()


def _steps(on: bool):
    """Two gather-fused train steps of a depth-2 flagship model on the CPU:
    (losses, parameters after them)."""
    cfg = mnist_config(**SMALL)
    model = create_model("performer_favor_most_general", cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, steps_per_epoch=4)
    step = make_gather_multi_step(model, device="cpu")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (16, 28, 28, 1), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 10, 16).astype(np.int32))
    tracing.enable(on)
    _, losses, _ = step(state, images, labels, torch.tensor([0.13]), torch.tensor([0.31]),
                        np.arange(16).reshape(STEPS, 8), torch.Generator().manual_seed(1))
    tracing.enable(False)
    return losses, {n: p.detach().clone() for n, p in model.named_parameters()}


def _step_marks():
    def span(name, inner=()):
        return [f"rpe_mark_begin_{name}", *inner, f"rpe_mark_end_{name}"]

    return (span("gather") + span("forward", span("phi") * DEPTH)
            + span("backward", span("phi_bwd") * DEPTH) + span("optimizer"))


class _Launches:
    """Stands in for `_build.launch` and the marker library: records each
    launch's marker index."""

    def __init__(self, monkeypatch):
        self.indices = []
        index = {name: i for i, name in enumerate(tracing.MARKERS)}
        monkeypatch.setattr(tracing, "_library", lambda: (_FakeLib(), index))
        monkeypatch.setattr(_build, "launch",
                            lambda errors, name, fn, device, i: self.indices.append(i))


class _FakeLib:
    rpe_mark_error_string = rpe_mark_launch = None


def test_off_records_and_launches_nothing(monkeypatch):
    launches = _Launches(monkeypatch)
    assert tracing.span("rpe.call") is tracing.device_span("rpe.forward", "cuda")
    with tracing.span("rpe.call"), tracing.device_span("rpe.forward", "cuda") as s:
        x = torch.ones(2, requires_grad=True)
        assert s.inputs(x) == (x,) and s.outputs(x) == (x,)
    _steps(on=False)
    assert launches.indices == [] and tracing.spans() == [] and tracing.marks() == []


def test_on_launches_each_marker_on_the_card(monkeypatch):
    """On a CUDA device a device span launches its begin and end marker
    kernels and nothing goes to the CPU's list; the backward's markers come
    from the identity functions."""
    launches = _Launches(monkeypatch)
    tracing.enable(True)
    with tracing.device_span("rpe.phi", "cuda") as s:
        (x,) = s.inputs(torch.ones(2, requires_grad=True))
        (y,) = s.outputs(2 * x)
    y.sum().backward()
    names = [tracing.MARKERS[i] for i in launches.indices]
    assert names == ["rpe_mark_begin_phi", "rpe_mark_end_phi", "rpe_mark_begin_phi_bwd",
                     "rpe_mark_end_phi_bwd"]
    assert tracing.marks() == []
    assert [s[:2] for s in tracing.spans()] == [("rpe.phi", None)]


def test_nested_host_spans_keep_their_parents():
    tracing.enable(True)
    with tracing.span("rpe.call"):
        with tracing.span("rpe.call.pack"):
            pass
        with tracing.span("rpe.call.replay"):
            with tracing.device_span("rpe.gather", "cpu"):
                pass
    got = tracing.spans()
    assert [s[:2] for s in got] == [("rpe.call.pack", "rpe.call"),
                                    ("rpe.gather", "rpe.call.replay"),
                                    ("rpe.call.replay", "rpe.call"), ("rpe.call", None)]
    assert all(start <= end for _, _, start, end in got)
    call, pack = got[-1], got[0]
    assert call[2] <= pack[2] <= pack[3] <= call[3]


@pytest.mark.parametrize("checkpointed", [False, True])
def test_step_markers_in_order(monkeypatch, checkpointed):
    """gather, forward holding phi once per layer, backward holding phi's
    backward once per layer, optimiser: per step. Checkpointed, phi's
    recompute inside the backward marks nothing."""
    if checkpointed:
        monkeypatch.setattr(attention, "PHI_CHECKPOINT_BYTES", 0)
    _steps(on=True)
    assert tracing.marks() == _step_marks() * STEPS
    spans = [s[:2] for s in tracing.spans()]
    assert spans.count(("rpe.phi", "rpe.forward")) == DEPTH * STEPS
    assert spans[-1] == ("rpe.call", None)
    assert {p for n, p in spans if n in ("rpe.gather", "rpe.forward", "rpe.backward",
                                         "rpe.optimizer")} == {"rpe.call"}


@pytest.mark.parametrize("checkpointed", [False, True])
def test_tracing_changes_no_bit(monkeypatch, checkpointed):
    if checkpointed:
        monkeypatch.setattr(attention, "PHI_CHECKPOINT_BYTES", 0)
    losses_off, params_off = _steps(on=False)
    losses_on, params_on = _steps(on=True)
    assert torch.equal(losses_on, losses_off)
    assert all(torch.equal(params_on[n], params_off[n]) for n in params_off)


def test_markers_fall_in_no_kernel_group():
    groups = spec.kernel_groups()
    assert [m for m in tracing.MARKERS if spec.classify(m, groups) is not None] == []


def test_cuda_source_defines_the_spans():
    source = (_build.CSRC / "trace_marks.cu").read_text()
    listed = re.search(r"#define RPE_SPANS\(X\) (.*)", source).group(1)
    assert tuple(re.findall(r"X\((\w+)\)", listed)) == tracing.DEVICE_SPANS


def test_train_cli_profile_shows_the_spans(tmp_path):
    """`--profile` traces the first epoch with tracing on: the operator
    table ends with the spans' rows and the Chrome trace holds them; the
    CLI leaves tracing off."""
    from efficient_rpe_vit_torch.experiments import train as cli

    prof = tmp_path / "prof"
    cli.main(["--model", "performer_favor_most_general", "--dataset", "mnist", "--depth", "1",
              "--epochs", "1", "--batch-size", "1024", "--quiet", "--bench-warmup", "1",
              "--bench-iters", "2", "--output-dir", str(tmp_path), "--cpu", "--fused-steps", "2",
              "--profile", str(prof)])
    table = (prof / "key_averages.txt").read_text().split("Self CPU time total")[1]
    for name in ("rpe.call", "rpe.gather", "rpe.forward", "rpe.phi", "rpe.backward",
                 "rpe.optimizer"):
        assert f" {name} " in table
    assert '"rpe.forward"' in (prof / "trace.json").read_text()
    assert not tracing.enabled() and tracing.spans() == []
