"""The check that decides `correct`, driven end to end on the CPU at a tiny
width: the plain reference agrees with the port, and the control and each
fault a training cell can have come out not correct under the cell's own
limits."""

import pytest
import torch

from conftest import CELLS, tiny
from perfbench import calibrate, check, spec


@pytest.mark.parametrize("workload", ["kerple-b16-train-n4097", "softmax-b16-train-n4097"])
def test_perfbench_reference_agrees_with_the_port(tiny_run, workload):
    """In float32 the program and the plain reference differ by rounding
    only, and the replayed call equals the eager one."""
    out = tiny_run(workload, "float32")
    n = out["numbers"]
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 1e-5 and n["step_gap"] < 1e-4
    assert n["replay_gap"] == 0.0
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_perfbench_control_is_not_correct(workload):
    """The reference put in the program's place in float8 fails the cell's
    limits (its chip readings are in PERF.md)."""
    cell = tiny(spec.load_cell(workload), "bfloat16")
    readings = calibrate.stand_in_readings(cell, 7, torch.device("cpu"))
    fp8 = dict(readings["fp8"], replay_gap=0.0)
    assert not check.judge(fp8, cell.limits["limits"])
    for fault in ("half", "answer"):
        assert not check.judge(dict(readings[fault], replay_gap=0.0), cell.limits["limits"])


def _unchanged(monkeypatch):
    from efficient_rpe_vit_torch.train import training

    update = training.TrainState._update
    monkeypatch.setattr(training.TrainState, "_update",
                        lambda self, lr: update(self, lr * 0.0))


def _half_batch(monkeypatch):
    from efficient_rpe_vit_torch.train import training

    loss = training.cross_entropy_loss

    def half(logits, labels, smoothing=0.0):
        n = logits.shape[0] // 2
        return loss(logits[:n], labels[:n], smoothing)

    monkeypatch.setattr(training, "cross_entropy_loss", half)


def _answer_altered(monkeypatch):
    from efficient_rpe_vit_torch.train import training

    loss = training.cross_entropy_loss

    def altered(logits, labels, smoothing=0.0):
        bump = torch.zeros_like(logits)
        bump[0, labels[0].long()] = 1.0
        return loss(logits + bump, labels, smoothing)

    monkeypatch.setattr(training, "cross_entropy_loss", altered)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _answer_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_perfbench_broken_program_is_not_correct(tiny_run, monkeypatch, workload, fault):
    fault(monkeypatch)
    out = tiny_run(workload, "float32")
    assert out["correct"] is False


def test_perfbench_judge_refuses_missing_and_nan():
    limits = {"loss_gap": 1e-3}
    assert check.judge({"loss_gap": 1e-4}, limits)
    assert not check.judge({"loss_gap": float("nan")}, limits)
    assert not check.judge({}, limits)
    assert not check.judge({"loss_gap": 2e-3}, limits)


def test_perfbench_leaves_without_gradient_are_left_out_of_the_change():
    ref = {"losses": [1.0], "grad_norms": {"a": 1.0, "b": 1.0, "c": 1e-6},
           "delta_norms": {"a": 1.0, "b": 1.0, "c": 1.0}}
    prog = {"losses": [1.0], "grad_norms": {"a": 1.0, "b": 1.0, "c": 1e-6},
            "delta_norms": {"a": 1.0, "b": 1.0, "c": 5.0}}
    assert check.training_numbers(prog, ref)["step_gap"] == 0.0
    prog["delta_norms"]["b"] = 0.0
    assert check.training_numbers(prog, ref)["step_gap"] == 1.0
