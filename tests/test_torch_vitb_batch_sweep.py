"""The port's ViT-B batch sweep (`experiments/vitb_batch_sweep.py`'s
counterpart) on the CPU: the JAX sweep's batches, timed steps and fused
row, its row keys (with the counted FLOPs and the kernels' FLOPs beside
them), the JSON rewritten after each row, and `main` raising without a
GPU. The timings are CPU timings and stand for nothing."""

import ast
import inspect
import json

import pytest
import torch

from efficient_rpe_vit_torch.experiments import vitb_batch_sweep
from torch_experiment_cli import flag_defaults, jax_experiment

torch.set_num_threads(2)

JAX = jax_experiment("vitb_batch_sweep")
JAX_ROW_KEYS = {"batch", "fused_k", "timed_steps", "step_ms", "images_per_sec",
                "flops_per_step", "mfu"}
PORT_ROW_KEYS = {"flops_per_step_counted", "pallas_attention_flops", "launches",
                 "launches_per_step", "peak_bytes_in_use"}
TINY = ["--device", "cpu", "--width", "32", "2", "2", "64"]


def _jax_main_literals():
    """The JAX main's (batch, steps) list and its fused call's (steps, K)."""
    tree = ast.parse(inspect.getsource(JAX.main))
    batches = next(ast.literal_eval(node.iter) for node in ast.walk(tree)
                   if isinstance(node, ast.For) and isinstance(node.iter, ast.List))
    fused = next(node for node in ast.walk(tree) if isinstance(node, ast.Call)
                 and getattr(node.func, "id", None) == "bench_batch" and node.keywords)
    return batches, ast.literal_eval(fused.args[1]), ast.literal_eval(fused.keywords[0].value)


def test_batches_and_flags_are_the_jax_ones():
    batches, fused_steps, fused_k = _jax_main_literals()
    assert vitb_batch_sweep.BATCHES == batches
    assert (vitb_batch_sweep.FUSED_STEPS, vitb_batch_sweep.FUSED_K) == (fused_steps, fused_k)
    jax_flags = flag_defaults(JAX.main)
    port_flags = flag_defaults(vitb_batch_sweep.main)
    # JAX has only --out (its default holds TPU rows; the port writes a
    # file only with it); the port adds the batch subset, --device, --width
    assert set(jax_flags) == {"out"}
    assert set(port_flags) == {"out", "batches", "device", "width"}
    assert port_flags["batches"] == [b for b, _ in batches]


def test_rows_and_the_fused_row(tmp_path):
    out = tmp_path / "sweep.json"
    result = vitb_batch_sweep.main([*TINY, "--batches", "64", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    eager, fused = result["rows"]
    for row in (eager, fused):
        assert set(row) == JAX_ROW_KEYS | PORT_ROW_KEYS, row
        assert row["batch"] == 64 and row["mfu"] is None  # no card, no peak
        assert row["flops_per_step"] == row["flops_per_step_counted"] + row[
            "pallas_attention_flops"]
        assert row["pallas_attention_flops"] > 0  # the KERPLE kernels at N=197
        assert row["step_ms"] > 0 and row["images_per_sec"] > 0
    assert (eager["fused_k"], eager["timed_steps"]) == (None, 20)
    assert (fused["fused_k"], fused["timed_steps"]) == (8, 24)


def test_each_row_is_written_before_the_next(tmp_path, monkeypatch):
    out = tmp_path / "sweep.json"
    seen = []
    bench = vitb_batch_sweep.bench_batch

    def watched(batch, steps, fused_k=None, **kw):
        seen.append(json.loads(out.read_text())["rows"] if out.exists() else None)
        if batch == 128 and not fused_k:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (a stand-in)")
        return bench(batch, 1, fused_k=fused_k, **kw)

    monkeypatch.setattr(vitb_batch_sweep, "bench_batch", watched)
    result = vitb_batch_sweep.main([*TINY, "--batches", "64", "128", "--out", str(out)])
    assert seen[0] is None and len(seen[1]) == 1 and len(seen[2]) == 2
    assert result["rows"][1] == {"batch": 128, "error": "OutOfMemoryError: CUDA out of "
                                 "memory (a stand-in)"}
    assert result["rows"][2]["batch"] == 64 and result["rows"][2]["fused_k"] == 8


def test_main_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the sweep without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vitb_batch_sweep.main(["--batches", "64"])
