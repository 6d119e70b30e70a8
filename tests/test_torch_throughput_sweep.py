"""The port's 11-variant throughput sweep (`experiments/throughput_sweep.py`'s
counterpart) on the CPU: the JAX sweep's variants, and every variant's
row (`bench_variant(..., device="cpu")`, mnist_config, batch 4, one step
a run) finite and positive under the JAX JSON keys. The timings are CPU
timings and stand for nothing; the sweep's main takes the card and
raises without one."""

import math
import sys

import pytest
import torch

from efficient_rpe_vit_torch.experiments import throughput_sweep
from efficient_rpe_vit_torch.models import MODEL_VARIANTS

torch.set_num_threads(2)


def test_variants_are_the_jax_sweeps():
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    from experiments import throughput_sweep as jax_sweep

    assert throughput_sweep.VARIANTS == jax_sweep.VARIANTS
    assert len(throughput_sweep.VARIANTS) == 11
    assert set(throughput_sweep.VARIANTS) <= set(MODEL_VARIANTS)


def test_every_row_is_finite_and_positive():
    results = throughput_sweep.sweep("mnist", 4, 1, card="none (a CPU run)", device="cpu",
                                     verbose=False)
    assert set(results) == {"dataset", "batch", "card", "protocol", "variants"}
    assert results["dataset"] == "mnist" and results["batch"] == 4
    assert results["protocol"] == "chained value-fetch, median of 3 x 1 steps, bf16"
    assert list(results["variants"]) == throughput_sweep.VARIANTS
    for name, row in results["variants"].items():
        assert set(row) == {"images_per_sec", "ms_per_step"}, name
        for value in row.values():
            assert math.isfinite(value) and value > 0, (name, row)


def test_main_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the sweep without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        throughput_sweep.main(["--dataset", "mnist", "--steps", "1"])
