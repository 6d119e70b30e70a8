"""The port's ViT-B MFU benchmark (`experiments/vitbase_bench.py`'s
counterpart) on the CPU.

`pallas_attention_flops` equals the JAX function on a grid of variants x
(B, H, N, D, num_features) with the JAX package's dispatch constants in the
port and JAX's Pallas taken as available, and brackets the port's own
constants (the kernels at every N). The kernels' `torch.library` ops count
no FLOPs under FlopCounterMode while their plain versions count what the
analytic formula does. The shapes, variants and flag defaults are the JAX
module's; every row at `--width 32 2 2 64 --device cpu` carries the JAX
keys (`_xla` renamed `_counted`); `main` raises without a GPU. The timings
are CPU timings and stand for nothing.
"""

import itertools
import json
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import efficient_rpe_vit_tpu.ops.pallas as jax_pallas
from efficient_rpe_vit_tpu.ops import attention_core as jax_core
from efficient_rpe_vit_torch.experiments import vitbase_bench
from efficient_rpe_vit_torch.models import MODEL_VARIANTS
from efficient_rpe_vit_torch.ops import attention_core, rotations
from efficient_rpe_vit_torch.ops.kernels import flash_attention as fa
from efficient_rpe_vit_torch.ops.kernels import masked_linear_coeffs as mlc
from torch_experiment_cli import flag_defaults, jax_experiment

torch.set_num_threads(2)

JAX = jax_experiment("vitbase_bench")
GRID = list(itertools.product((1, 4, 16, 64), (2, 12), (17, 197, 1025, 4097, 8192),
                              (16, 64), (None, 44, 266, "mxu")))
# the JAX keys of a row (jax `bench_one` and `main`), `_xla` renamed `_counted`
JAX_ROW_KEYS = {"variant", "batch", "timed_steps", "step_ms", "images_per_sec",
                "flops_per_step_counted", "mfu_counted", "flops_per_step", "mfu",
                "shape", "N"}
PORT_ROW_KEYS = {"launches", "launches_per_step", "peak_bytes_in_use"}


@pytest.fixture
def jax_rules(monkeypatch):
    """The JAX package's dispatch constants in the port, the linear
    modules' rotation as JAX calls it, JAX's Pallas taken as available."""
    for name in ("FLASH_MIN_N", "SOFTMAX_DENSE_MEMORY_BUDGET", "KERPLE_DENSE_CROSSOVER_N",
                 "KERPLE_DENSE_MEMORY_BUDGET"):
        monkeypatch.setattr(attention_core, name, getattr(jax_core, name))
    monkeypatch.setattr(rotations, "KERNEL_BEFORE_PHI", False)
    monkeypatch.setattr(jax_pallas, "pallas_available", lambda: True)


@pytest.mark.parametrize("variant", sorted(MODEL_VARIANTS))
def test_pallas_flops_equal_jax(jax_rules, variant):
    nonzero = 0
    for B, H, N, D, F in GRID:
        want = JAX.pallas_attention_flops(variant, B, H, N, D, 12, F)
        got = vitbase_bench.pallas_attention_flops(variant, B, H, N, D, 12, F)
        assert got == want, (variant, B, H, N, D, F)
        nonzero += want > 0
    # both sides of the JAX walls are on the grid for the kernel variants
    if variant.startswith("baseline") or variant == "vit" or "most_general" in variant:
        assert 0 < nonzero < len(GRID)


def test_port_rules_take_the_kernels_at_every_n():
    """With the H100 constants (every crossover 0) the flagship and baseline
    count their kernels at every N, and a performer's circulant rotation
    its rotation kernels (KERNEL_BEFORE_PHI)."""
    for N in (5, 17, 197, 4097):
        B, H, D, depth = 8, 12, 64, 12
        assert vitbase_bench.pallas_attention_flops(
            "performer_favor_most_general", B, H, N, D, depth, None) == \
            depth * 5.0 * 2 * B * H * N * N * (266 + D)
        assert vitbase_bench.pallas_attention_flops("baseline", B, H, N, D, depth, None) == \
            depth * 7.0 * 2 * B * H * N * N * D
        assert vitbase_bench.pallas_attention_flops(
            "performer_favor_circulant", B, H, N, D, depth, None) == \
            depth * 40.0 * B * H * N * D * (D // 2 + 1)
        assert vitbase_bench.pallas_attention_flops("performer_favor", B, H, N, D, depth,
                                                    "mxu") == 0


def test_kernel_ops_count_no_flops_and_their_plain_versions_do():
    """The counted FLOPs never see a kernel: its `torch.library` op counts
    0 (without raising), while the plain version counts the products the
    analytic forward term counts."""
    B, H, N, F, D = 2, 2, 17, 12, 8
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, H, N, D, generator=g) for _ in range(3))
    qp, kp = (torch.rand(B, H, N, F, generator=g) for _ in range(2))
    c = torch.rand(H, 2 * N - 1, generator=g) + 0.5
    for op, plain, flops in (
            (lambda: fa.flash_attention_fwd(q, k, v, 0.25),
             lambda: fa.flash_softmax_attention_reference(q, k, v, 0.25),
             4 * B * H * N * N * D),
            (lambda: mlc.masked_linear_attention_coeffs_fwd(qp, kp, v, c),
             lambda: mlc.masked_linear_attention_coeffs_reference(qp, kp, v, c),
             2 * B * H * N * N * (F + D))):
        with FlopCounterMode(display=False) as counter:
            got = op()
        assert counter.get_total_flops() == 0
        with FlopCounterMode(display=False) as counter:
            want = plain()
        assert counter.get_total_flops() == flops
        torch.testing.assert_close(got, want)


def test_shapes_variants_and_flags_are_the_jax_ones():
    assert vitbase_bench.SHAPES == JAX.SHAPES
    assert vitbase_bench.VARIANTS == JAX.VARIANTS
    jax_flags = flag_defaults(JAX.main)
    port_flags = flag_defaults(vitbase_bench.main)
    # the port writes a file only with --out (the JAX default holds TPU
    # rows), and adds --device and the CPU tests' --width
    assert set(port_flags) - set(jax_flags) == {"device", "width"}
    for dest, default in jax_flags.items():
        if dest != "out":
            assert port_flags[dest] == default, dest


def test_rows_carry_the_jax_keys(tmp_path):
    out = tmp_path / "vb.json"
    result = vitbase_bench.main(["--device", "cpu", "--width", "32", "2", "2", "64",
                                 "--shapes", "N=197", "--steps-scale", "0.01",
                                 "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    assert result["backend"].startswith("cpu")
    assert result["dims"] == {"dim": 32, "heads": 2, "head_dim": 16, "mlp_dim": 64,
                              "depth": 2, "dtype": "bfloat16"}
    assert [r["variant"] for r in result["rows"]] == JAX.VARIANTS
    for row in result["rows"]:
        kernels = {"pallas_attention_flops"} if row["variant"] != "performer_favor" else set()
        assert set(row) == JAX_ROW_KEYS | PORT_ROW_KEYS | kernels, row
        assert row["shape"] == "N=197" and row["N"] == 197 and row["timed_steps"] == 3
        assert row["mfu"] is None and row["mfu_counted"] is None  # no card, no peak
        assert row["flops_per_step"] == row["flops_per_step_counted"] + row.get(
            "pallas_attention_flops", 0)
        assert row["flops_per_step_counted"] > 0
        assert math.isfinite(row["step_ms"]) and row["images_per_sec"] > 0
        assert row["launches"] == {} and row["launches_per_step"] == {}  # CPU: plain versions


def test_main_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the benchmark without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vitbase_bench.main(["--shapes", "N=197"])
