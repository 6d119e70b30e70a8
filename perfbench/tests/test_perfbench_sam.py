"""The `sam` family: its leaves and step FLOPs at the cell's sizes, pinned;
its tiny cell through the runner and calibrate's stand-ins on the CPU; the
bias attention's roofline from shapes alone."""

import pytest
import torch

from conftest import CARD, tiny
from perfbench import calibrate, check, spec
from perfbench.counts import sam as counts
from perfbench.trace import Trace

CELL = "sam-h-train-n4096"
SEED = 2 ** 31 + 11


def test_perfbench_sam_leaves_and_step_flops():
    """459 leaves (SAM's 457 and the head's 2), 637,283,048 parameters, and
    71.533 TFLOP a step: 3 x 4 images x 5.961 TFLOP, SAM's padded windows
    counted (`counts/sam.py`)."""
    cell = spec.load_cell(CELL)
    family = spec.family(cell.config)
    assert family.name == "sam"
    leaves = family.reference.parameter_spec(cell.config, cell.mix)
    assert len(leaves) == 459
    assert sum(torch.Size(s).numel() for _, s, _ in leaves) == 637_283_048
    assert family.counts.train_flops_per_step(cell.config, cell.mix) == 71_533_000_114_176.0
    s = counts.shape(cell.config, cell.mix)
    assert (s["N"], s["windows"], s["window_tokens"], s["window_blocks"],
            s["global_blocks"]) == (4096, 25, 4900, 28, 4)
    assert counts.attention_calls(cell.config) == {"window": 28, "global": 4}


def test_perfbench_sam_config_holds_the_ports_widths():
    """The configuration's architecture fields are what the port builds
    under its `variant` (`models/sam.py::SAM_VIT_H`, the family's `ARCH`),
    so the two statements of ViT-H's widths cannot drift apart."""
    from efficient_rpe_vit_torch.models.sam import SAM_VIT_H
    from perfbench.families import sam as family

    config = spec.load_cell(CELL).config
    assert config["variant"] == "sam_vit_h" and set(family.ARCH) == set(SAM_VIT_H)
    arch = {k: config[k] for k in family.ARCH}
    assert dict(arch, global_attn_indexes=tuple(arch["global_attn_indexes"])) == SAM_VIT_H


def test_perfbench_sam_tiny_run_is_correct(tiny_run):
    """In float32 the port and the plain reference differ by rounding (the
    k third of the qkv bias has no gradient but rounding, which Adam turns
    into whole steps on either side: step_gap near 1e-3), and the replay
    equals the eager steps."""
    out = tiny_run(CELL, "float32", SEED)
    n = out["numbers"]
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 1e-5 and n["step_gap"] < 1e-2
    assert n["replay_gap"] == 0.0
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0


def test_perfbench_sam_stand_ins_are_not_correct():
    """calibrate's control and faults on the tiny cell, against the cell's
    limits: each reads above at least one."""
    cell = tiny(spec.load_cell(CELL), "bfloat16")
    readings = calibrate.stand_in_readings(cell, 7, torch.device("cpu"))
    assert set(readings) == set(calibrate.FAULTS)
    for fault, numbers in readings.items():
        assert not check.judge(dict(numbers, replay_gap=0.0), cell.limits["limits"]), fault


def test_perfbench_relpos_roofline_reads_shapes():
    """The reader divides the least time of 28 windowed and 4 global calls a
    step by the group's measured time, whatever the kernels' names."""
    cell = spec.load_cell(CELL)
    peak = spec.peaks()[CARD]
    run = {"config": cell.config, "mix": cell.mix, "peak": peak}
    least = counts.op_least_seconds(cell.config, cell.mix, peak)
    per_step = sum(n * (least[k]["forward"] + least[k]["backward"])
                   for k, n in (("window", 28), ("global", 4)))
    reader = spec.reader("relpos_attn_roofline.train")
    got = reader.read(Trace(1.0, 1.0, 8, {"flash_fwd_rel_mma_kernel<80>": 0.5}), run)
    assert got == pytest.approx(100.0 * 8 * per_step / 0.5)
    assert reader.read(Trace(1.0, 1.0, 8, {"nvjet_tst": 0.5}), run) is None
    # windows: 100 x 16 x 196 rows of 80, products bound; the bias rows'
    # bytes are in the bound
    w = least["window"]["forward"]
    rows = 4 * 25 * 16 * 196
    assert w == pytest.approx(max(2 * 2 * rows * 196 * 80 / peak["bfloat16_flops_per_s"],
                                  (2 * 4 * rows * 80 + 4 * rows * 28) / peak["hbm_bytes_per_s"]))
