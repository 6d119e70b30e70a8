"""CPU tests of the benchmark: tiny widths, the port's plain kernel
versions, no card. Run from the repository root:

    python -m pytest perfbench/tests -q
"""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ["kerple-b16-train-n4097", "softmax-b16-train-n4097",
         "kerple-b16-train-n197", "softmax-b16-train-n197"]
CARD = "NVIDIA H100 80GB HBM3"


def tiny(cell, compute_dtype="float32"):
    """The cell at a width a CPU test holds (dim 32, depth 2, N = 17),
    its limits kept."""
    cell.config = dict(cell.config, dim=32, depth=2, heads=2, mlp_dim=64, patch_size=4,
                       num_classes=10, compute_dtype=compute_dtype)
    if "num_features" in cell.config:
        cell.config["num_features"] = 12
    cell.mix = dict(cell.mix, image_size=16, batch=4, fused_steps=3, held_images=24)
    return cell


@pytest.fixture
def tiny_run():
    """run(workload, compute_dtype, seed) -> the training runner's result on
    the CPU for the tiny cell, with a half-second window."""
    import torch

    from perfbench import spec

    def run(workload, compute_dtype="float32", seed=2 ** 31 + 11):
        cell = tiny(spec.load_cell(workload), compute_dtype)
        runner = spec.runner(cell.mix["kind"])
        return runner.run(cell, seed, 0.3, False, time.perf_counter(), torch.device("cpu"),
                          spec.peaks()[CARD])

    return run
