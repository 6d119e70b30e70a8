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

from perfbench import spec  # noqa: E402

# every cell of BENCHMARK.json, in file order: a cell appended later is
# tested without an edit here
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
CARD = "NVIDIA H100 80GB HBM3"


def tiny(cell, compute_dtype="float32"):
    """The cell at the sizes a CPU test holds (its family's `tiny`), its
    limits kept."""
    config, cell.mix = spec.family(cell.config).program.tiny(cell.config, cell.mix)
    cell.config = dict(config, compute_dtype=compute_dtype)
    return cell


@pytest.fixture
def tiny_run():
    """run(workload, compute_dtype, seed) -> the training runner's result on
    the CPU for the tiny cell, with a half-second window."""
    import torch

    def run(workload, compute_dtype="float32", seed=2 ** 31 + 11):
        cell = tiny(spec.load_cell(workload), compute_dtype)
        runner = spec.runner(cell.mix["kind"])
        return runner.run(cell, seed, 0.3, False, time.perf_counter(), torch.device("cpu"),
                          spec.peaks()[CARD])

    return run
