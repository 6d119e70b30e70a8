"""The comparison that decides `correct`.

A training cell compares the program's first steps with the plain
reference's from the same weights and batches (`reference/train.py`):

* `loss_gap`: the largest relative gap of the first steps' losses;
* `grad_gap`: of the first gradient as the optimiser holds it, the worst
  leaf's gap between the program's norm and the reference's, over the
  larger of that leaf's reference norm and the median leaf's;
* `step_gap`: the same of each leaf's change after the last checked step,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (below that Adam moves a leaf by rounding alone);
* `replay_gap`: the largest difference between the first call's eager
  steps and the same steps replayed from the captured graph, from the same
  state; exact, limit 0.

Each number has its limit in `limits/<workload>.json`; a number that is
missing or not finite fails.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional

ZERO_GRADIENT = 1e-3


def gap_by_leaf(program: Dict[str, float], reference: Dict[str, float],
                leaves: Optional[Iterable[str]] = None) -> float:
    names = list(reference) if leaves is None else list(leaves)
    missing = [n for n in names if n not in program]
    if missing:
        raise KeyError(f"the program has no leaves {missing[:5]}")
    floor = statistics.median(reference[n] for n in names)
    return max(abs(program[n] - reference[n]) / max(reference[n], floor, 1e-30)
               for n in names)


def training_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """program / reference: {"losses", "grad_norms", "delta_norms"}."""
    steps = len(reference["losses"])
    loss_gap = max(abs(p - r) / abs(r) for p, r in
                   zip(program["losses"][:steps], reference["losses"]))
    grads = reference["grad_norms"]
    floor = statistics.median(grads.values())
    moving = [n for n, g in grads.items() if g >= ZERO_GRADIENT * floor]
    return {"loss_gap": loss_gap,
            "grad_gap": gap_by_leaf(program["grad_norms"], grads),
            "step_gap": gap_by_leaf(program["delta_norms"], reference["delta_norms"], moving)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True where every limited number is finite and within its limit."""
    for name, limit in limits.items():
        value = numbers.get(name)
        if value is None or not math.isfinite(value) or value > limit:
            return False
    return True


def compared(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} for the result line."""
    return {name: {"value": numbers.get(name), "limit": limit}
            for name, limit in limits.items()}
