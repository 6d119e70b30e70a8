"""Cross-run aggregation, convergence metrics and reproducibility helpers.

Counterpart of `efficient_rpe_vit_tpu/train/benchmark_utils.py`, its numpy
and JSON code copied (the port never imports the JAX package): the same
outputs and the same JSON schemas. `set_random_seeds` also seeds torch.
"""

from __future__ import annotations

import json
import os
import random
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def compute_convergence_metrics(
    accuracies: List[float],
    thresholds=(90.0, 95.0, 99.0),
    plateau_window: int = 3,
    plateau_tolerance: float = 0.1,
) -> Dict[str, Any]:
    """First epoch reaching each threshold + plateau detection
    (reference: benchmark_utils.py:22-72; plateau = spread <= 0.1% over a
    3-epoch window)."""
    out: Dict[str, Any] = {}
    for th in thresholds:
        epoch = next(
            (i + 1 for i, a in enumerate(accuracies) if a >= th), None
        )
        out[f"epochs_to_{int(th)}"] = epoch
    plateau_epoch = None
    for i in range(len(accuracies) - plateau_window + 1):
        window = accuracies[i : i + plateau_window]
        if max(window) - min(window) <= plateau_tolerance:
            plateau_epoch = i + 1
            break
    out["plateau_epoch"] = plateau_epoch
    out["final_accuracy"] = accuracies[-1] if accuracies else None
    out["best_accuracy"] = max(accuracies) if accuracies else None
    return out


def compute_aggregated_statistics(
    runs: List[Dict[str, Any]], metrics: Optional[List[str]] = None
) -> Dict[str, Any]:
    """mean/std(ddof=1)/min/max + raw values per metric across runs,
    None-tolerant (reference: benchmark_utils.py:75-139)."""
    if not runs:
        return {}
    if metrics is None:
        metrics = sorted(
            {
                k
                for run in runs
                for k, v in run.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            }
        )
    out: Dict[str, Any] = {"num_runs": len(runs)}
    for m in metrics:
        vals = [run.get(m) for run in runs]
        vals = [v for v in vals if v is not None]
        if not vals:
            out[m] = None
            continue
        arr = np.asarray(vals, dtype=np.float64)
        out[m] = {
            "mean": float(arr.mean()),
            "std": float(arr.std(ddof=1)) if len(arr) > 1 else 0.0,
            "min": float(arr.min()),
            "max": float(arr.max()),
            "values": [float(v) for v in arr],
        }
    return out


def save_run_metrics(path: str, metrics: Dict[str, Any]) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(metrics, f, indent=2, default=float)
    return path


def load_run_metrics(path: str) -> Optional[Dict[str, Any]]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_benchmark_config(directory: str, config: Dict[str, Any]) -> str:
    """Persist the benchmark invocation incl. exact argv
    (reference: benchmark_utils.py:174-200)."""
    os.makedirs(directory, exist_ok=True)
    payload = dict(config)
    payload["argv"] = sys.argv
    path = os.path.join(directory, "benchmark_config.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)
    return path


def print_model_summary(model_name: str, stats: Dict[str, Any]) -> None:
    """Human-readable per-model summary (reference: benchmark_utils.py:203-256)."""
    print(f"\n=== {model_name} ===")
    for key, val in stats.items():
        if isinstance(val, dict) and "mean" in val:
            print(f"  {key}: {val['mean']:.4f} ± {val['std']:.4f} "
                  f"[{val['min']:.4f}, {val['max']:.4f}]")
        elif isinstance(val, (int, float)):
            print(f"  {key}: {val}")


def set_random_seeds(seed: int) -> "np.random.Generator":
    """Seed Python, numpy and torch (every device's default generator) and
    return a numpy Generator. The port's own randomness takes explicit
    generators; this covers code that draws from the global ones."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)
