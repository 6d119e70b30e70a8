#!/usr/bin/env python
"""Static HTML report of a benchmark results tree.

Counterpart of `experiments/report.py` and of the readers it takes from
`experiments/dashboard.py` (the port keeps its own copies): walks the tree
`experiments/benchmark.py` writes (`benchmark_config.json`, per model
`aggregated_stats.json` and one `*_metrics.json` per run) and renders the
summary table, accuracy percentile bands, efficiency bars and scatter,
convergence and every run's training curves into one self-contained
`report.html` with embedded PNGs.

    python -m efficient_rpe_vit_torch.experiments.report results/benchmark_mnist_20260816_120000

Drawing needs matplotlib (Agg), imported inside the functions that draw;
without it `build_report` raises an ImportError that names it.
"""

from __future__ import annotations

import base64
import io
import json
import os
import sys
from typing import Any, Dict, Optional

import numpy as np


def load_benchmark_data(results_dir: str) -> Optional[Dict[str, Any]]:
    """{config, models: {model: {aggregated, runs}}} of a results tree, or
    None without its benchmark_config.json."""
    config_path = os.path.join(results_dir, "benchmark_config.json")
    if not os.path.exists(config_path):
        return None
    with open(config_path) as f:
        config = json.load(f)
    models: Dict[str, Any] = {}
    for entry in sorted(os.listdir(results_dir)):
        model_dir = os.path.join(results_dir, entry)
        if not os.path.isdir(model_dir):
            continue
        agg_path = os.path.join(model_dir, "aggregated_stats.json")
        agg = None
        if os.path.exists(agg_path):
            with open(agg_path) as f:
                agg = json.load(f)
        runs = []
        for run_entry in sorted(os.listdir(model_dir)):
            run_dir = os.path.join(model_dir, run_entry)
            if not os.path.isdir(run_dir):
                continue
            for fname in os.listdir(run_dir):
                if fname.endswith("_metrics.json"):
                    with open(os.path.join(run_dir, fname)) as f:
                        runs.append(json.load(f))
        if agg or runs:
            models[entry] = {"aggregated": agg, "runs": runs}
    return {"config": config, "models": models}


def create_summary_table(data: Dict[str, Any]):
    """One row of aggregate statistics per model."""
    rows = []
    for model, d in data["models"].items():
        agg = d.get("aggregated") or {}

        def stat(key):
            v = agg.get(key)
            return (v.get("mean"), v.get("std")) if isinstance(v, dict) else (None, None)

        acc_m, acc_s = stat("test_accuracy")
        thr_m, _ = stat("throughput_images_per_sec")
        lat_m, _ = stat("latency_mean_ms")
        tt_m, _ = stat("train_time")
        rows.append({
            "model": model,
            "test_accuracy_mean": acc_m,
            "test_accuracy_std": acc_s,
            "throughput_img_s": thr_m,
            "latency_ms": lat_m,
            "train_time_s": tt_m,
            "num_runs": agg.get("num_runs"),
        })
    return rows


def accuracy_percentiles(runs) -> Dict[str, Any]:
    """Per-epoch test-accuracy percentile bands 5/25/50/75/95 across runs,
    over the epochs every run has."""
    curves = [[e["test_accuracy"] for e in r.get("per_epoch", [])] for r in runs]
    curves = [c for c in curves if c]
    if not curves:
        return {}
    n = min(len(c) for c in curves)
    arr = np.asarray([c[:n] for c in curves])
    return {
        "epochs": list(range(1, n + 1)),
        "p5": np.percentile(arr, 5, axis=0).tolist(),
        "p25": np.percentile(arr, 25, axis=0).tolist(),
        "median": np.percentile(arr, 50, axis=0).tolist(),
        "p75": np.percentile(arr, 75, axis=0).tolist(),
        "p95": np.percentile(arr, 95, axis=0).tolist(),
        "runs": arr.tolist(),
    }


def _fig_to_b64(fig) -> str:
    from ..data.datasets import _pyplot

    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight")
    _pyplot().close(fig)
    return base64.b64encode(buf.getvalue()).decode()


def _img(b64: str) -> str:
    return f'<img src="data:image/png;base64,{b64}" style="max-width:100%"/>'


def build_report(results_dir: str) -> str:
    """Write `report.html` into `results_dir`; returns its path."""
    from ..data.datasets import _pyplot
    from ..train import compute_convergence_metrics
    from . import charts

    data = load_benchmark_data(results_dir)
    if data is None:
        raise SystemExit(f"benchmark_config.json not found in {results_dir}")
    _pyplot()  # fail before writing anything where matplotlib is missing

    parts = ["<html><head><meta charset='utf-8'><title>RPE-ViT benchmark report"
             "</title><style>body{font-family:sans-serif;margin:2em;}"
             "table{border-collapse:collapse}td,th{border:1px solid #999;"
             "padding:4px 10px;text-align:right}th{background:#eee}"
             "</style></head><body>"]
    parts.append(f"<h1>Benchmark report</h1><p>{results_dir}</p>")

    rows = create_summary_table(data)
    parts.append("<h2>Summary</h2><table><tr><th>model</th>"
                 "<th>test acc (mean±std)</th><th>img/s</th>"
                 "<th>latency ms</th><th>train s</th><th>runs</th></tr>")
    for r in rows:
        acc = (f"{r['test_accuracy_mean']:.2f}±{r['test_accuracy_std']:.2f}"
               if r["test_accuracy_mean"] is not None else "—")
        thr = f"{r['throughput_img_s']:.1f}" if r["throughput_img_s"] else "—"
        lat = f"{r['latency_ms']:.2f}" if r["latency_ms"] else "—"
        tt = f"{r['train_time_s']:.1f}" if r["train_time_s"] else "—"
        parts.append(f"<tr><td style='text-align:left'>{r['model']}</td>"
                     f"<td>{acc}</td><td>{thr}</td><td>{lat}</td>"
                     f"<td>{tt}</td><td>{r['num_runs']}</td></tr>")
    parts.append("</table>")

    parts.append("<h2>Test accuracy across seeds</h2>")
    parts.append(_img(_fig_to_b64(charts.plot_accuracy_bands(data, accuracy_percentiles))))

    parts.append("<h2>Efficiency</h2>")
    parts.append(_img(_fig_to_b64(charts.plot_efficiency_bars(rows))))
    fig = charts.plot_efficiency_scatter(rows)
    if fig is not None:
        parts.append(_img(_fig_to_b64(fig)))

    parts.append("<h2>Convergence</h2>")
    fig = charts.plot_convergence(data, compute_convergence_metrics)
    if fig is not None:
        parts.append(_img(_fig_to_b64(fig)))

    parts.append("<h2>Training curves</h2>")
    fig = charts.plot_training_curves(data)
    if fig is not None:
        parts.append(_img(_fig_to_b64(fig)))

    parts.append("</body></html>")
    out_path = os.path.join(results_dir, "report.html")
    with open(out_path, "w") as f:
        f.write("\n".join(parts))
    return out_path


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit("usage: python -m efficient_rpe_vit_torch.experiments.report "
                         "<results_dir>")
    print(f"Report written to {build_report(sys.argv[1])}")
