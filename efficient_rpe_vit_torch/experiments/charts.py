"""matplotlib charts of the port's static benchmark report.

Counterpart of `experiments/charts.py`, its figures copied (the port
imports nothing of the JAX package's tree): accuracy percentile bands per
model, per-model training curves with every run drawn, efficiency bars,
the accuracy-vs-throughput scatter, and epochs-to-threshold convergence
across all runs. Categorical hues follow the model names in sorted order,
never cycled alone; direct labels on the scatter. matplotlib is imported
inside each function that draws (Agg backend), so the module loads on a
machine without it; drawing there raises an ImportError that names it.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..data.datasets import _pyplot

# Fixed categorical order (validated palette, light mode).
PALETTE = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
           "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
SURFACE = "#fcfcfb"
TEXT = "#0b0b0b"
TEXT_2 = "#52514e"
GRID = "#e5e4e0"


def model_colors(models: List[str]) -> Dict[str, str]:
    """Stable hue assignment: color follows the model name (sorted order),
    not its position in a filtered view."""
    return {m: PALETTE[i % len(PALETTE)]
            for i, m in enumerate(sorted(models))}


def model_linestyles(models: List[str]) -> Dict[str, str]:
    """Secondary encoding once the 8 hues are exhausted (hues are assigned
    in fixed order, never cycled alone): the second cycle gets dashes so no
    two models share an identical (hue, style) pair."""
    return {m: "-" if i < len(PALETTE) else "--"
            for i, m in enumerate(sorted(models))}


def _style_axes(ax, xlabel: str = "", ylabel: str = ""):
    ax.set_facecolor(SURFACE)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(GRID)
    ax.grid(True, color=GRID, linewidth=0.6, alpha=0.8)
    ax.set_axisbelow(True)
    ax.tick_params(colors=TEXT_2, labelsize=8)
    if xlabel:
        ax.set_xlabel(xlabel, color=TEXT_2, fontsize=9)
    if ylabel:
        ax.set_ylabel(ylabel, color=TEXT_2, fontsize=9)


def _new_fig(w=9.0, h=5.0, ncols=1):
    fig, axes = _pyplot().subplots(1, ncols, figsize=(w, h), facecolor=SURFACE)
    return fig, axes


def plot_accuracy_bands(data: Dict[str, Any], percentiles_fn):
    """Median + p25/p75 + p5/p95 percentile fills per model, one axes."""
    fig, ax = _new_fig()
    colors = model_colors(list(data["models"]))
    styles = model_linestyles(list(data["models"]))
    for model, d in data["models"].items():
        bands = percentiles_fn(d["runs"])
        if not bands:
            continue
        c = colors[model]
        e = bands["epochs"]
        ax.fill_between(e, bands["p5"], bands["p95"], color=c, alpha=0.08,
                        linewidth=0)
        ax.fill_between(e, bands["p25"], bands["p75"], color=c, alpha=0.2,
                        linewidth=0)
        ax.plot(e, bands["median"], color=c, linewidth=2, label=model,
                linestyle=styles[model])
    _style_axes(ax, "epoch", "test accuracy (%)")
    ax.legend(fontsize=7, frameon=False, labelcolor=TEXT)
    ax.set_title("Test accuracy across seeds (median, p25–75, p5–95)",
                 color=TEXT, fontsize=10)
    return fig


def plot_training_curves(data: Dict[str, Any]):
    """Small multiples: one panel per model, every run's train/test curve."""
    models = [m for m, d in data["models"].items() if d["runs"]]
    if not models:
        return None
    cols = min(3, len(models))
    rows = -(-len(models) // cols)
    fig, axes = _pyplot().subplots(rows, cols, figsize=(4.2 * cols, 3.2 * rows),
                             facecolor=SURFACE, squeeze=False)
    colors = model_colors(models)
    for ax in axes.ravel():
        ax.set_visible(False)
    for i, model in enumerate(models):
        ax = axes[i // cols][i % cols]
        ax.set_visible(True)
        c = colors[model]
        for run in data["models"][model]["runs"]:
            ep = run.get("per_epoch", [])
            xs = [e["epoch"] for e in ep]
            ax.plot(xs, [e["test_accuracy"] for e in ep], color=c,
                    linewidth=1.6, alpha=0.9)
            ax.plot(xs, [e["train_accuracy"] for e in ep], color=c,
                    linewidth=1.2, alpha=0.45, linestyle="--")
        ax.set_title(model, color=TEXT, fontsize=9)
        _style_axes(ax, "epoch", "accuracy (%)")
    fig.suptitle("Training curves — solid: test, dashed: train (all runs)",
                 color=TEXT_2, fontsize=9)
    fig.tight_layout()
    return fig


def plot_efficiency_bars(rows: List[Dict[str, Any]]):
    """Throughput + latency horizontal bars."""
    fig, axes = _new_fig(12, 0.6 + 0.5 * len(rows), ncols=2)
    labels = [r["model"] for r in rows]
    colors = model_colors(labels)
    cs = [colors[m] for m in labels]
    axes[0].barh(labels, [r["throughput_img_s"] or 0 for r in rows],
                 color=cs, height=0.6)
    axes[0].set_title("throughput (img/s)", color=TEXT, fontsize=9)
    axes[1].barh(labels, [r["latency_ms"] or 0 for r in rows],
                 color=cs, height=0.6)
    axes[1].set_title("latency (ms/batch)", color=TEXT, fontsize=9)
    for a in axes:
        _style_axes(a)
    fig.tight_layout()
    return fig


def plot_efficiency_scatter(rows: List[Dict[str, Any]]):
    """Accuracy vs throughput, std error bars, direct labels."""
    pts = [r for r in rows
           if r.get("throughput_img_s") and r.get("test_accuracy_mean")]
    if not pts:
        return None
    fig, ax = _new_fig(8, 5.5)
    colors = model_colors([r["model"] for r in pts])
    # stagger label offsets by accuracy rank so near-coincident points don't
    # collide (labels alternate above-right / below-left)
    order = sorted(range(len(pts)), key=lambda i: pts[i]["test_accuracy_mean"])
    offsets = {}
    for rank, i in enumerate(order):
        offsets[i] = (8, 6) if rank % 2 == 0 else (-8, -12)
    for i, r in enumerate(pts):
        c = colors[r["model"]]
        ax.errorbar(r["throughput_img_s"], r["test_accuracy_mean"],
                    yerr=r.get("test_accuracy_std") or 0,
                    fmt="o", color=c, markersize=9, capsize=3,
                    markeredgecolor=SURFACE, markeredgewidth=1.5)
        dx, dy = offsets[i]
        ax.annotate(r["model"],
                    (r["throughput_img_s"], r["test_accuracy_mean"]),
                    xytext=(dx, dy), textcoords="offset points",
                    fontsize=7.5, color=TEXT,
                    ha="left" if dx > 0 else "right")
    _style_axes(ax, "throughput (img/s)", "test accuracy (%)")
    ax.set_title("Efficiency frontier: accuracy vs throughput",
                 color=TEXT, fontsize=10)
    return fig


def plot_convergence(data: Dict[str, Any], convergence_fn,
                     thresholds=(90, 95, 99)):
    """Epochs-to-threshold, aggregated over ALL runs per model: mean bars +
    per-run dots. Runs that never reach a
    threshold are drawn as a hatched full-height bar."""
    models = [m for m, d in data["models"].items() if d["runs"]]
    if not models:
        return None
    per_model = {}
    max_epochs = 1
    for model in models:
        vals = {th: [] for th in thresholds}
        for run in data["models"][model]["runs"]:
            accs = [e["test_accuracy"] for e in run.get("per_epoch", [])]
            if not accs:
                continue
            max_epochs = max(max_epochs, len(accs))
            conv = convergence_fn(accs)
            for th in thresholds:
                vals[th].append(conv.get(f"epochs_to_{int(th)}"))
        per_model[model] = vals

    # thresholds are the 3 series (all-pairs safe); models on the x axis
    fig, ax = _new_fig(max(7, 1.4 * len(models) + 2), 4.5)
    width = 0.26
    xs = np.arange(len(models))
    for j, th in enumerate(thresholds):
        color = PALETTE[j]
        offs = (j - (len(thresholds) - 1) / 2) * width
        for i, model in enumerate(models):
            raw = per_model[model][th]
            reached = [v for v in raw if v is not None]
            x = xs[i] + offs
            if reached:
                ax.bar(x, float(np.mean(reached)), width * 0.92, color=color,
                       label=f"to {th}%" if i == 0 else None)
                ax.plot([x] * len(reached), reached, "o", color=TEXT,
                        markersize=3, alpha=0.6)
            elif raw:  # runs exist but none reached the threshold
                ax.bar(x, max_epochs, width * 0.92, color="none",
                       edgecolor=color, hatch="///", linewidth=1,
                       label=f"to {th}%" if i == 0 else None)
    ax.set_xticks(xs)
    ax.set_xticklabels(models, fontsize=7, rotation=12, color=TEXT)
    _style_axes(ax, "", "epochs to reach threshold")
    ax.set_title("Convergence (dots: individual runs; hatched: not reached)",
                 color=TEXT, fontsize=10)
    ax.legend(fontsize=7, frameon=False, labelcolor=TEXT)
    return fig
