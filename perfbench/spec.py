"""`BENCHMARK.json` and the files it names, found by name.

Everything a cell needs is looked up here from the names in
`BENCHMARK.json`: its configuration (`configs/<config>.json`), its traffic
mix (`mixes/<traffic>.json`), its correctness limits
(`limits/<workload>.json`), its model by the configuration's `family`
(`families/`, `reference/` and `counts/<family>.py`), the readers of its
per-layer metrics (`metrics/<metric>.py`) and the kernel-name groups
(`kernel_groups/*.json`), which the readers name.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return load_json(BENCHMARK)


def load_module(path: Path) -> ModuleType:
    """Import a file by its path (metric readers are named after metrics,
    whose names hold dots)."""
    name = "perfbench_" + re.sub(r"\W", "_", str(path.relative_to(HERE)))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def config_file(name: str) -> Path:
    return HERE / "configs" / f"{name}.json"


def mix_file(name: str) -> Path:
    return HERE / "mixes" / f"{name}.json"


def limits_file(workload: str) -> Path:
    return HERE / "limits" / f"{workload}.json"


def metric_file(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def kernel_groups() -> List[dict]:
    """Every group of `kernel_groups/`. A group holds the kernels whose name
    contains one of its `patterns` and none of its `unless` patterns; no
    two groups may hold one kernel (`classify`), so a group added later can
    take no kernel from a group that is there."""
    return [load_json(p) for p in sorted((HERE / "kernel_groups").glob("*.json"))]


def holds(group: dict, kernel: str) -> bool:
    return (any(p in kernel for p in group["patterns"])
            and not any(p in kernel for p in group.get("unless", ())))


def classify(kernel: str, groups: List[dict]) -> Optional[str]:
    """The one group of `groups` that holds `kernel`, or None. A kernel that
    two of them hold is an error, and fails the traced run."""
    names = [g["name"] for g in groups if holds(g, kernel)]
    if len(names) > 1:
        raise ValueError(f"kernel {kernel!r} is in the groups {names}: their patterns overlap")
    return names[0] if names else None


@dataclass
class Cell:
    """One entry of `workloads`, with everything it names loaded."""

    name: str
    entry: dict
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _applies(metric: dict, workload: str, reported: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def load_cell(workload: str, bench: dict = None) -> Cell:
    bench = bench if bench is not None else load_benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(entries)}")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    mix = load_json(mix_file(entry["traffic"]))
    limits = load_json(limits_file(workload))
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, reported)]
    return Cell(workload, entry, config, mix, limits, e2e, per_layer)


def reader(metric: str) -> ModuleType:
    """The reader of a per-layer metric: a module with
    `read(trace, run) -> float | None`."""
    return load_module(metric_file(metric))


def counts(attention: str) -> ModuleType:
    """The frozen FLOP and roofline arithmetic of an attention kind:
    `counts/<attention>.py`."""
    return importlib.import_module(f"perfbench.counts.{attention}")


@dataclass(frozen=True)
class Family:
    """The three modules of a model family F, each named after it:

    * `program`, `families/F.py`, the port's side (it may import the port,
      inside its functions only): `build(config, mix, device, generator) ->
      (model, experiment_config)`, the port's model for the configuration
      with its weights still to be loaded by name, and `tiny(config, mix) ->
      (config, mix)`, the sizes the CPU tests run the family at;
    * `reference`, `reference/F.py`, the plain model (nothing of the port):
      `parameter_spec(config, mix) -> [(name, shape, init)]` (the names the
      program's leaves have), `trains(init) -> bool`, `forward(w, x, config,
      prods) -> logits` and `block_rows(config, mix, budget_bytes) -> rows`;
    * `counts`, `counts/F.py`, its frozen arithmetic: `shape(config, mix)`
      and `train_flops_per_step(config, mix)`.
    """

    name: str
    program: ModuleType
    reference: ModuleType
    counts: ModuleType


def families() -> List[str]:
    """The families on disk: the files of `families/`."""
    return sorted(p.stem for p in (HERE / "families").glob("*.py") if p.stem != "__init__")


def family(config: dict) -> Family:
    """The model family the configuration names (its `family`)."""
    name = config["family"]
    modules = []
    for package in ("families", "reference", "counts"):
        module = f"perfbench.{package}.{name}"
        try:
            modules.append(importlib.import_module(module))
        except ModuleNotFoundError as e:
            if e.name != module:
                raise
            raise KeyError(f"no model family {name!r}: {package}/{name}.py is missing; the "
                           f"families are {families()}") from None
    return Family(name, *modules)


def runner(kind: str) -> ModuleType:
    """What runs a kind of traffic (`runners/<kind>.py`): a module with
    `run(cell, seed, seconds, trace, clock_start, device, peak) -> result`."""
    return importlib.import_module(f"perfbench.runners.{kind}")


def peaks() -> Dict[str, dict]:
    return load_json(HERE / "peaks.json")["cards"]
