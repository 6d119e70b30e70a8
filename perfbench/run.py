#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the card of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell (its configuration, its traffic mix, weights and inputs
from --seed), warms up every shape it uses, measures for --seconds, checks
the timed path against the plain reference, and prints one JSON line last
on standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics from a
torch.profiler trace of the window), `device`, with --trace 1 `breakdown`,
and last `compared`, each number the check compared beside its limit,
which are also the last lines on standard error. Progress goes to standard
error. It fails, printing no result, without a CUDA card, with fewer cards
than the cell asks for, on a card that has no row in `peaks.json`, and when
`jax`, `jaxlib`, `flax` or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import time

CLOCK_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "efficient_rpe_vit_tpu"}


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no library loads JAX."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(f"[perfbench {time.perf_counter() - CLOCK_START:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell, out: dict, card: str, trace: bool) -> dict:
    device = {"platform": "gpu", "kind": card, "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"], "device": device}
    if trace:
        t = out["trace"]
        device["busy_s"] = t.busy_s if t else 0.0
        device["window_s"] = t.window_s if t else out["window_s"]
        if t is not None:
            line["breakdown"] = t.breakdown()
    from perfbench import check

    line["compared"] = check.compared(out["numbers"], out["limits"])
    return line


def main(argv=None) -> int:
    _environment()
    args = parse(argv)
    from perfbench import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device is available: this benchmark measures the card and never "
            "falls back to the CPU")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} asks for {cell.chips} cards, this machine has "
            f"{torch.cuda.device_count()}")
        return 2
    card = torch.cuda.get_device_name(0)
    peaks = spec.peaks()
    if card not in peaks:
        log(f"no peak for the card {card!r} in perfbench/peaks.json")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(f"{cell.name}: config {cell.entry['config']}, traffic {cell.entry['traffic']}, "
        f"seed {args.seed}, {args.seconds:g} s, trace {args.trace}")
    out = spec.runner(cell.mix["kind"]).run(cell, args.seed, args.seconds, bool(args.trace),
                                            CLOCK_START, device, peaks[card])
    found = forbidden_modules()
    if found:
        log(f"loaded in this process once the window closed: {found}")
        return 3
    log(f"card: {_power_limit()}; set-up {out['setup_s']:.3f} s, window "
        f"{out['window_s']:.3f} s, {out['attempted']} steps")
    line = result_line(cell, out, card, bool(args.trace))
    for name, item in line["compared"].items():
        print(f"compared {name} {item['value']!r} limit {item['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:  # no result line on any failure
        import traceback

        traceback.print_exc()
        log(f"failed: {type(e).__name__}: {e}")
        code = 1
    sys.exit(code)
