#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds <n> ... \\
        [--control-seeds <n> ...] [--out FILE]

In one process on the card, at the cell's own sizes:

* the program: for each of --seeds a whole run of the cell with a window of
  one call, giving the numbers the check compares (`check.py`): their
  largest over the seeds is each number's lower reading;
* the control and the planted faults: for each of --control-seeds the plain
  reference put in the program's place, computed in float8
  (`reference/precision.py`), and with half of each batch left out or one
  answer altered (`reference/train.py`), each compared with the float32
  reference as the program is. The smallest reading of each is an upper
  reading. A step that returns its state unchanged reads 1 by the check's
  measure (its change and its first moment are 0) and needs no run.

It prints one JSON line per reading as it goes, and the whole at the end;
`--out` also writes it there. It runs only on a CUDA card, whose name
it records with the readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FAULTS = ("fp8", "half", "answer")


def stand_in_readings(cell, seed: int, device) -> dict:
    """{control or fault: numbers} for one seed, the reference in the
    program's place."""
    import torch

    from perfbench import check, spec
    from perfbench.runners.train import CHECKED_STEPS
    from perfbench.reference import train as reference
    from perfbench.weights import chunks, make_images, make_weights

    config, mix = cell.config, cell.mix
    leaves = spec.family(config).reference.parameter_spec(config, mix)
    weights = {n: t.to("cpu") for n, t in make_weights(leaves, seed, device).items()}
    images, labels = make_images(mix["held_images"], mix["image_size"], config["in_channels"],
                                 config["num_classes"], seed, device)
    first = next(chunks(mix["held_images"], mix["batch"], mix["fused_steps"], seed))
    batches = []
    for r in first[:CHECKED_STEPS]:
        rows = torch.as_tensor(r, device=device).long()
        batches.append((images[rows].clone(), labels[rows].clone()))
    del images, labels
    ref = reference.run_steps(config, mix, weights, batches, device)
    out = {}
    for fault in FAULTS:
        precision = "fp8" if fault == "fp8" else "fp32"
        stand_in = reference.run_steps(config, mix, weights, batches, device, precision,
                                       None if fault == "fp8" else fault)
        out[fault] = check.training_numbers(stand_in, ref)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import gc

    import torch

    from perfbench import spec

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the readings are taken on the card only")
    device = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(device)
    cell = spec.load_cell(args.workload)
    peak = spec.peaks()[card]
    runner = spec.runner(cell.mix["kind"])
    result = {"workload": cell.name, "card": card, "program": {}, "stand_ins": {}}

    def emit(kind, seed, numbers):
        print(json.dumps({"workload": cell.name, "kind": kind, "seed": seed, **numbers}),
              flush=True)

    for seed in args.seeds:
        t = time.perf_counter()
        out = runner.run(cell, seed, 0.0, False, t, device, peak)
        result["program"][seed] = dict(out["numbers"], setup_s=out["setup_s"])
        emit("program", seed, result["program"][seed])
        del out
        gc.collect()
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        readings = stand_in_readings(cell, seed, device)
        result["stand_ins"][seed] = readings
        for fault, numbers in readings.items():
            emit(fault, seed, numbers)
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
