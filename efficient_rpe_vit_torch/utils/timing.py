"""Device timing utilities.

Counterpart of `efficient_rpe_vit_tpu/utils/timing.py`. On the GPU a call
returns before the device finishes, so a time is taken with CUDA events
around a chain of calls after a warm-up, and `fetch_barrier` (a value
fetched to the host) ends work that has to be finished. On the CPU the
same functions take the host clock: such a time is the CPU's, never a
device measurement.
"""

from __future__ import annotations

import subprocess
import time
from typing import Any, Callable, Dict, Union

import torch


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def fetch_barrier(value) -> float:
    """Reduce every tensor in `value` (nested tuples, lists, dicts) to one
    scalar, sum |x|, and fetch it to the host: the work that produced them
    has finished when this returns."""
    return float(sum(t.detach().float().abs().sum() for t in _tensors(value)))


def chained_time(fn: Callable, args: tuple, steps: int,
                 feedback: Callable[[tuple, Any], tuple], repeats: int = 3) -> float:
    """Median seconds per call over `repeats` chains of `steps` calls.

    `feedback(cur_args, out) -> next_args` makes each call's inputs depend on
    the previous output. One call warms up (and builds the kernels). On CUDA
    tensors each chain is timed with CUDA events; otherwise with the host
    clock.
    """
    out = fn(*args)
    fetch_barrier(out)
    cuda = any(t.is_cuda for t in _tensors(args))
    times = []
    for _ in range(repeats):
        cur = args
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        for _ in range(steps):
            out = fn(*cur)
            cur = feedback(cur, out)
        if cuda:
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / steps)
        else:
            times.append((time.perf_counter() - t0) / steps)
    return sorted(times)[len(times) // 2]


def device_memory_stats(device: Union[str, torch.device, None] = None) -> Dict[str, int]:
    """Device memory counters in bytes (in use, peak since the last
    `torch.cuda.reset_peak_memory_stats`, the card's total); {} for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }


def device_label(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (its first card), or a
    CPU label."""
    if device.type != "cuda":
        return "cpu (host clock, not a device measurement)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def format_time(seconds: float) -> str:
    """Format seconds as an h/m/s string."""
    if seconds < 60:
        return f"{seconds:.1f}s"
    if seconds < 3600:
        m, s = divmod(seconds, 60)
        return f"{int(m)}m {s:.0f}s"
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    return f"{int(h)}h {int(m)}m {s:.0f}s"
