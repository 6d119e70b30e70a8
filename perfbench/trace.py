"""The traced run: torch.profiler over the measured window, reduced to what
the per-layer readers need.

The harness marks its own host spans (`perfbench.window` around the whole
window, `perfbench.call` around each call into the program,
`perfbench.wait` where the host waits for an earlier call, and
`perfbench.close` for the closing read). From the profiler's device events
(kernels, copies and sets, also those a CUDA-graph replay runs) inside the
window it takes the busy time (the union of their intervals), each
kernel's time, the operations that took most time, and the longest idle
gaps, each named by the innermost harness span the host was in when the gap
began. A reader sums the kernel groups it names (`kernel_groups/`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import spec

SPAN = "perfbench."


@dataclass
class Trace:
    """What one traced window holds. Times in seconds."""

    window_s: float
    busy_s: float
    steps: int
    kernels: Dict[str, float]  # seconds of each device op's name
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def group_s(self, *names: str) -> float:
        """Seconds of the kernels that the named groups hold; a kernel that
        two groups hold is an error (`spec.classify`)."""
        groups = spec.kernel_groups()
        return sum(s for k, s in self.kernels.items() if spec.classify(k, groups) in names)

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for name, seconds in self.kernels.items():
            short = name if len(name) <= 96 else name[:93] + "..."
            by_name[short] = by_name.get(short, 0.0) + seconds
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def reduce_events(device: List[Tuple[str, int, int]], host: List[Tuple[str, int, int]],
                  steps: int) -> Optional[Trace]:
    """A Trace from device events and host spans, each (name, start_ns,
    end_ns), clipped to the `perfbench.window` span; None without it."""
    windows = [(s, e) for n, s, e in host if n == SPAN + "window"]
    if not windows:
        return None
    w0, w1 = windows[0]
    inside = sorted((max(s, w0), min(e, w1), n) for n, s, e in device if e > w0 and s < w1)
    kernels: Dict[str, float] = {}
    for s, e, n in inside:
        kernels[n] = kernels.get(n, 0.0) + (e - s) * 1e-9
    busy, gaps, edge = 0, [], w0
    spans = sorted((s, e, n) for n, s, e in host if n.startswith(SPAN))
    for s, e, _ in inside:
        if s > edge:
            gaps.append((_label(spans, edge), (s - edge) * 1e-9))
        busy += max(0, e - max(s, edge))
        edge = max(edge, e)
    if w1 > edge:
        gaps.append((_label(spans, edge), (w1 - edge) * 1e-9))
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, steps=steps,
                 kernels=kernels, gaps=gaps)


def _label(spans, t: int) -> str:
    inner = [(s, n) for s, e, n in spans if s <= t < e]
    return max(inner)[1] if inner else "host outside the harness's spans"


class Tracer:
    """torch.profiler around the window when `enabled`; `span(name)` marks a
    harness span (a no-op untraced)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN + name)

    def events(self):
        """(device events, host spans), each [(name, start_ns, end_ns)]."""
        from torch.autograd import DeviceType

        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            s = e.start_ns()
            item = (e.name(), s, s + e.duration_ns())
            if item[0].startswith(SPAN):
                # a harness span; on the device's timeline too, as an annotation
                if e.device_type() != DeviceType.CUDA:
                    host.append(item)
            elif e.device_type() == DeviceType.CUDA:
                device.append(item)
        return device, host
