"""Spans of the train step, for the profiler, the benchmark and operators.

Off unless `enable(True)` turns it on for the process, as the train CLI's
`--profile` does for its profiled epoch. Off, `span` and
`device_span` return one shared no-op context after a single flag test,
record nothing and launch nothing.

Host spans (`span(name)`): each is kept in memory as (name, parent,
start_ns, end_ns), `parent` being the innermost host span open on the same
thread (None at the top), and is opened as a `torch.profiler`
`record_function` range, so a running profiler holds it too. The times are
`time.time_ns()`, the wall clock the profiler stamps its host and device
events with, so the two copies of a span and the device events share one
clock. `spans()` returns the list and `clear()` empties it.

Device spans (`device_span(name, device)`): on the GPU an empty marker
kernel on the current stream at entry and another at exit
(`csrc/trace_marks.cu`: `rpe_mark_begin_<span>` and `rpe_mark_end_<span>`
for the span `rpe.<span>`). Launched during a CUDA-graph capture they
become nodes of the graph, so every replay puts them into the profiler's
device trace between the step's own kernels; a host span cannot do that,
since the step's Python runs only at capture. A reader of the trace opens
the span at its begin marker and closes it at its end marker. A graph
holds the markers if tracing was on when it was captured. On the CPU a
marker is kept in memory instead (`marks()`), in launch order. A device
span also opens a host span of its name. One opened while autograd runs a
backward (a checkpoint recomputing its region) marks nothing: its work
lies inside the backward span around it.

A region whose backward is bracketed too passes its input tensors through
`inputs(...)` and its output tensors through `outputs(...)` of the span:
identity autograd functions whose backwards launch the `<span>_bwd`
markers, the outputs' opening that span and the inputs' closing it, once
per region.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import time
from typing import List, Optional, Tuple

import torch

PREFIX = "rpe."
# the device spans, each with a begin and an end marker kernel
DEVICE_SPANS = ("gather", "forward", "backward", "optimizer", "phi", "phi_bwd",
                "window", "window_bwd", "relpos", "relpos_bwd", "attn_window",
                "attn_window_bwd", "attn_global", "attn_global_bwd")
MARKERS = tuple(f"rpe_mark_{edge}_{span}" for span in DEVICE_SPANS
                for edge in ("begin", "end"))

_on = False
_spans: List[Tuple[str, Optional[str], int, int]] = []
_marks: List[str] = []
_open = threading.local()  # the names of the host spans open on this thread


def enable(on: bool) -> None:
    """Turn tracing on or off for the process."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def spans() -> List[Tuple[str, Optional[str], int, int]]:
    """The host spans closed since the last `clear`, in the order they
    closed: (name, parent, start_ns, end_ns)."""
    return _spans


def marks() -> List[str]:
    """The markers of the device spans run on the CPU, in order."""
    return _marks


def clear() -> None:
    _spans.clear()
    _marks.clear()


class _Off:
    """What `span` and `device_span` return while tracing is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def inputs(self, *tensors):
        return tensors

    def outputs(self, *tensors):
        return tensors


_OFF = _Off()


class _HostSpan:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "names", None)
        if stack is None:
            stack = _open.names = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.range.__exit__(*exc)
        _open.names.pop()
        _spans.append((self.name, self.parent, self.start, end))
        return False


def span(name: str):
    """A host span `name` (a context manager)."""
    if not _on:
        return _OFF
    return _HostSpan(name)


@functools.cache
def _library():
    """The built marker library and each marker's index in it."""
    from ..ops.kernels import _build

    lib = _build.load("trace_marks")
    lib.rpe_mark_count.argtypes = []
    lib.rpe_mark_count.restype = ctypes.c_int
    lib.rpe_mark_name.argtypes = [ctypes.c_int]
    lib.rpe_mark_name.restype = ctypes.c_char_p
    lib.rpe_mark_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.rpe_mark_launch.restype = ctypes.c_int
    lib.rpe_mark_error_string.argtypes = [ctypes.c_int]
    lib.rpe_mark_error_string.restype = ctypes.c_char_p
    return lib, {lib.rpe_mark_name(i).decode(): i for i in range(lib.rpe_mark_count())}


def _mark(name: str, device: torch.device) -> None:
    if device.type != "cuda":
        _marks.append(name)
        return
    from ..ops.kernels import _build

    lib, index = _library()
    _build.launch(lib.rpe_mark_error_string, name, lib.rpe_mark_launch, device, index[name])


class _Edge(torch.autograd.Function):
    """Identity whose backward launches the marker `name`."""

    @staticmethod
    def forward(ctx, name, device, *tensors):
        ctx.name, ctx.device = name, device
        ctx.set_materialize_grads(False)
        return tensors

    @staticmethod
    def backward(ctx, *grads):
        _mark(ctx.name, ctx.device)
        return (None, None, *grads)


class _DeviceSpan(_HostSpan):
    def __init__(self, name: str, device: torch.device):
        super().__init__(name)
        self.device = device
        self.short = name[len(PREFIX):]

    def __enter__(self):
        super().__enter__()
        _mark(f"rpe_mark_begin_{self.short}", self.device)
        return self

    def __exit__(self, *exc):
        _mark(f"rpe_mark_end_{self.short}", self.device)
        return super().__exit__(*exc)

    def inputs(self, *tensors):
        return _Edge.apply(f"rpe_mark_end_{self.short}_bwd", self.device, *tensors)

    def outputs(self, *tensors):
        return _Edge.apply(f"rpe_mark_begin_{self.short}_bwd", self.device, *tensors)


def device_span(name: str, device: torch.device):
    """A device span `name` (`rpe.<one of DEVICE_SPANS>`) on `device`, with
    `inputs` / `outputs` for its backward (a context manager)."""
    if not _on or torch._C._current_graph_task_id() != -1:
        return _OFF
    return _DeviceSpan(name, torch.device(device))
