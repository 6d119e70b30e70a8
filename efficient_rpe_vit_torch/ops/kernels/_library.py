"""The port's `torch.library` namespace: the forward kernels as custom ops.

Each op has three implementations: for CPU tensors the kernel's plain
version, for CUDA tensors the launch of the hand-written kernel (counted in
its wrapper's `.launches`; it launches or raises, never falling back), and
a fake one that gives the outputs' shapes and dtypes from the inputs'
without reading a size into Python. So `torch.export` traces a model
through the op with a symbolic batch and keeps it as one node of the
exported graph, and a program exported on the CPU launches the kernels once
it is moved to the card.

A program holding these nodes needs the namespace registered before it is
loaded: importing `efficient_rpe_vit_torch.ops.kernels` (or
`efficient_rpe_vit_torch.serve`) does it. The ops are registered through
`torch.library.Library` per dispatch key, the route with the least Python
between the caller and the kernel.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

NAMESPACE = "efficient_rpe_vit"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, schema: str, cpu: Callable, cuda: Callable,
           fake: Callable) -> torch._ops.OpOverload:
    """Define `NAMESPACE::name` with `schema` (its arguments and returns,
    e.g. "(Tensor x, float s) -> Tensor") and its CPU, CUDA and fake
    implementations. Returns the op's default overload, the cheapest handle
    to call."""
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


@contextlib.contextmanager
def real_constants():
    """Build tensors here as real, normal tensors: outside inference mode
    (a cached inference tensor could not be saved for a later backward) and
    outside any fake or tracing mode (`torch.export` traces under one, and
    a constant cached there would be a fake tensor, poisoning every later
    call). A real tensor that a trace then reads is lifted into the
    exported program as a constant."""
    from torch.utils._python_dispatch import _disable_current_modes

    with torch.inference_mode(False), _disable_current_modes():
        yield
