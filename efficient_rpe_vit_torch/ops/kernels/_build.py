"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `build/efficient_rpe_vit_torch/<name>-<hash>.so` at the repository
root, the hash covering the source, the shared headers (`csrc/*.cuh`) and
the flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built when a module is imported: `load` builds on first use,
and `build` compiles several sources at once, one nvcc process each, all
started together. `launch` calls a built launcher on the current stream.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "efficient_rpe_vit_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha1(
        b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (every `csrc/*.cu` when None) that have no
    up-to-date library yet, in parallel.

    Returns:
        name -> nvcc's output (register and shared-memory use per kernel)
        for each source compiled by this call.
    Raises:
        RuntimeError: naming every source that failed, with its output.
    """
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    missing = [n for n in names if not library_path(n).exists()]
    if not missing:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in missing:
        target = library_path(name)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in running.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, target)  # atomic: concurrent builds agree
        else:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, building it if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def on_cpu(t: torch.Tensor) -> bool:
    """True for CPU tensors (a kernel wrapper then takes the plain version);
    raises for devices other than CPU and CUDA."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def dtype_suffix(dtype: torch.dtype) -> str:
    """The C launcher's suffix for an input dtype: bf16 or f32."""
    return "bf16" if dtype == torch.bfloat16 else "f32"


# what a built library's *_launch_info entry point writes, in this order,
# followed by 1 for a register-resident mma.sync kernel (0: a staged one)
LAUNCH_INFO_KEYS = ("rows", "threads", "smem_bytes", "blocks_per_sm", "registers",
                    "spill_bytes")


def launch_info_buffer():
    """The int array a *_launch_info entry point fills."""
    return (ctypes.c_int * (len(LAUNCH_INFO_KEYS) + 1))()


def launch_info_dict(info) -> dict:
    """A filled buffer as {key: value} under LAUNCH_INFO_KEYS, plus
    "kernel": "mma.sync" or "staged"."""
    return {**dict(zip(LAUNCH_INFO_KEYS, info)),
            "kernel": "mma.sync" if info[len(LAUNCH_INFO_KEYS)] else "staged"}


def launch(errors, name: str, fn, device: torch.device, *args) -> None:
    """Call one C launcher with `args` and then the current stream of
    `device`: tensors go as their data pointers, None as a null pointer,
    numbers as they are (the launcher's argtypes convert them). Raises if
    the launch was refused, naming the error `errors(code)` gives."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                 stream)
    if err != 0:
        shape = [tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args]
        raise RuntimeError(f"{name} launch refused at {shape}: CUDA error {err} "
                           f"({errors(err).decode()})")
