"""Tile-shape trial of the register-resident kernels on the card.

Each kernel's shipped instantiation (the tile shape its launcher takes) is
timed against the alternatives below, each built from a copy of `csrc/`
with the instantiation swapped, at the main paths' shapes:

    flash_bwd_fused    (64, 12, 197, 64) bf16, dropout 0: 13 warps against
                       32-row query tiles (shipped) or 16-row ones
    mlc_bwd_dkv        (64, 12, 197, 266, 64) and (4, 12, 4097, 266, 64)
                       bf16: 64 key/value rows per block (16 warps, shipped)
                       or 32 (8 warps, two blocks per SM)
    mlc_bwd_dc         the same two shapes: 128 query rows per block (8
                       warps, shipped) or 64 (4 warps), against key/value
                       stages of 64 rows (shipped) or 32 (two per window
                       tile)
    mlc_bwd_dq         the same two shapes: 128 query rows per block (16
                       warps, two per 16 rows) against key/value stages of
                       64 rows (shipped) or 32; 64 query rows (16 warps,
                       four per 16 rows) or 32 (8 warps, four per 16 rows,
                       two blocks per SM) against 64-row stages
    mlc_fwd            the same two shapes: 128 query rows per block (8
                       warps, shipped) or 64 (4 warps), against key/value
                       stages of 64 rows (shipped) or 32, with q' held as
                       mma A fragments in registers (shipped) or read by
                       ldmatrix from shared memory at every 16-step
    kfp_fwd            (32, 12, 197, 64, 266) and (64, 12, 197, 64, 266)
                       bf16, phi+: 128 query rows per block (8 warps,
                       shipped) or 64 (4 warps), against key/value stages
                       of 64 rows (shipped) or 32; a head's query blocks in
                       clusters of two that share each stage's phi_k
                       (shipped) or each block building all of it; phi_k
                       by all 8 warps (shipped, maxima exchanged between
                       the warps of a tile) or by 4; u held in registers
                       from the max pass to the phi pass (shipped) or
                       projected again
    rot_fwd            (32, 12, 197, 64), (64, 12, 197, 64) and (4, 12, 4097,
                       64) bf16, keep_cls: 128 rows per block (8 warps,
                       shipped) or 64 (4 warps); a two-stage ring of each
                       warp's rows (shipped), one stage (no prefetch) or
                       three; batch groups aiming at 2 x 132 blocks
                       (shipped), 132 or 4 x 132
    rot_bwd            (64, 12, 197, 64) and (4, 12, 4097, 64) bf16,
                       keep_cls: the same, batch groups aiming at one
                       block per (head, row tile) (no partial sums), and
                       registers capped for more resident warps (64 rows
                       at 3 blocks per SM, 128 rows at 2)
    mlt_fwd, mlt_bwd_dq, mlt_bwd_dkv, mlt_bwd_dt
                       the materialised-T kernels (#4, #5) at the pallas_ab
                       shapes (256, 2, 197, 44, 16), (8, 2, 1024, 44, 16),
                       (32, 4, 512, 128, 64) and at (4, 12, 4097, 266, 64),
                       bf16, T not Toeplitz: the forward and dq with T
                       loaded by each thread into registers in the
                       accumulator layout a stage ahead where N % 4 != 0
                       and staged in the ring elsewhere (shipped), or one
                       way at every N; 128 query rows (shipped) or 64 for
                       the forward, dq and dT, 64 key/value rows (shipped)
                       or 32 for dkv; the narrow instantiations (shipped)
                       or the 272 / 64 one for every (F, D); dT's batch
                       groups by the waves rule (shipped) or one group, and
                       its narrow kernel at two blocks per SM (shipped) or
                       one

Every variant is first held against the kernel's plain version (max
|err| / max |plain|), then timed as chip_smoke.py times kernels: calls
captured in one CUDA graph, replayed, in two rounds. Where the wrapper
module reports it (`launch_info`), each variant's rows per block, threads,
shared memory, blocks per SM, registers and spilled bytes are printed
first. Run it on the GPU as

    python -m efficient_rpe_vit_torch.experiments.tile_trial [--kernel K ...]

(every kernel above unless `--kernel` names some). The first line printed
is the card's name and power limit; the build goes under build/tile_trial/
at the repository root.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from typing import Callable, Dict, List, Tuple

import torch

from ..ops.kernels import _build
from ..ops.kernels import circulant_rotate as cr
from ..ops.kernels import flash_attention as fa
from ..ops.kernels import masked_linear as ml
from ..ops.kernels import masked_linear_coeffs as mlc
from ..utils.timing import device_label

TRIAL_DIR = _build.BUILD_DIR.parent / "tile_trial"

# kernel -> (source, wrapper module, its library loader, {variant: [(shipped
# text, variant text)]}); the first variant is the shipped one
_FUSED = "flash_bwd_fused_mma_kernel<64, 13, 32>"
_DKV = "mlc_bwd_dkv_mma_kernel<272, 64, 64>"
_DC = "DcMma<272, 64, 128, 64>"
_DQ = "DqMma<272, 64, 128, 2, 64>"
_FWD = "FwdMma<272, 64, 128, 64, true>"
_KFP = "FusedMma<272, 64, 128, 64, 4, true, 2>"
VARIANTS = {
    "flash_bwd_fused": ("flash_attention_bwd", fa, "_bwd_lib", {
        "13 warps x 32-row q tiles": [],
        "13 warps x 16-row q tiles": [
            (_FUSED, _FUSED.replace("32>", "16>")),
            ("FusedMma<64, 13, 32>", "FusedMma<64, 13, 16>")],
    }),
    "mlc_bwd_dkv": ("masked_linear_coeffs_bwd", mlc, "_bwd_kernel_fns", {
        "64 kv rows, 16 warps": [],
        "32 kv rows, 8 warps": [
            (_DKV, _DKV.replace("64>", "32>")),
            ("DkvMma<272, 64, 64>", "DkvMma<272, 64, 32>")],
    }),
    "mlc_bwd_dc": ("masked_linear_coeffs_bwd", mlc, "_bwd_kernel_fns", {
        "128 q rows (8 warps), 64-row kv stages": [],
        "128 q rows (8 warps), 32-row kv stages": [(_DC, "DcMma<272, 64, 128, 32>")],
        "64 q rows (4 warps), 64-row kv stages": [(_DC, "DcMma<272, 64, 64, 64>")],
        "64 q rows (4 warps), 32-row kv stages": [(_DC, "DcMma<272, 64, 64, 32>")],
    }),
    "mlc_bwd_dq": ("masked_linear_coeffs_bwd", mlc, "_bwd_kernel_fns", {
        "128 q rows (16 warps, 2 per 16 rows), 64-row kv stages": [],
        "128 q rows (16 warps, 2 per 16 rows), 32-row kv stages": [
            (_DQ, "DqMma<272, 64, 128, 2, 32>")],
        "64 q rows (16 warps, 4 per 16 rows), 64-row kv stages": [
            (_DQ, "DqMma<272, 64, 64, 4, 64>")],
        "32 q rows (8 warps, 4 per 16 rows), 64-row kv stages": [
            (_DQ, "DqMma<272, 64, 32, 4, 64>")],
    }),
    "mlc_fwd": ("masked_linear_coeffs_fwd", mlc, "_kernel_fns", {
        "128 q rows (8 warps), 64-row kv stages, q' in registers": [],
        "64 q rows (4 warps), 64-row kv stages, q' in registers": [
            (_FWD, "FwdMma<272, 64, 64, 64, true>")],
        "128 q rows (8 warps), 32-row kv stages, q' in registers": [
            (_FWD, "FwdMma<272, 64, 128, 32, true>")],
        "64 q rows (4 warps), 32-row kv stages, q' in registers": [
            (_FWD, "FwdMma<272, 64, 64, 32, true>")],
        "128 q rows (8 warps), 64-row kv stages, q' by ldmatrix": [
            (_FWD, "FwdMma<272, 64, 128, 64, false>")],
        "64 q rows (4 warps), 64-row kv stages, q' by ldmatrix": [
            (_FWD, "FwdMma<272, 64, 64, 64, false>")],
    }),
    "kfp_fwd": ("kerple_fused_phi_fwd", mlc, "_fused_kernel_fns", {
        "128 q rows, 64-row kv stages, clusters of 2, phi_k by 8 warps, u held": [],
        "128 q rows, 64-row kv stages, clusters of 2, phi_k by 4 warps, u held": [
            (_KFP, "FusedMma<272, 64, 128, 64, 2, true, 2>")],
        "128 q rows, 64-row kv stages, clusters of 2, phi_k by 8 warps, u projected again": [
            (_KFP, "FusedMma<272, 64, 128, 64, 4, false, 2>")],
        "128 q rows, 64-row kv stages, no cluster, phi_k by 8 warps, u held": [
            (_KFP, "FusedMma<272, 64, 128, 64, 2, true, 1>")],
        "128 q rows, 64-row kv stages, no cluster, phi_k by 4 warps": [
            (_KFP, "FusedMma<272, 64, 128, 64, 1, false, 1>")],
        "128 q rows, 32-row kv stages, clusters of 2, phi_k by 8 warps, u held": [
            (_KFP, "FusedMma<272, 64, 128, 32, 8, true, 2>")],
        "64 q rows, 32-row kv stages, clusters of 2, phi_k by 4 warps, u held": [
            (_KFP, "FusedMma<272, 64, 64, 32, 4, true, 2>")],
        "64 q rows, 64-row kv stages, no cluster, phi_k by 4 warps": [
            (_KFP, "FusedMma<272, 64, 64, 64, 1, false, 1>")],
    }),
}


def _rot_variants(kind: str, backward: bool) -> dict:
    """The rotation kernel `kind`'s ("FWD" or "BWD") variants: rows per
    block, ring stages and the blocks its batch groups aim at; the
    backward's also one batch group and capped registers."""
    warps, stages, target = (f"constexpr int {kind}_MMA_{name} = {value};" for name, value in
                             (("WARPS", 8), ("STAGES", 2), ("TARGET", "2 * 132")))
    out = {
        "128 rows (8 warps), 2 stages, groups for 2 x 132 blocks": [],
        "64 rows (4 warps), 2 stages, groups for 2 x 132 blocks": [
            (warps, warps.replace("8;", "4;"))],
        "128 rows (8 warps), 1 stage, groups for 2 x 132 blocks": [
            (stages, stages.replace("2;", "1;"))],
        "128 rows (8 warps), 3 stages, groups for 2 x 132 blocks": [
            (stages, stages.replace("2;", "3;"))],
        "128 rows (8 warps), 2 stages, groups for 132 blocks": [
            (target, target.replace("2 * 132", "132"))],
        "128 rows (8 warps), 2 stages, groups for 4 x 132 blocks": [
            (target, target.replace("2 * 132", "4 * 132"))],
    }
    if backward:
        bounds = "__global__ void __launch_bounds__(32 * W)\nrot_bwd_mma_kernel("
        out["128 rows (8 warps), 2 stages, one group (no partial sums)"] = [
            (target, target.replace("2 * 132", "1"))]
        out["64 rows (4 warps), 2 stages, 3 blocks per SM (at most 170 registers)"] = [
            (warps, warps.replace("8;", "4;")), (bounds, bounds.replace("W)", "W, 3)"))]
        out["128 rows (8 warps), 2 stages, 2 blocks per SM (at most 128 registers)"] = [
            (bounds, bounds.replace("W)", "W, 2)"))]
    return out


VARIANTS["rot_fwd"] = ("circulant_rotate", cr, "_lib", _rot_variants("FWD", False))
VARIANTS["rot_bwd"] = ("circulant_rotate", cr, "_lib", _rot_variants("BWD", True))


def _t_usings(prefix: str, geometry: str, shipped: Dict[str, str], swap,
              treg: bool = False) -> list:
    """Swaps of the materialised-T kernels' `using {prefix}Wide/Mid/Narrow =
    {geometry}<...>;` lines (`template <bool TREG> using ...` where treg):
    swap(width, template arguments) gives each one's new arguments."""
    head = "template <bool TREG> using" if treg else "using"
    return [(f"{head} {prefix}{width} = {geometry}<{args}>;",
             f"{head} {prefix}{width} = {geometry}<{swap(width, args)}>;")
            for width, args in shipped.items()]


_TFWD = {"Wide": "272, 64, 128, 64, TREG", "Narrow": "64, 16, 128, 64, TREG"}
_TDQ = {"Wide": "272, 64, 128, 2, 64, TREG", "Mid": "128, 64, 128, 2, 64, TREG",
        "Narrow": "64, 16, 128, 2, 64, TREG"}
_TDKV = {"Wide": "272, 64, 64", "Mid": "128, 64, 64", "Narrow": "64, 16, 64"}
_TDT = {"Wide": "272, 64, 128, 64, 1", "Mid": "128, 64, 128, 64, 1",
        "Narrow": "64, 16, 128, 64, 2"}
_WIDE_ONLY = "no narrow instantiations (272 / 64 for every F, D)"
_FWD_TREG = "bool fwd_t_in_registers(int N) { return N % 4 != 0; }"
_DQ_TREG = "bool dq_t_in_registers(int N) { return N % 4 != 0; }"
_DT_GROUPS = "  for (int groups = 2; groups <= B; ++groups) {"


def _rows64(width, args):
    return args.replace(", 128, ", ", 64, ")


def _wide(shipped: Dict[str, str]):
    return lambda width, args: shipped["Wide"]


VARIANTS["mlt_fwd"] = ("masked_linear_fwd", ml, "_fwd_fns", {
    "128 q rows, T in registers where N % 4 != 0, else in the ring": [],
    "128 q rows, T staged in the ring at every N": [
        (_FWD_TREG, _FWD_TREG.replace("N % 4 != 0", "false"))],
    "128 q rows, T in registers at every N": [
        (_FWD_TREG, _FWD_TREG.replace("N % 4 != 0", "true"))],
    "64 q rows, T as shipped": _t_usings("Fwd", "TFwdMma", _TFWD, _rows64, True),
    _WIDE_ONLY: _t_usings("Fwd", "TFwdMma", _TFWD, _wide(_TFWD), True),
})
VARIANTS["mlt_bwd_dq"] = ("masked_linear_bwd", ml, "_bwd_fns", {
    "128 q rows (16 warps, 2 per 16 rows), T in registers where N % 4 != 0": [],
    "128 q rows, T staged in the ring at every N": [
        (_DQ_TREG, _DQ_TREG.replace("N % 4 != 0", "false"))],
    "128 q rows, T in registers at every N": [
        (_DQ_TREG, _DQ_TREG.replace("N % 4 != 0", "true"))],
    "64 q rows (8 warps, 2 per 16 rows, two blocks per SM)": _t_usings(
        "Dq", "TDqMma", _TDQ, _rows64, True),
    _WIDE_ONLY: _t_usings("Dq", "TDqMma", _TDQ, _wide(_TDQ), True),
})
VARIANTS["mlt_bwd_dkv"] = ("masked_linear_bwd", ml, "_bwd_fns", {
    "64 kv rows (16 warps)": [],
    "32 kv rows (8 warps, two blocks per SM)": _t_usings(
        "Dkv", "TDkvMma", _TDKV, lambda w, a: a[: a.rindex("64")] + "32"),
    _WIDE_ONLY: _t_usings("Dkv", "TDkvMma", _TDKV, _wide(_TDKV)),
})
VARIANTS["mlt_bwd_dt"] = ("masked_linear_bwd", ml, "_bwd_fns", {
    "128 q rows, the waves rule, narrow at two blocks per SM": [],
    "128 q rows, the waves rule, narrow at one block per SM": [
        ("using DtNarrow = TDtMma<64, 16, 128, 64, 2>;",
         "using DtNarrow = TDtMma<64, 16, 128, 64, 1>;")],
    "128 q rows, one group (no partial sums)": [
        (_DT_GROUPS, _DT_GROUPS.replace("groups <= B;", "groups <= 1;"))],
    "64 q rows (4 warps), the waves rule": _t_usings("Dt", "TDtMma", _TDT, _rows64),
    _WIDE_ONLY: _t_usings("Dt", "TDtMma", _TDT, _wide(_TDT)),
})
# the materialised-T kernels' shapes (B, H, N, F, D)
T_SHAPES = [(256, 2, 197, 44, 16), (8, 2, 1024, 44, 16), (32, 4, 512, 128, 64),
            (4, 12, 4097, 266, 64)]

# the launch_info name of each kernel the wrapper module reports on
LAUNCH_INFO = {"mlc_bwd_dq": "masked_linear_coeffs_bwd_dq",
               "mlc_bwd_dkv": "masked_linear_coeffs_bwd_dkv",
               "mlc_bwd_dc": "masked_linear_coeffs_bwd_dc",
               "mlc_fwd": "masked_linear_coeffs_fwd",
               "kfp_fwd": "kerple_fused_phi_fwd",
               "rot_fwd": "circulant_rotate_fwd", "rot_bwd": "circulant_rotate_bwd",
               "mlt_fwd": "masked_linear_fwd", "mlt_bwd_dq": "masked_linear_bwd_dq",
               "mlt_bwd_dkv": "masked_linear_bwd_dkv", "mlt_bwd_dt": "masked_linear_bwd_dt"}
# the sequence lengths launch_info is asked at, per kernel (default 197 and
# 4097; the materialised-T kernels at each of T_SHAPES' (N, F, D))
LAUNCH_INFO_N = {"kfp_fwd": (197,)}


def kernel_ms(fn: Callable, iters: int = 20) -> float:
    """Mean device time of one call from a CUDA-graph replay of `iters`
    calls (chip_smoke.py's timing)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def build_variants(kernels: List[str]) -> Dict[Tuple[str, str], str]:
    """{(kernel, variant): library path} of `kernels`, every variant
    compiled at once."""
    TRIAL_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for kernel in kernels:
        source, _, _, variants = VARIANTS[kernel]
        for i, (variant, swaps) in enumerate(variants.items()):
            tree = TRIAL_DIR / f"{kernel}_{i}"
            shutil.rmtree(tree, ignore_errors=True)
            shutil.copytree(_build.CSRC, tree)
            path = tree / f"{source}.cu"
            text = path.read_text()
            for shipped, swapped in swaps:
                if shipped not in text:
                    raise RuntimeError(f"{source}.cu no longer has {shipped!r}")
                text = text.replace(shipped, swapped)
            path.write_text(text)
            lib = tree / f"{source}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(path)]
            running[(kernel, variant)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), str(lib))
    libs = {}
    for key, (proc, lib) in running.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key} failed to build:\n{log[-3000:]}")
        libs[key] = lib
    return libs


def use_library(module, loader: str, path: str, originals: dict) -> None:
    """Point the wrapper module's library loader at the library `path`."""
    original = originals.setdefault((module.__name__, loader), getattr(module, loader))
    saved = module.load
    module.load = lambda name: ctypes.CDLL(path)
    try:
        lib = original.__wrapped__()
    finally:
        module.load = saved
    setattr(module, loader, lambda: lib)


def _max_rel(got, want) -> float:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
               for a, b in zip(got, want))


def _first(got):
    """The first batch element of each output."""
    return tuple(t[:1] for t in got) if isinstance(got, tuple) else got[:1]


def cases(kernels: List[str]) -> Dict[str, List[Tuple[str, Callable, Callable]]]:
    """kernel -> [(shape, kernel call, check)] on seeded inputs for
    `kernels`; check(got) is the kernel's output's max |err| / max |plain|
    against its plain version."""
    g = torch.Generator(device="cuda").manual_seed(0)
    out: Dict[str, list] = {kernel: [] for kernel in VARIANTS}
    if "flash_bwd_fused" in kernels:
        q, k, v, cot = (torch.randn(64, 12, 197, 64, generator=g, device="cuda").bfloat16()
                        for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, 0.125)
        args = (q, k, v, cot, lse, fa.flash_delta(o, cot), 0.125)
        first = tuple(t[:1] for t in args[:6]) + (0.125,)
        out["flash_bwd_fused"].append((
            "(64, 12, 197, 64)", lambda: fa.flash_attention_bwd_fused(*args),
            lambda got, first=first: _max_rel(_first(got), fa.flash_bwd_reference(*first))))
    for B, N in ((64, 197), (4, 4097)) if any(k.startswith("mlc_") for k in kernels) else ():
        qp, kp = ((torch.randn(B, 12, N, 266, generator=g, device="cuda").abs() * 0.1)
                  .bfloat16() for _ in range(2))
        vv, ct = (torch.randn(B, 12, N, 64, generator=g, device="cuda").bfloat16()
                  for _ in range(2))
        c = torch.exp(torch.randn(12, 2 * N - 1, generator=g, device="cuda") * 0.02)
        o, den = mlc.masked_linear_attention_coeffs_fwd(qp, kp, vv, c)
        gn, s = mlc.kerple_bwd_residuals(den, o, ct)
        a = (gn, s, vv, qp, kp, c)
        shape = f"({B}, 12, {N}, 266, 64)"
        # the plain version of the first batch element (long N fits that way)
        first = tuple(t[:1] for t in a[:5]) + (c,)
        out["mlc_bwd_dkv"].append((
            shape, lambda a=a: mlc.masked_linear_attention_coeffs_bwd_dkv(*a),
            lambda got, first=first: _max_rel(
                _first(got), mlc.masked_linear_attention_coeffs_bwd_dkv_reference(*first))))
        dq_args = (gn, s, vv, kp, c)
        dq_first = tuple(t[:1] for t in dq_args[:4]) + (c,)
        out["mlc_bwd_dq"].append((
            shape, lambda a=dq_args: mlc.masked_linear_attention_coeffs_bwd_dq(*a),
            lambda got, first=dq_first: _max_rel(
                _first(got), mlc.masked_linear_attention_coeffs_bwd_dq_reference(*first))))
        # dc's windows sum over the batch: the plain version of all of it,
        # computed once
        want = mlc.masked_linear_attention_coeffs_bwd_dc_reference(*a[:5])
        out["mlc_bwd_dc"].append((
            shape, lambda a=a: mlc.masked_linear_attention_coeffs_bwd_dc(*a[:5]),
            lambda got, want=want: _max_rel(got, want)))
        fwd_args = (qp, kp, vv, c)
        fwd_first = tuple(t[:1] for t in fwd_args[:3]) + (c,)
        out["mlc_fwd"].append((
            shape, lambda a=fwd_args: mlc.masked_linear_attention_coeffs_fwd(*a),
            lambda got, first=fwd_first: _max_rel(
                _first(got), mlc.masked_linear_attention_coeffs_reference(*first))))
    for B in (32, 64) if "kfp_fwd" in kernels else ():
        q, k = (torch.randn(B, 12, 197, 64, generator=g, device="cuda") for _ in range(2))
        q, k = ((x / x.norm(dim=-1, keepdim=True)).bfloat16() for x in (q, k))
        vv = torch.randn(B, 12, 197, 64, generator=g, device="cuda").bfloat16()
        om = torch.randn(12, 64, 266, generator=g, device="cuda")
        c = torch.exp(torch.randn(12, 2 * 197 - 1, generator=g, device="cuda") * 0.02)
        a = (q, k, vv, om, c)
        first = tuple(t[:1] for t in a[:3]) + (om, c)
        out["kfp_fwd"].append((
            f"({B}, 12, 197, 64, 266)", lambda a=a: mlc.kerple_attention_fused_phi_fwd(*a),
            lambda got, first=first: _max_rel(
                _first(got), mlc.kerple_attention_fused_phi_fwd_reference(*first))))
    for B, N in ((32, 197), (64, 197), (4, 4097)) if any(
            k.startswith("rot_") for k in kernels) else ():
        x, cot = (torch.randn(B, 12, N, 64, generator=g, device="cuda").bfloat16()
                  for _ in range(2))
        theta = torch.randn(12, N, 33, generator=g, device="cuda") * 0.3
        ct, st = theta.cos(), theta.sin()
        shape = f"({B}, 12, {N}, 64)"
        want = cr.circulant_rotate_fwd_reference(x, ct, st, True)
        out["rot_fwd"].append((
            shape, lambda a=(x, ct, st): cr.circulant_rotate_fwd(*a, True),
            lambda got, want=want: _max_rel(got, want)))
        if B == 32:
            continue  # serving runs no backward
        want_bwd = cr.circulant_rotate_bwd_reference(cot, x, ct, st, True)
        out["rot_bwd"].append((
            shape, lambda a=(cot, x, ct, st): cr.circulant_rotate_bwd(*a, True),
            lambda got, want=want_bwd: _max_rel(got, want)))
    for B, H, N, F, D in T_SHAPES if any(k.startswith("mlt_") for k in kernels) else ():
        qp, kp = ((torch.randn(B, H, N, F, generator=g, device="cuda").abs() * 0.1).bfloat16()
                  for _ in range(2))
        vv, ct = (torch.randn(B, H, N, D, generator=g, device="cuda").bfloat16()
                  for _ in range(2))
        t = torch.rand(H, N, N, generator=g, device="cuda") + 0.5  # not Toeplitz
        o, den = ml.masked_linear_fwd_reference(qp, kp, vv, t)
        gn, s = mlc.kerple_bwd_residuals(den, o, ct)
        shape = f"({B}, {H}, {N}, {F}, {D})"
        first = [x[:1] for x in (qp, kp, vv, gn, s)]
        q1, k1, v1, gn1, s1 = first
        out["mlt_fwd"].append((
            shape, lambda a=(qp, kp, vv, t): ml.masked_linear_fwd(*a),
            lambda got, a=(q1, k1, v1, t): _max_rel(_first(got),
                                                    ml.masked_linear_fwd_reference(*a))))
        out["mlt_bwd_dq"].append((
            shape, lambda a=(gn, s, vv, kp, t): ml.masked_linear_bwd_dq(*a),
            lambda got, a=(gn1, s1, v1, k1, t): _max_rel(_first(got),
                                                         mlc.kerple_dense_bwd_dq(*a))))
        out["mlt_bwd_dkv"].append((
            shape, lambda a=(gn, s, vv, qp, kp, t): ml.masked_linear_bwd_dkv(*a),
            lambda got, a=(gn1, s1, v1, q1, k1, t): _max_rel(_first(got),
                                                             mlc.kerple_dense_bwd_dkv(*a))))
        # dT sums over the batch: the plain version of all of it, computed once
        want = mlc.kerple_dense_bwd_dt(gn, s, vv, qp, kp) if "mlt_bwd_dt" in kernels else None
        out["mlt_bwd_dt"].append((
            shape, lambda a=(gn, s, vv, qp, kp): ml.masked_linear_bwd_dt(*a),
            lambda got, want=want: _max_rel(got, want)))
        del o, den
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", action="append", choices=sorted(VARIANTS),
                        help="trial only this kernel (repeatable; default: all)")
    kernels = parser.parse_args().kernel or list(VARIANTS)
    if not torch.cuda.is_available():
        raise RuntimeError("the tile trial needs a GPU")
    print(device_label(torch.device("cuda")), flush=True)
    libs = build_variants(kernels)
    originals: dict = {}
    trial = cases(kernels)
    for (kernel, variant), path in libs.items():
        _, module, loader, _ = VARIANTS[kernel]
        if kernel in LAUNCH_INFO:
            use_library(module, loader, path, originals)
            name = LAUNCH_INFO[kernel]
            if module is ml:
                for _, _, n, f, d in T_SHAPES:
                    info = ml.launch_info(name, n, f, d, torch.bfloat16)
                    print(f"{kernel} {variant} launch_info N={n} F={f} D={d}: {info}", flush=True)
                continue
            for n in LAUNCH_INFO_N.get(kernel, (197, 4097)):
                info = (module.launch_info(name, n, 64, torch.bfloat16, (12 * n * 64, n * 64, 64))
                        if module is cr else
                        module.launch_info(name, n, 266, 64, torch.bfloat16))
                print(f"{kernel} {variant} launch_info N={n}: {info}", flush=True)
    for rnd in range(2):
        for (kernel, variant), path in libs.items():
            _, module, loader, _ = VARIANTS[kernel]
            use_library(module, loader, path, originals)
            for shape, run, check in trial[kernel]:
                rel = check(run())
                ms = kernel_ms(run, iters=20 if "4097" not in shape else 3)
                if kernel == "mlt_bwd_dt":
                    dims = [int(x) for x in shape.strip("()").split(",")]
                    shape += f", {ml._bwd_fns().mlt_bwd_dt_groups(*dims, 1)} groups"
                print(f"round {rnd} {kernel} {variant} {shape}: {ms:.4f} ms, "
                      f"max|err|/max|plain| {rel:.3e}", flush=True)


if __name__ == "__main__":
    main()
