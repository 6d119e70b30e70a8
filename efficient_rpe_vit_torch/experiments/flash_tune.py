#!/usr/bin/env python
"""Tile sweep of the bf16 flash kernels (#6 forward, 7b two-pass backward)
on one card.

Counterpart of `experiments/flash_tune.py` (the JAX package's sweep of the
Pallas kernel's block_q x block_kv), on the port's register-tile kernels at
head dim 64. A grid point (block_q, block_kv) sets each kernel's tile:

    flash_fwd      FwdMma<64, block_q / 16, block_kv, MINB>: a block owns
                   block_q query rows (16 a warp) and streams block_kv-row
                   key/value tiles (csrc/flash_attention_fwd.cu
                   `fwd_choice_n`; shipped: 128 x 64 from N = 512, 64 x 64
                   below);
    flash_bwd_dq   DqMma<64, block_q / 16, block_kv, MINB>: the same roles
                   (csrc/flash_attention_bwd.cu `dq_choice_n`; shipped
                   64 x 32);
    flash_bwd_dkv  DkvMma<64, block_kv / 16, block_q, MINB>: a block owns
                   block_kv key/value rows and streams block_q-row query
                   tiles (`dkv_choice_n`; shipped 64 key/value rows against
                   32-row query tiles, which no point of the default grid
                   has: the shipped row stands for it).

MINB, the resident blocks per SM asked of the register allocator, is set
for the registers: as many blocks as both the register file (at most 128
registers a thread for the forward and dq, ~170 for dkv, which holds dk
and dv) and shared memory allow, at least 1; this gives the shipped tiles
their shipped MINB.

Each point is built from a copy of `csrc/` with the three instantiations
swapped (all copies compiled at once, under build/flash_tune/); the
shipped kernels are never edited. Each variant is first held against the
plain versions on the same inputs (out and dq, dk, dv within 2e-2 of the
plain's largest magnitude, lse within 1e-4: chip_smoke.py's phase-3c
tolerances; a key tile other than 64 rows moves the running maxima and so
the values P' is rounded at, hence a tolerance and not bits), then timed
as the JAX sweep times: `utils/timing.py::chained_time`, the median of 3
chains of `--steps` calls (forward) and of max(3, steps // 2) calls
(forward + the two-pass backward, and dq and dkv alone, with --grad), each
call's input depending on the last call's output. TFLOP/s as JAX counts
them: 4·B·H·N²·D forward, 3.5 times that with the backward. A variant that
fails to build, to launch or to agree is a FAILED row. The shipped
kernels are timed first, as the row `shipped`.

    python -m efficient_rpe_vit_torch.experiments.flash_tune [--grad] \\
        [--batch 4] [--heads 12] [--head-dim 64] [--seq 4097] [--steps 10] \\
        [--blocks-q 64 128] [--blocks-kv 32 64 128] [--out FILE]

It runs on the GPU and raises without one (`--device cpu` too: the sweep
builds and times CUDA kernels); the first line printed is the card's name
and power limit, then the markdown table with the shipped tiles marked,
the best forward, and one JSON line of rows, also written to `--out` if
given.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Tuple

import torch

from . import tile_trial
from .tile_trial import max_rel
from ..ops.kernels import _build
from ..ops.kernels import flash_attention as fa
from ..utils.timing import chained_time

TUNE_DIR = _build.BUILD_DIR.parent / "flash_tune"
BLOCKS_Q = [64, 128]
BLOCKS_KV = [32, 64, 128]
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
TOL, LSE_ATOL = 2e-2, 1e-4

# the launchers' tile choice at D = 64, where each point's instantiation goes
ANCHORS = {
    "flash_fwd": ("flash_attention_fwd", "FwdChoice fwd_choice_n(int N) {\n"),
    "flash_bwd_dq": ("flash_attention_bwd", "BwdChoice dq_choice_n() {\n"),
    "flash_bwd_dkv": ("flash_attention_bwd", "BwdChoice dkv_choice_n() {\n"),
}
CHOICE = {"flash_fwd": "fwd_choice", "flash_bwd_dq": "dq_choice", "flash_bwd_dkv": "dkv_choice"}
# what the sources ship at D = 64: (rows a block owns, rows a stage streams)
SHIPPED_DQ, SHIPPED_DKV = (64, 32), (64, 32)
LD = 64 + 8  # shared-memory row stride (bf16 elements) at D = 64
SMEM_PER_SM, SMEM_PER_BLOCK_RESERVED = 228 * 1024, 1024
# blocks per SM at most, times warps per block, that the register file holds
# (65,536 registers): 128 registers a thread -> 16, ~170 -> 12
REGISTER_WARP_BLOCKS = {"flash_fwd": 16, "flash_bwd_dq": 16, "flash_bwd_dkv": 12}


def shipped_tiles(n: int) -> Dict[str, Tuple[int, int]]:
    """Each kernel's shipped (block rows, stage rows) at sequence length n."""
    return {"flash_fwd": (128, 64) if n >= 512 else (64, 64),
            "flash_bwd_dq": SHIPPED_DQ, "flash_bwd_dkv": SHIPPED_DKV}


def tiles(block_q: int, block_kv: int) -> Dict[str, Tuple[int, int]]:
    """Each kernel's (block rows, stage rows) at a grid point: the forward
    and dq own query rows, dkv owns key/value rows."""
    return {"flash_fwd": (block_q, block_kv), "flash_bwd_dq": (block_q, block_kv),
            "flash_bwd_dkv": (block_kv, block_q)}


def smem_bytes(kernel: str, rows: int, stage: int) -> int:
    """Dynamic shared memory of a tile (the sources' FwdMma / DqMma / DkvMma
    BYTES at D = 64): the block's own rows, then two stages."""
    if kernel == "flash_fwd":  # Q, then K and V a stage
        return (rows * LD + 2 * 2 * stage * LD) * 2
    if kernel == "flash_bwd_dq":  # Q and g, then K and V a stage
        return (2 * rows * LD + 2 * 2 * stage * LD) * 2
    # K and V, then q and g and three fp32 rows (lse, delta, hashes) a stage
    return 2 * rows * LD * 2 + 2 * (2 * stage * LD * 2 + 3 * stage * 4)


def min_blocks(kernel: str, rows: int, stage: int) -> int:
    """MINB: the resident blocks per SM both the registers and the shared
    memory allow, at least 1."""
    by_registers = REGISTER_WARP_BLOCKS[kernel] // (rows // 16)
    by_smem = SMEM_PER_SM // (smem_bytes(kernel, rows, stage) + SMEM_PER_BLOCK_RESERVED)
    return max(1, min(by_registers, by_smem))


def swaps(block_q: int, block_kv: int) -> Dict[str, List[Tuple[str, str]]]:
    """{source: [(shipped text, swapped text)]} of a grid point: each
    launcher's tile choice returns the point's instantiation at D = 64."""
    out: Dict[str, List[Tuple[str, str]]] = {}
    for kernel, (rows, stage) in tiles(block_q, block_kv).items():
        source, anchor = ANCHORS[kernel]
        choice = (f"{CHOICE[kernel]}<64, {rows // 16}, {stage}, "
                  f"{min_blocks(kernel, rows, stage)}>()")
        out.setdefault(source, []).append(
            (anchor, f"{anchor}  if constexpr (DP == 64) return {choice};\n"))
    return out


def start_builds(points: List[Tuple[int, int]]) -> dict:
    """Start compiling every point's copy of `csrc/` (`tile_trial.start_copies`)."""
    return tile_trial.start_copies(
        {point: (TUNE_DIR / f"q{point[0]}_kv{point[1]}", swaps(*point)) for point in points})


class Case:
    """The sweep's inputs (seeded, bf16) and the plain versions' outputs on
    them: forward (out, lse) and, from its lse and delta = sum(g * out),
    the backward (dq, dk, dv), computed once for every variant."""

    def __init__(self, B: int, H: int, N: int, D: int, device: torch.device):
        g = torch.Generator(device=device).manual_seed(0)
        self.q, self.k, self.v, self.g = (
            torch.randn(B, H, N, D, generator=g, device=device, dtype=torch.bfloat16)
            for _ in range(4))
        self.scale = D ** -0.5
        self.shape = (B, H, N, D)
        self.out, self.lse = fa.flash_softmax_attention_reference(self.q, self.k, self.v,
                                                                  self.scale)
        self.delta = fa.flash_delta(self.out, self.g)
        self.grads = fa.flash_bwd_reference(self.q, self.k, self.v, self.g, self.lse,
                                            self.delta, self.scale)

    def bwd_args(self, q):
        return (q, self.k, self.v, self.g, self.lse, self.delta, self.scale)


def measure(case: Case, steps: int, grad: bool) -> dict:
    """The loaded kernels against the plain versions, then timed; a row
    with `failed` where they disagree."""
    q, k, v, scale = case.q, case.k, case.v, case.scale
    B, H, N, D = case.shape
    row: dict = {"launch_info": {name: fa.launch_info(name, N, D, torch.bfloat16)
                                 for name in KERNELS}}
    out, lse = fa.flash_attention_fwd(q, k, v, scale)
    dq = fa.flash_attention_bwd_dq(*case.bwd_args(q))
    dk, dv = fa.flash_attention_bwd_dkv(*case.bwd_args(q))
    err = {"out": max_rel(out, case.out), "lse_abs": (lse - case.lse).abs().max().item(),
           "dq": max_rel(dq, case.grads[0]), "dk": max_rel(dk, case.grads[1]),
           "dv": max_rel(dv, case.grads[2])}
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (out, lse, dq, dk, dv))
    row["max_rel_err"] = err
    if not finite or err["lse_abs"] > LSE_ATOL or max(
            err[key] for key in ("out", "dq", "dk", "dv")) > TOL:
        row["failed"] = (f"disagrees with the plain versions (tolerance {TOL} of the largest "
                         f"magnitude, lse {LSE_ATOL}; finite {finite}): {err}")
        return row
    del out, lse, dq, dk, dv

    fwd_flops = 4 * B * H * N * N * D  # QK^T + PV, 2 flops a multiply-add
    t = chained_time(lambda q, k, v: fa.flash_attention_fwd(q, k, v, scale), (q, k, v), steps,
                     lambda cur, out: (cur[0], cur[1], cur[2] + 0 * out[0]))
    row.update(fwd_ms=t * 1e3, fwd_tflops=fwd_flops / t / 1e12)
    if grad:
        def fwd_bwd(q, k, v):
            out, lse = fa.flash_attention_fwd(q, k, v, scale)
            delta = fa.flash_delta(out, case.g)
            args = (q, k, v, case.g, lse, delta, scale)
            return (fa.flash_attention_bwd_dq(*args), *fa.flash_attention_bwd_dkv(*args))

        bwd_steps = max(3, steps // 2)
        tg = chained_time(fwd_bwd, (q, k, v), bwd_steps,
                          lambda cur, out: (cur[0] + 0 * out[0], cur[1], cur[2]))
        t_dq = chained_time(lambda q: fa.flash_attention_bwd_dq(*case.bwd_args(q)), (q,),
                            bwd_steps, lambda cur, out: (cur[0] + 0 * out,))
        t_dkv = chained_time(lambda q: fa.flash_attention_bwd_dkv(*case.bwd_args(q)), (q,),
                             bwd_steps, lambda cur, out: (cur[0] + 0 * out[0],))
        row.update(fwdbwd_ms=tg * 1e3, fwdbwd_tflops=3.5 * fwd_flops / tg / 1e12,
                   dq_ms=t_dq * 1e3, dkv_ms=t_dkv * 1e3)
    return row


def sweep(points: List[Tuple[int, int]], built: dict, B: int, H: int, N: int, D: int,
          steps: int, grad: bool, device: torch.device, card: str) -> dict:
    """The shipped row, then each point's row (its variant, from `built` =
    `tile_trial.finish_copies(start_builds(points))`, loaded in place of the
    shipped libraries, which are restored at the end)."""
    if D != 64:
        raise ValueError(f"the sweep swaps the D = 64 instantiations, got D = {D}")
    case = Case(B, H, N, D, device)
    shipped = shipped_tiles(N)
    rows = [dict(label="shipped", block_q=None, block_kv=None,
                 tiles={k: list(t) for k, t in shipped.items()}, shipped=list(KERNELS),
                 **measure(case, steps, grad))]

    def point_row(point):
        t = tiles(*point)
        return dict(label=f"{point[0]} x {point[1]}", block_q=point[0], block_kv=point[1],
                    tiles={k: list(v) for k, v in t.items()},
                    min_blocks={k: min_blocks(k, *v) for k, v in t.items()},
                    smem_bytes={k: smem_bytes(k, *v) for k, v in t.items()},
                    shipped=[k for k in KERNELS if t[k] == shipped[k]])

    rows += tile_trial.sweep_points(
        points, built, [(fa, "_fwd_lib", "flash_attention_fwd"),
                        (fa, "_bwd_lib", "flash_attention_bwd")],
        point_row, lambda: measure(case, steps, grad))
    return {"shape": {"B": B, "H": H, "N": N, "D": D, "dtype": "bfloat16"},
            "protocol": (f"chained calls, median of 3 x {steps} (forward) / "
                         f"{max(3, steps // 2)} (with the backward) "
                         "(efficient_rpe_vit_torch/experiments/flash_tune.py)"),
            "card": card, "rows": rows}


def report(result: dict, grad: bool) -> List[str]:
    """The JAX sweep's markdown table (ms and TFLOP/s; the shipped kernels'
    tiles marked with *) and the best forward, as lines."""
    lines = ["| bq | bkv | fwd ms | fwd TFLOP/s |"
             + (" fwd+bwd ms | fwd+bwd TFLOP/s | dq ms | dkv ms |" if grad else "")
             + " tiles (fwd / dq / dkv; * shipped) |"]
    lines.append("|---" * (lines[0].count("|") - 1) + "|")
    for r in result["rows"]:
        marked = " / ".join(f"{r['tiles'][k][0]}x{r['tiles'][k][1]}"
                            + ("*" if k in r["shipped"] else "") for k in KERNELS)
        head = f"| {r['block_q'] or 'shipped'} | {r['block_kv'] or ''} |"
        if "failed" in r:
            lines.append(f"{head} FAILED {r['failed'][:120]} | {marked} |")
            continue
        line = f"{head} {r['fwd_ms']:.3f} | {r['fwd_tflops']:.1f} |"
        if grad:
            line += (f" {r['fwdbwd_ms']:.3f} | {r['fwdbwd_tflops']:.1f} | {r['dq_ms']:.3f} |"
                     f" {r['dkv_ms']:.3f} |")
        lines.append(f"{line} {marked} |")
    timed = [r for r in result["rows"] if r["block_q"] and "fwd_ms" in r]
    if timed:
        best = min(timed, key=lambda r: r["fwd_ms"])
        lines.append(f"best fwd: block_q={best['block_q']} block_kv={best['block_kv']} "
                     f"({best['fwd_ms']:.3f} ms, {best['fwd_tflops']:.1f} TFLOP/s)")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--seq", type=int, default=4097)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--grad", action="store_true", help="also time forward+backward")
    ap.add_argument("--blocks-q", nargs="+", type=int, default=BLOCKS_Q)
    ap.add_argument("--blocks-kv", nargs="+", type=int, default=BLOCKS_KV)
    ap.add_argument("--device", default=None, help="the GPU (the default) is the only choice")
    ap.add_argument("--out", default=None, help="also write the JSON to this file")
    args = ap.parse_args(argv)
    points = [(bq, bkv) for bq in args.blocks_q for bkv in args.blocks_kv]
    result = tile_trial.run_sweep(
        args.device, lambda: start_builds(points),
        lambda built, device, card: sweep(points, built, args.batch, args.heads, args.seq,
                                          args.head_dim, args.steps, args.grad, device, card))
    print(f"B={args.batch} H={args.heads} N={args.seq} D={args.head_dim} bf16, chained "
          f"x{args.steps}, median of 3", flush=True)
    for line in report(result, args.grad):
        print(line, flush=True)
    tile_trial.write_json(args.out, result)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
