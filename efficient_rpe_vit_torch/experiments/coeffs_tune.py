#!/usr/bin/env python
"""Tile sweep of the bf16 KERPLE kernels over coefficients (#1 forward, #2
backward dq, dkv, dc) on one card.

Counterpart of `experiments/coeffs_tune.py` (the JAX package's sweep of the
Pallas kernels' block_q x block_kv), on the port's register-tile kernels at
F <= 272, D <= 64. A grid point (block_q, block_kv) sets each kernel's tile
where its template allows it, and leaves the shipped one elsewhere:

    masked_linear_coeffs_fwd     FwdMma<272, 64, block_q, block_kv, true>:
                                 a block owns block_q query rows and streams
                                 block_kv-row key/value stages
                                 (csrc/masked_linear_coeffs_fwd.cu
                                 `FwdChoice`; shipped 128 x 64);
    masked_linear_coeffs_bwd_dq  DqMma<272, 64, block_q, SPLIT, block_kv>,
                                 SPLIT warps a 16-row slice, as many as keep
                                 16 warps a block and divide the stage
                                 (csrc/masked_linear_coeffs_bwd.cu
                                 `DqChoice`; shipped 128 x 64, SPLIT 2);
    masked_linear_coeffs_bwd_dkv DkvMma<272, 64, block_kv>: a block owns
                                 block_kv key/value rows and streams 32-row
                                 query stages, so only points with block_q
                                 = 32 set it (`DkvChoice`; shipped 64);
    masked_linear_coeffs_bwd_dc  DcMma<272, 64, block_q, block_kv>, where
                                 block_q is a multiple of the 64-row
                                 windows' tile and block_kv divides it
                                 (`DcChoice`; shipped 128 x 64).

Each point is built from a copy of `csrc/` with the instantiations swapped
(all copies compiled at once, under build/coeffs_tune/); the shipped
kernels are never edited. The inputs are the JAX sweep's: q', k' =
relu(normal), v normal in bf16, c = exp(0.1 normal). Each variant is first
held against the plain versions on the same inputs (chip_smoke.py's
phase-3 tolerances: out within 1e-2 relative + 1e-3, den 1e-4 relative;
dq', dk', dv within 2e-2 and the dc windows within 1e-2 of the plain's
largest magnitude; the forward, dq and dkv on the first batch element,
the windows, a sum over the batch, on all of it), then timed as the JAX
sweep times: `utils/timing.py::chained_time`, the median of 3 chains of
`--steps` calls of the forward and (with --grad) of the forward with the
whole backward (dq, dkv, dc and the reduce), each call's input depending
on the last call's output; dq, dkv and dc are also timed alone (calls
in stream order). TFLOP/s as
JAX counts them: 2·B·H·N²·(F+D) forward, 3.5 times that with the
backward. A variant that fails to build, to launch or to agree is a row
with `failed`. The shipped kernels are timed first, as the row `shipped`.

    python -m efficient_rpe_vit_torch.experiments.coeffs_tune [--grad] \\
        [--batch 4] [--heads 12] [--features 266] [--head-dim 64] \\
        [--seq 4097] [--steps 10] [--out FILE]

It runs on the GPU and raises without one (`--device cpu` too: the sweep
builds and times CUDA kernels); the first line printed is the card's name
and power limit, then one line per row, then the JSON (the JAX keys
`fwd_ms`, `fwd_tflops`, `fwdbwd_ms`, `fwdbwd_tflops`, `failed`, with the
shape, the protocol and the card), also written to `--out` if given.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

import torch

from . import tile_trial
from .tile_trial import max_rel
from ..ops.kernels import _build
from ..ops.kernels import masked_linear_coeffs as mlc
from ..utils.timing import chained_time

TUNE_DIR = _build.BUILD_DIR.parent / "coeffs_tune"
CONFIGS = [(bq, bkv) for bq in (32, 64, 128) for bkv in (32, 64)]
KERNELS = ("masked_linear_coeffs_fwd", "masked_linear_coeffs_bwd_dq",
           "masked_linear_coeffs_bwd_dkv", "masked_linear_coeffs_bwd_dc")
OUT_RTOL, OUT_ATOL, DEN_RTOL = 1e-2, 1e-3, 1e-4
BWD_TOL, DC_TOL = 2e-2, 1e-2
DC_TILE = 64  # the dc windows' tile (DcMma::TILE)
DKV_STAGE = 32  # DkvMma's query stage rows

# each kernel's shipped instantiation: {kernel: (source, [shipped texts])}
SHIPPED = {
    "masked_linear_coeffs_fwd": ("masked_linear_coeffs_fwd",
                                 ["using FwdChoice = FwdMma<272, 64, 128, 64, true>;"]),
    "masked_linear_coeffs_bwd_dq": ("masked_linear_coeffs_bwd",
                                    ["using DqChoice = DqMma<272, 64, 128, 2, 64>;"]),
    "masked_linear_coeffs_bwd_dkv": ("masked_linear_coeffs_bwd",
                                     ["using DkvChoice = DkvMma<272, 64, 64>;",
                                      "auto dkv_mma_fn() { return "
                                      "mlc_bwd_dkv_mma_kernel<272, 64, 64>; }"]),
    "masked_linear_coeffs_bwd_dc": ("masked_linear_coeffs_bwd",
                                    ["using DcChoice = DcMma<272, 64, 128, 64>;"]),
}
# each kernel's shipped tile (rows a block owns, rows a stage streams)
SHIPPED_TILES = {"masked_linear_coeffs_fwd": (128, 64), "masked_linear_coeffs_bwd_dq": (128, 64),
                 "masked_linear_coeffs_bwd_dkv": (64, 32),
                 "masked_linear_coeffs_bwd_dc": (128, 64)}


def dq_split(block_q: int, block_kv: int) -> int:
    """dq's warps per 16-row slice: 16 warps a block where the stage
    divides among them (it must hold 16 columns per warp of a slice)."""
    return max(1, min(16 // (block_q // 16), block_kv // 16))


def tiles(block_q: int, block_kv: int) -> Dict[str, Optional[Tuple[int, int]]]:
    """Each kernel's (block rows, stage rows) at a grid point, None where
    its template does not take the point (the shipped tile stays)."""
    return {"masked_linear_coeffs_fwd": (block_q, block_kv),
            "masked_linear_coeffs_bwd_dq": (block_q, block_kv),
            "masked_linear_coeffs_bwd_dkv": (block_kv, DKV_STAGE) if block_q == DKV_STAGE
            else None,
            "masked_linear_coeffs_bwd_dc": (block_q, block_kv)
            if block_q % DC_TILE == 0 and DC_TILE % block_kv == 0 else None}


def instantiation(kernel: str, rows: int, stage: int) -> List[str]:
    """The texts that replace `SHIPPED[kernel]`'s for the tile (rows, stage)."""
    if kernel == "masked_linear_coeffs_fwd":
        return [f"using FwdChoice = FwdMma<272, 64, {rows}, {stage}, true>;"]
    if kernel == "masked_linear_coeffs_bwd_dq":
        return [f"using DqChoice = DqMma<272, 64, {rows}, {dq_split(rows, stage)}, {stage}>;"]
    if kernel == "masked_linear_coeffs_bwd_dkv":
        return [f"using DkvChoice = DkvMma<272, 64, {rows}>;",
                f"auto dkv_mma_fn() {{ return mlc_bwd_dkv_mma_kernel<272, 64, {rows}>; }}"]
    return [f"using DcChoice = DcMma<272, 64, {rows}, {stage}>;"]


def swaps(block_q: int, block_kv: int) -> Dict[str, List[Tuple[str, str]]]:
    """{source: [(shipped text, swapped text)]} of a grid point."""
    out: Dict[str, List[Tuple[str, str]]] = {}
    for kernel, tile in tiles(block_q, block_kv).items():
        if tile is None:
            continue
        source, shipped = SHIPPED[kernel]
        out.setdefault(source, []).extend(zip(shipped, instantiation(kernel, *tile)))
    return out


def start_builds(points: List[Tuple[int, int]]) -> dict:
    """Start compiling every point's copy of `csrc/` (`tile_trial.start_copies`)."""
    return tile_trial.start_copies(
        {point: (TUNE_DIR / f"q{point[0]}_kv{point[1]}", swaps(*point)) for point in points})


class Case:
    """The sweep's inputs (seeded) and the plain versions' outputs on them:
    the residuals gn, s of a random cotangent come from the shipped
    forward kernel's (out, den), so every variant's backward takes the same
    inputs as the plain backward."""

    def __init__(self, B, H, N, F, D, device):
        g = torch.Generator(device=device).manual_seed(0)
        self.qp, self.kp = (torch.relu(torch.randn(B, H, N, F, generator=g, device=device))
                            .bfloat16() for _ in range(2))
        self.v, self.cot = (torch.randn(B, H, N, D, generator=g, device=device).bfloat16()
                            for _ in range(2))
        self.c = torch.exp(torch.randn(H, 2 * N - 1, generator=g, device=device) * 0.1)
        self.shape = (B, H, N, F, D)
        out, den = mlc.masked_linear_attention_coeffs_fwd(self.qp, self.kp, self.v, self.c)
        self.gn, self.s = mlc.kerple_bwd_residuals(den, out, self.cot)
        del out, den
        q1, k1, v1, gn1, s1 = (t[:1] for t in (self.qp, self.kp, self.v, self.gn, self.s))
        self.fwd_want = mlc.masked_linear_attention_coeffs_reference(q1, k1, v1, self.c)
        self.dq_want = mlc.masked_linear_attention_coeffs_bwd_dq_reference(gn1, s1, v1, k1,
                                                                            self.c)
        self.dkv_want = mlc.masked_linear_attention_coeffs_bwd_dkv_reference(gn1, s1, v1, q1,
                                                                              k1, self.c)
        self.dc_want = mlc.masked_linear_attention_coeffs_bwd_dc_reference(
            self.gn, self.s, self.v, self.qp, self.kp)

    def dq(self, qp):  # dq' reads k', not q'
        return mlc.masked_linear_attention_coeffs_bwd_dq(self.gn, self.s, self.v, self.kp, self.c)

    def dkv(self, qp):
        return mlc.masked_linear_attention_coeffs_bwd_dkv(self.gn, self.s, self.v, qp, self.kp,
                                                          self.c)

    def dc(self, qp):
        return mlc.masked_linear_attention_coeffs_bwd_dc(self.gn, self.s, self.v, qp, self.kp)


def measure(case: Case, steps: int, grad: bool) -> dict:
    """The loaded kernels against the plain versions, then timed; a row
    with `failed` where they disagree."""
    B, H, N, F, D = case.shape
    row: dict = {"launch_info": {name: mlc.launch_info(name, N, F, D, torch.bfloat16)
                                 for name in KERNELS}}
    out, den = mlc.masked_linear_attention_coeffs_fwd(case.qp, case.kp, case.v, case.c)
    want_out, want_den = case.fwd_want
    out_ok = bool(((out[:1].float() - want_out.float()).abs()
                   <= OUT_ATOL + OUT_RTOL * want_out.float().abs()).all())
    den_rel = ((den[:1] - want_den).abs() / want_den.abs().clamp_min(1e-30)).max().item()
    dq = case.dq(case.qp)
    dk, dv = case.dkv(case.qp)
    windows = case.dc(case.qp)
    err = {"out": max_rel(out[:1], want_out), "den": den_rel,
           "dq": max_rel(dq[:1], case.dq_want), "dk": max_rel(dk[:1], case.dkv_want[0]),
           "dv": max_rel(dv[:1], case.dkv_want[1]), "dc": max_rel(windows, case.dc_want)}
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (out, den, dq, dk, dv, windows))
    row["max_rel_err"] = err
    if not (finite and out_ok and den_rel <= DEN_RTOL and err["dc"] <= DC_TOL
            and max(err["dq"], err["dk"], err["dv"]) <= BWD_TOL):
        row["failed"] = (f"disagrees with the plain versions (out rtol {OUT_RTOL} atol "
                         f"{OUT_ATOL}: {out_ok}, den {DEN_RTOL}, dq/dk/dv {BWD_TOL}, dc "
                         f"{DC_TOL}; finite {finite}): {err}")
        return row
    del out, den, dq, dk, dv, windows

    fwd_flops = 2 * B * H * N * N * (F + D)  # q'k'^T (F) and A v (D), 2 flops a multiply-add
    c = case.c
    t = chained_time(lambda qp, kp, v: mlc.masked_linear_attention_coeffs_fwd(qp, kp, v, c),
                     (case.qp, case.kp, case.v), steps,
                     lambda cur, out: (cur[0], cur[1], cur[2] + 0 * out[0]))
    row.update(fwd_ms=t * 1e3, fwd_tflops=fwd_flops / t / 1e12)
    if grad:
        def fwd_bwd(qp, kp, v):
            out, den = mlc.masked_linear_attention_coeffs_fwd(qp, kp, v, c)
            gn, s = mlc.kerple_bwd_residuals(den, out, case.cot)
            windows = mlc.masked_linear_attention_coeffs_bwd_dc(gn, s, v, qp, kp)
            return (mlc.masked_linear_attention_coeffs_bwd_dq(gn, s, v, kp, c),
                    *mlc.masked_linear_attention_coeffs_bwd_dkv(gn, s, v, qp, kp, c),
                    mlc.masked_linear_attention_coeffs_bwd_dc_reduce(windows, N))

        tg = chained_time(fwd_bwd, (case.qp, case.kp, case.v), steps,
                          lambda cur, out: (cur[0] + 0 * out[0], cur[1], cur[2]))
        row.update(fwdbwd_ms=tg * 1e3, fwdbwd_tflops=3.5 * fwd_flops / tg / 1e12)
        # dq, dkv and dc alone, the calls in stream order
        for name, fn in (("dq", case.dq), ("dkv", case.dkv), ("dc", case.dc)):
            row[f"{name}_ms"] = chained_time(fn, (case.qp,), steps, lambda cur, out: cur) * 1e3
    return row


def sweep(points: List[Tuple[int, int]], built: dict, B: int, H: int, N: int, F: int,
          D: int, steps: int, grad: bool, device: torch.device, card: str) -> dict:
    """The shipped row, then each point's row (its variant, from `built` =
    `tile_trial.finish_copies(start_builds(points))`, loaded in place of the
    shipped libraries, which are restored at the end)."""
    if F > 272 or F % 2 or D > 64:
        raise ValueError(f"the sweep swaps the mma.sync kernels' tiles (even F <= 272, "
                         f"D <= 64), got F = {F}, D = {D}")
    case = Case(B, H, N, F, D, device)
    rows = [dict(label="shipped", block_q=None, block_kv=None,
                 tiles={k: list(t) for k, t in SHIPPED_TILES.items()}, shipped=list(KERNELS),
                 **measure(case, steps, grad))]

    def point_row(point):
        t = {k: v or SHIPPED_TILES[k] for k, v in tiles(*point).items()}
        return dict(label=f"{point[0]} x {point[1]}", block_q=point[0], block_kv=point[1],
                    tiles={k: list(v) for k, v in t.items()}, dq_split=dq_split(*point),
                    shipped=[k for k in KERNELS if t[k] == SHIPPED_TILES[k]])

    rows += tile_trial.sweep_points(
        points, built, [(mlc, "_kernel_fns", "masked_linear_coeffs_fwd"),
                        (mlc, "_bwd_kernel_fns", "masked_linear_coeffs_bwd")],
        point_row, lambda: measure(case, steps, grad))
    return {"shape": {"B": B, "H": H, "N": N, "F": F, "D": D, "dtype": "bfloat16"},
            "protocol": (f"chained calls, median of 3 x {steps} "
                         "(efficient_rpe_vit_torch/experiments/coeffs_tune.py)"),
            "card": card, "rows": rows}


def report(result: dict) -> List[str]:
    """One line per row: its tiles (shipped ones marked *) and times."""
    lines = []
    for r in result["rows"]:
        marked = " / ".join(f"{r['tiles'][k][0]}x{r['tiles'][k][1]}"
                            + ("*" if k in r["shipped"] else "") for k in KERNELS)
        times = {k: round(v, 4) for k, v in r.items() if k.endswith(("_ms", "_tflops"))}
        lines.append(f"{r['label']} (fwd / dq / dkv / dc tiles {marked}): "
                     + (f"FAILED {r['failed'][:200]}" if "failed" in r else str(times)))
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--features", type=int, default=266)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--seq", type=int, default=4097)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--grad", action="store_true")
    ap.add_argument("--device", default=None, help="the GPU (the default) is the only choice")
    ap.add_argument("--out", default=None, help="also write the JSON to this file")
    args = ap.parse_args(argv)

    def run(built, device, card):
        print(f"coeffs-kernel sweep B={args.batch} H={args.heads} N={args.seq} "
              f"F={args.features} D={args.head_dim}", flush=True)
        return sweep(CONFIGS, built, args.batch, args.heads, args.seq, args.features,
                     args.head_dim, args.steps, args.grad, device, card)

    result = tile_trial.run_sweep(args.device, lambda: start_builds(CONFIGS), run)
    for line in report(result):
        print(line, flush=True)
    tile_trial.write_json(args.out, result)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
