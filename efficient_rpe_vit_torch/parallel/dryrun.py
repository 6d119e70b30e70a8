"""A multi-rank dry run of the parallel layer on the CPU.

Counterpart of `__graft_entry__.py::dryrun_multichip`: `dryrun_multichip(n)`
starts a child process that runs an n-rank gloo world on the CPU and, on
the flagship at `mnist_config(dropout=0.1)`, takes one sharded train step
with `grad_accum=2` (data x model, model = 2 when n is even, an EMA
shadow), one `make_parallel_multi_step` call of two steps and, with n >= 4,
one GPipe step on data = n / 2, pipe = 2 (depth 2, M = 4). Every loss must
be finite; any failure, on any rank, makes the child and the call fail.

    python -m efficient_rpe_vit_torch.parallel.dryrun 4

No card is touched: every rank runs on the CPU, one thread each.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import tempfile
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODULE = "efficient_rpe_vit_torch.parallel.dryrun"


def dryrun_multichip(n_ranks: int, timeout: float = 600.0) -> None:
    """Run the dry run in a child process; raises when it fails."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-m", MODULE, "--child", str(n_ranks)],
                          env=env, cwd=ROOT, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"the {n_ranks}-rank dry run failed (rc={proc.returncode})")


def _rank(rank: int, n: int, store_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(store_dir, "store"), n)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n)
    try:
        losses = _steps(n)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()
    bad = {k: v for k, v in losses.items() if not all(math.isfinite(x) for x in v)}
    if bad:
        raise AssertionError(f"rank {rank}: non-finite losses {bad}")
    if rank == 0:
        print(f"dry run on {n} ranks: losses {losses}", flush=True)


def _steps(n: int):
    import torch

    from ..configs import mnist_config
    from ..models import create_model
    from . import (
        create_pipeline_train_state,
        create_sharded_train_state,
        host_batch_slice,
        make_mesh,
        make_parallel_multi_step,
        make_parallel_train_step,
        make_pipeline_train_step,
        make_mesh_from_spec,
    )

    cfg = mnist_config(dropout=0.1)
    name = "performer_favor_most_general"
    g = torch.Generator().manual_seed(0)
    losses = {}

    mesh = make_mesh(n_model=2 if n % 2 == 0 and n > 1 else 1, device="cpu")
    batch = max(8, 2 * mesh.size("data"))
    batch -= batch % mesh.size("data")
    images = torch.randn(batch, 28, 28, 1, generator=g)
    labels = torch.arange(batch) % 10
    rows = host_batch_slice(batch, mesh)
    model = create_model(name, cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    state = create_sharded_train_state(model, cfg, mesh, steps_per_epoch=10, ema_decay=0.99)
    step = make_parallel_train_step(model, mesh, state, grad_accum=2)
    state, loss, _ = step(state, images[rows], labels[rows], torch.Generator().manual_seed(2))
    losses["sharded_grad_accum2"] = [float(loss)]

    multi = make_parallel_multi_step(model, mesh, state)
    xs = torch.stack([images[rows], images[rows]])
    ys = torch.stack([labels[rows], labels[rows]])
    state, mlosses, _ = multi(state, xs, ys, torch.Generator().manual_seed(3))
    losses["multi_step"] = [float(v) for v in mlosses]

    if n >= 4 and n % 2 == 0:
        pp_mesh = make_mesh_from_spec(f"data={n // 2},pipe=2", device="cpu")
        pp_model = create_model(name, cfg, depth=2, device="cpu",
                                generator=torch.Generator().manual_seed(4))
        pp_state = create_pipeline_train_state(pp_model, cfg, pp_mesh, steps_per_epoch=10)
        pp_step = make_pipeline_train_step(pp_model, pp_mesh, pp_state, n_microbatches=4)
        pp_batch = 4 * n
        pp_state, pp_loss, _ = pp_step(pp_state, torch.randn(pp_batch, 28, 28, 1, generator=g),
                                       torch.arange(pp_batch) % 10,
                                       torch.Generator().manual_seed(5))
        losses["pipeline_data_pipe"] = [float(pp_loss)]
    return losses


def _child(n: int) -> int:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(r, n, tmp)) for r in range(n)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(540)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
    if codes != [0] * n:
        print(f"dry run: rank exit codes {codes}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="multi-rank CPU dry run of the parallel layer")
    p.add_argument("n", type=int, nargs="?", default=None, help="ranks")
    p.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child is not None:
        return _child(args.child)
    if args.n is None:
        p.error("give the number of ranks")
    try:
        dryrun_multichip(args.n)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
