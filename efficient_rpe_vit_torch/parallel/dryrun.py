"""A multi-rank dry run of the parallel layer on the CPU.

Counterpart of `__graft_entry__.py::dryrun_multichip`: `dryrun_multichip(n)`
starts a child process that runs an n-rank gloo world on the CPU and takes
every part of the JAX dry run, each gated on n as the JAX one gates it,
on `mnist_config(dropout=0.1)`:

  * the flagship's sharded train step with `grad_accum=2` (data x model,
    model = 2 when n is even, an EMA shadow), then one
    `make_parallel_multi_step` call of two steps;
  * the sequence-parallel ops over 'data': context-sharded linear
    attention, ring KERPLE and ring softmax attention at N = 8 x data;
  * the DP x CP train step through the model's `seq_mesh` (seq = 2 when n
    is even);
  * with n even, GPipe over n_pipe stages (4 when 4 divides n, else 2) of
    a depth-n_pipe model with soft-MoE MLPs: the pipelined forward and its
    gradients;
  * with 8 dividing n, DP x PP x TP at 2 x 2 x 2: one GPipe train step of
    6 microbatches with `grad_accum=2`;
  * with n even, expert-parallel MoE (n_pipe experts over 'expert'):
    forward and gradients;
  * FSDP over 'data': the largest parameter's local shard times the data
    size is at most its full size, then one step;
  * ensemble x DP: n members sharded over 'data', one member a rank, one
    `make_ensemble_train_step(mesh=)` step.

Every loss must be finite; any failure, on any rank, makes the child and
the call fail.

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
    from ..train import create_ensemble_train_state, ensemble_members, make_ensemble_train_step
    from . import (
        create_pipeline_train_state,
        create_sharded_train_state,
        host_batch_slice,
        make_mesh,
        make_mesh_from_spec,
        make_parallel_multi_step,
        make_parallel_train_step,
        make_pipeline_train_step,
        pipeline_vit_forward,
        ring_kerple_attention,
        ring_softmax_attention,
        seq_parallel_linear_attention,
    )

    cfg = mnist_config(dropout=0.1)
    name = "performer_favor_most_general"
    g = torch.Generator().manual_seed(0)
    losses = {}

    def seeded(seed):
        return torch.Generator().manual_seed(seed)

    def build(model_name, mesh=None, seed=1, **kwargs):
        return create_model(model_name, cfg, device="cpu", generator=seeded(seed), **kwargs)

    # the sharded step with grad_accum, then the fused multi-step
    mesh = make_mesh(n_model=2 if n % 2 == 0 and n > 1 else 1, device="cpu")
    batch = max(8, 2 * mesh.size("data"))
    batch -= batch % mesh.size("data")
    images = torch.randn(batch, 28, 28, 1, generator=g)
    labels = torch.arange(batch) % 10
    rows = host_batch_slice(batch, mesh)
    model = build(name)
    state = create_sharded_train_state(model, cfg, mesh, steps_per_epoch=10, ema_decay=0.99)
    step = make_parallel_train_step(model, mesh, state, grad_accum=2)
    state, loss, _ = step(state, images[rows], labels[rows], seeded(2))
    losses["sharded_grad_accum2"] = [float(loss)]

    multi = make_parallel_multi_step(model, mesh, state)
    xs = torch.stack([images[rows], images[rows]])
    ys = torch.stack([labels[rows], labels[rows]])
    state, mlosses, _ = multi(state, xs, ys, seeded(3))
    losses["multi_step"] = [float(v) for v in mlosses]

    # the sequence-parallel ops over 'data'
    group = mesh.get_group("data")
    p = mesh.size("data")
    N, (B, H, F, D) = 8 * p, (2, 2, 12, 16)
    qp = torch.randn(B, H, N, F, generator=g).abs() * 0.2
    kp = torch.randn(B, H, N, F, generator=g).abs() * 0.2
    v = torch.randn(B, H, N, D, generator=g)
    coeffs = torch.exp(torch.randn(H, 2 * N - 1, generator=g) * 0.05)
    qd = torch.randn(B, H, N, D, generator=g)
    ops = (seq_parallel_linear_attention(qp, kp, v, group),
           ring_kerple_attention(qp, kp, v, coeffs, group),
           ring_softmax_attention(qd, qd, v, D ** -0.5, group))
    losses["seq_parallel_ops"] = [float(o.abs().sum()) for o in ops]

    # DP x CP: the sequence split over 'seq' inside the model's attention
    cp_mesh = make_mesh(n_model=2 if n % 2 == 0 else 1, axis_names=("data", "seq"),
                        device="cpu")
    cp_model = build(name, attention_config={"seq_mesh": cp_mesh, "seq_axis": "seq"})
    cp_state = create_sharded_train_state(cp_model, cfg, cp_mesh, steps_per_epoch=10)
    cp_step = make_parallel_train_step(cp_model, cp_mesh, cp_state)
    cp_batch = max(8, 2 * cp_mesh.size("data"))
    cp_batch -= cp_batch % cp_mesh.size("data")
    cp_rows = host_batch_slice(cp_batch, cp_mesh)
    cp_state, cp_loss, _ = cp_step(cp_state, images[:cp_batch][cp_rows],
                                   labels[:cp_batch][cp_rows], seeded(4))
    losses["cp_train_step"] = [float(cp_loss)]

    # GPipe with soft-MoE inside the staged blocks: forward and gradients
    n_pipe = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    if n_pipe > 1:
        pp_mesh = make_mesh(n_model=n_pipe, axis_names=("data", "pipe"), device="cpu")
        pp_model = build(name, seed=5, depth=n_pipe,
                         mlp_config={"mlp_type": "moe", "num_experts": 2})
        create_pipeline_train_state(pp_model, cfg, pp_mesh, steps_per_epoch=10)
        pp_x = torch.randn(8, 28, 28, 1, generator=g)
        pp_val = (pipeline_vit_forward(pp_model, pp_x, pp_mesh) ** 2).sum()
        pp_val.backward()
        grads = [p.grad for p in pp_model.parameters() if p.grad is not None]
        losses["pipeline_moe"] = [float(pp_val.detach()),
                                  float(sum(t.abs().sum() for t in grads))]

    # DP x PP x TP at 2 x 2 x 2: 6 microbatches over 2 stages, grad_accum 2
    if n % 8 == 0:
        m3_mesh = make_mesh_from_spec(f"data={n // 4},pipe=2,model=2", device="cpu")
        m3_model = build(name, seed=6, depth=2)
        m3_state = create_pipeline_train_state(m3_model, cfg, m3_mesh, steps_per_epoch=10)
        m3_step = make_pipeline_train_step(m3_model, m3_mesh, m3_state, n_microbatches=6,
                                           grad_accum=2)
        m3_state, m3_loss, _ = m3_step(m3_state, torch.randn(24, 28, 28, 1, generator=g),
                                       torch.arange(24) % 10, seeded(7))
        losses["dp_pp_tp_step"] = [float(m3_loss)]

    # expert parallelism: the soft-MoE experts split over 'expert'
    if n_pipe > 1:
        ep_mesh = make_mesh(n_model=n_pipe, axis_names=("data", "expert"), device="cpu")
        ep_model = build("performer_favor", seed=8,
                         mlp_config={"mlp_type": "moe", "num_experts": n_pipe,
                                     "expert_mesh": ep_mesh, "expert_axis": "expert"})
        ep_val = (ep_model(torch.randn(8, 28, 28, 1, generator=g)) ** 2).sum()
        ep_val.backward()
        losses["expert_moe"] = [float(ep_val.detach())]

    # FSDP: parameters and moments scattered over 'data'
    fsdp_model = build(name, seed=1)
    fsdp_state = create_sharded_train_state(fsdp_model, cfg, mesh, steps_per_epoch=10,
                                            fsdp=True)
    big = max(fsdp_state.fsdp.meta, key=lambda k: fsdp_state.fsdp.meta[k][1])
    full_size = fsdp_state.fsdp.meta[big][1]
    if fsdp_state.fsdp.shards[big].numel() * mesh.size("data") > full_size:
        raise AssertionError(f"fsdp leaf {big} not scattered over 'data'")
    fsdp_step = make_parallel_train_step(fsdp_model, mesh, fsdp_state)
    fsdp_state, fsdp_loss, _ = fsdp_step(fsdp_state, images[rows], labels[rows], seeded(9))
    losses["fsdp_step"] = [float(fsdp_loss)]

    # ensemble x DP: n members sharded over 'data', no collective in the step
    ens_mesh = make_mesh(n_model=1, device="cpu")
    mine = ensemble_members(n, ens_mesh)
    ens_models = [build("performer_relu_rope", seed=100 + i) for i in mine]
    ens_state = create_ensemble_train_state(ens_models, cfg, steps_per_epoch=10)
    ens_step = make_ensemble_train_step(ens_models, mesh=ens_mesh)
    ens_state, ens_losses, _ = ens_step(ens_state, images[:8], labels[:8],
                                        [seeded(200 + i) for i in mine])
    if ens_losses.shape != (n,):
        raise AssertionError(f"ensemble losses of shape {tuple(ens_losses.shape)}, "
                             f"expected ({n},)")
    losses["ensemble_dp"] = [float(v) for v in ens_losses]
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
