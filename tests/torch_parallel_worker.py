"""The rank side of the port's parallel tests: gloo worlds on the CPU.

`run_world(n, cases, tmp_path)` starts n spawned processes joined by a
FileStore in tmp_path (so concurrent test workers never share a port);
each runs every case, in order, and writes its results per case, which
`run_world` returns as {case name: [result of rank 0, rank 1, ...]}. A case
that raises is recorded as its traceback on that rank. This module imports
torch, numpy and the port only, never JAX, so the children start fast.
"""

from __future__ import annotations

import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD_TIMEOUT = 240.0


def run_world(n: int, cases, tmp_path, timeout: float = WORLD_TIMEOUT):
    """cases: [(name, function name in this module, kwargs)]."""
    tmp_path = str(tmp_path)
    os.makedirs(tmp_path, exist_ok=True)
    with open(os.path.join(tmp_path, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(rank, n, tmp_path)) for rank in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    out = {}
    for rank in range(n):
        path = os.path.join(tmp_path, f"results_{rank}.pkl")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {rank} wrote no results (exit codes {codes})")
        with open(path, "rb") as f:
            for name, value in pickle.load(f).items():
                out.setdefault(name, [None] * n)[rank] = value
    return out


def _rank_main(rank: int, n: int, tmp_path: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp_path, "store"), n)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n)
    with open(os.path.join(tmp_path, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    results = {}
    for name, fn, kwargs in cases:
        try:
            results[name] = globals()[fn](**kwargs)
        except Exception:
            results[name] = {"error": traceback.format_exc()}
        with open(os.path.join(tmp_path, f"results_{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    dist.destroy_process_group()


# ─── helpers ────────────────────────────────────────────────────────────

def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else t


def _cfg(depth=2, **overrides):
    from efficient_rpe_vit_torch.configs import mnist_config

    overrides.setdefault("dropout", 0.0)
    return mnist_config(depth=depth, **overrides)


def _mesh(spec):
    from efficient_rpe_vit_torch.parallel import make_mesh_from_spec

    return make_mesh_from_spec(spec, device="cpu")


def _model(name, mesh=None, depth=2, moe=None, attention=None, variables=None, **cfg):
    """The port's model on the CPU, its seq / expert axes from the mesh,
    carrying flax variables when given."""
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.parallel.mesh import local_slice, param_layouts
    from efficient_rpe_vit_torch.utils.import_flax import flax_to_state_dict

    attn = dict(attention or {})
    mlp = None
    if mesh is not None and "seq" in mesh:
        attn.update(seq_mesh=mesh, seq_axis="seq")
    if moe:
        mlp = {"mlp_type": "moe", "num_experts": moe}
        if mesh is not None and "expert" in mesh:
            mlp.update(expert_mesh=mesh, expert_axis="expert")
    model = create_model(name, _cfg(depth, **cfg), attention_config=attn or None,
                         mlp_config=mlp, device="cpu")
    if variables is not None:
        sd = flax_to_state_dict(*variables)
        layouts = param_layouts(model)
        for n, layout in layouts.items():
            shard, dim, blocks = layout
            sd[n] = local_slice(sd[n], dim, blocks, shard.index, shard.count)
        model.load_state_dict(sd, strict=True)
    return model


def _full_params(state):
    from efficient_rpe_vit_torch.parallel.train_parallel import full_payload

    return {n: _np(t) for n, t in full_payload(state)["model"].items()}


# ─── cases ──────────────────────────────────────────────────────────────

def specs(spec, name, moe=None):
    """The specs of the whole model's state dict, and whether
    `shard_pytree` of that state dict by them is what `shard_model` keeps."""
    from efficient_rpe_vit_torch.parallel import make_param_specs, shard_model, shard_pytree

    mesh = _mesh(spec)
    model = _model(name, mesh if moe else None, moe=moe)
    specs = make_param_specs(model, mesh, fsdp_axis="data" if "data" in mesh else None)
    full = model.state_dict()
    local = shard_pytree(full, specs, mesh)
    kept = shard_model(model, mesh).state_dict()
    return {"specs": {n: (s.dims, s.blocks, s.fsdp) for n, s in specs.items()},
            "shard_pytree": sorted(kept) == sorted(local)
            and all(torch.equal(local[n], t) for n, t in kept.items())}


def step(spec, name, x, y, variables=None, fsdp=False, moe=None, steps=1, accum=1,
         depth=2, ema=0.0, gen_seed=0, attention=None, full=True, **cfg):
    """Sharded train steps on this rank's rows; the global losses and counts
    and the whole model after them."""
    from efficient_rpe_vit_torch.parallel import (
        create_sharded_train_state,
        host_batch_slice,
        make_parallel_train_step,
    )

    mesh = _mesh(spec)
    model = _model(name, mesh, depth, moe, attention, variables, **cfg)
    state = create_sharded_train_state(model, _cfg(depth, **cfg), mesh, steps_per_epoch=10,
                                       ema_decay=ema, fsdp=fsdp)
    train_step = make_parallel_train_step(model, mesh, state, grad_accum=accum)
    gen = torch.Generator().manual_seed(gen_seed)
    losses, corrects = [], []
    for i in range(steps):
        xs, ys = torch.from_numpy(x[i % len(x)]), torch.from_numpy(y[i % len(y)])
        rows = host_batch_slice(xs.shape[0], mesh)
        state, loss, correct = train_step(state, xs[rows], ys[rows], gen)
        losses.append(float(loss))
        corrects.append(int(correct))
    out = {"loss": losses, "correct": corrects}
    if full:
        out["params"] = _full_params(state)
    if ema:
        from efficient_rpe_vit_torch.parallel.train_parallel import full_payload

        out["ema"] = {n: _np(t) for n, t in full_payload(state)["ema_params"].items()}
    return out


def forward_grads(spec, name, x, cot, variables, moe=None, depth=2):
    """Eval-mode logits and the gradients of sum(logits * cot), whole."""
    from efficient_rpe_vit_torch.parallel.mesh import gather_full, param_layouts

    mesh = _mesh(spec)
    model = _model(name, mesh, depth, moe, None, variables)
    model.eval()
    logits = model(torch.from_numpy(x))
    (logits * torch.from_numpy(cot)).sum().backward()
    layouts = param_layouts(model)
    grads = {n: _np(gather_full(p.grad, layouts[n]) if n in layouts else p.grad)
             for n, p in model.named_parameters()}
    return {"logits": _np(logits), "grads": grads}


def seq_ops(inputs):
    """The three sequence-parallel cores and their gradients on this world."""
    from efficient_rpe_vit_torch.parallel import (
        ring_kerple_attention,
        ring_softmax_attention,
        seq_parallel_linear_attention,
    )

    group = dist.group.WORLD
    out = {}
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in inputs.items()
         if k != "cot"}
    cot = torch.from_numpy(inputs["cot"])
    for name, fn, args in (
            ("linear", seq_parallel_linear_attention, ("qp", "kp", "v")),
            ("kerple", ring_kerple_attention, ("qp", "kp", "v", "coeffs")),
            ("softmax", lambda q, k, v, g: ring_softmax_attention(
                q, k, v, q.shape[-1] ** -0.5, g), ("q", "k", "v"))):
        for a in args:
            t[a].grad = None
        res = fn(*(t[a] for a in args), group)
        (res * cot).sum().backward()
        out[name] = {"out": _np(res), **{f"d{a}": _np(t[a].grad) for a in args}}
    return out


def multistep(spec, name, x, y, k=3):
    """make_parallel_multi_step over K stacked batches against K calls of
    the sharded step from the same state."""
    from efficient_rpe_vit_torch.parallel import (
        create_sharded_train_state,
        host_batch_slice,
        make_parallel_multi_step,
        make_parallel_train_step,
    )

    mesh = _mesh(spec)
    outs = []
    for fused in (False, True):
        model = _model(name, mesh)
        state = create_sharded_train_state(model, _cfg(), mesh, steps_per_epoch=10)
        gen = torch.Generator().manual_seed(3)
        rows = host_batch_slice(x.shape[1], mesh)
        xs, ys = torch.from_numpy(x[:k, rows]), torch.from_numpy(y[:k, rows])
        if fused:
            multi = make_parallel_multi_step(model, mesh, state)
            state, losses, corrects = multi(state, xs, ys, gen)
            losses = [float(v) for v in losses]
        else:
            one = make_parallel_train_step(model, mesh, state)
            losses = []
            for i in range(k):
                state, loss, _ = one(state, xs[i], ys[i], gen)
                losses.append(float(loss))
        outs.append({"losses": losses, "params": _full_params(state), "step": state.step})
    return outs


def epoch(spec, name, images, labels, fused_steps=1):
    """parallel_train_epoch on a DeviceDataset every rank builds alike."""
    from efficient_rpe_vit_torch.data.pipeline import DeviceDataset
    from efficient_rpe_vit_torch.parallel import (
        create_sharded_train_state,
        make_parallel_multi_step,
        make_parallel_train_step,
        parallel_train_epoch,
    )

    mesh = _mesh(spec)
    ds = DeviceDataset(images, labels, (0.1307,), (0.3081,), 16, shuffle=True,
                       drop_last=True, seed=0, device="cpu")
    model = _model(name, mesh)
    state = create_sharded_train_state(model, _cfg(), mesh, steps_per_epoch=len(ds))
    step_fn = make_parallel_train_step(model, mesh, state)
    multi = make_parallel_multi_step(model, mesh, state) if fused_steps > 1 else None
    state, metrics = parallel_train_epoch(state, step_fn, ds, torch.Generator().manual_seed(0),
                                          mesh, multi_step=multi, fused_steps=fused_steps,
                                          verbose=False)
    return {"metrics": {k: v for k, v in metrics.items() if k != "time"},
            "params": _full_params(state)}


def redraw(spec, name, x, y, interval=1):
    """Tensor-parallel feature redraw: each rank's Omega after a step."""
    out = step(spec, name, x, y, attention={"feature_redraw_interval": interval}, full=True)
    return {"omega": {n: v for n, v in out["params"].items() if n.endswith("omega")}}


def state_bytes(spec, name, fsdp, x, y):
    """This rank's bytes of parameters, optimiser state and EMA shadow at
    rest after one step."""
    from efficient_rpe_vit_torch.parallel import (
        create_sharded_train_state,
        host_batch_slice,
        make_parallel_train_step,
    )

    mesh = _mesh(spec)
    model = _model(name, mesh)
    state = create_sharded_train_state(model, _cfg(), mesh, ema_decay=0.9, fsdp=fsdp)
    rows = host_batch_slice(x.shape[0], mesh)
    state, _, _ = make_parallel_train_step(model, mesh, state)(
        state, torch.from_numpy(x[rows]), torch.from_numpy(y[rows]), torch.Generator())
    tensors = [p for _, p in state.model.named_parameters()]
    if fsdp:
        tensors += list(state.fsdp.shards.values())
    tensors += [v for per in state.optimizer.state.values() for v in per.values()
                if torch.is_tensor(v) and v.dim() > 0]
    tensors += list(state.ema_params.values())
    return {"bytes": sum(t.numel() * t.element_size() for t in tensors)}


def checkpoint_save(spec, name, path, x, y, fsdp=False, ema=0.0):
    """One sharded step, then save; the whole model for the parent."""
    from efficient_rpe_vit_torch.parallel import (
        create_sharded_train_state,
        host_batch_slice,
        make_parallel_train_step,
    )
    from efficient_rpe_vit_torch.train import save_checkpoint

    mesh = _mesh(spec)
    model = _model(name, mesh)
    state = create_sharded_train_state(model, _cfg(), mesh, steps_per_epoch=10, fsdp=fsdp,
                                       ema_decay=ema)
    rows = host_batch_slice(x.shape[0], mesh)
    state, _, _ = make_parallel_train_step(model, mesh, state)(
        state, torch.from_numpy(x[rows]), torch.from_numpy(y[rows]), torch.Generator())
    save_checkpoint(path, state, epoch=1, metrics={"test_accuracy": 1.0})
    return {"exists": os.path.exists(path), "params": _full_params(state)}


def checkpoint_load(spec, name, path, x, y, fsdp=False, ema=0.0):
    """Load a single-device checkpoint under the mesh and take one step."""
    from efficient_rpe_vit_torch.parallel import (
        create_sharded_train_state,
        host_batch_slice,
        make_parallel_train_step,
    )
    from efficient_rpe_vit_torch.parallel.train_parallel import full_payload
    from efficient_rpe_vit_torch.train import load_checkpoint

    mesh = _mesh(spec)
    model = _model(name, mesh)
    state = create_sharded_train_state(model, _cfg(), mesh, steps_per_epoch=10, fsdp=fsdp,
                                       ema_decay=ema)
    state, meta = load_checkpoint(path, state)
    loaded = full_payload(state)
    rows = host_batch_slice(x.shape[0], mesh)
    state, loss, _ = make_parallel_train_step(model, mesh, state)(
        state, torch.from_numpy(x[rows]), torch.from_numpy(y[rows]), torch.Generator())
    return {"epoch": meta["epoch"], "step": state.step, "loss": float(loss),
            "loaded": {n: _np(t) for n, t in loaded["model"].items()},
            "moments": {i: _np(per["exp_avg"]) for i, per in loaded["optimizer"]["state"].items()},
            "params": _full_params(state)}


def multihost(batch):
    """The multihost helpers of this world."""
    from efficient_rpe_vit_torch.parallel import multihost as mh

    out = {"count": mh.process_count(), "index": mh.process_index(),
           "coordinator": mh.is_coordinator(),
           "rows": mh.host_batch_slice(batch),
           "seed": mh.broadcast_scalar(1234 if mh.process_index() == 0 else -1)}
    try:
        mh.host_batch_slice(batch + 1)
    except ValueError as e:
        out["ragged"] = str(e)
    mh.initialize()  # joined already: a no-op
    mh.sync("end")
    mesh = _mesh(f"data={mh.process_count()}")
    got = mh.global_batch({"x": np.arange(4.0)}, mesh)
    out["global_batch"] = (type(got["x"]).__name__, str(got["x"].device))
    out["mesh_rows"] = mh.host_batch_slice(batch, mesh)
    return out


def refusals(name):
    """What the parallel layer refuses on this world, each as its message."""
    from efficient_rpe_vit_torch.models import create_model
    from efficient_rpe_vit_torch.parallel import (
        create_sharded_train_state,
        make_mesh,
        make_parallel_train_step,
    )

    out = {}

    def refused(key, fn):
        try:
            fn()
            out[key] = None
        except (ValueError, TypeError, NotImplementedError) as e:
            out[key] = f"{type(e).__name__}: {e}"

    world = dist.get_world_size()
    mesh = _mesh(f"data={world}")
    refused("mesh_product", lambda: make_mesh(n_data=world + 1))
    refused("mesh_divides", lambda: make_mesh(n_model=world + 1))
    refused("spec_product", lambda: _mesh(f"data={world},model=2"))
    refused("fsdp_axis", lambda: create_sharded_train_state(
        _model(name), _cfg(), mesh, fsdp=True, fsdp_axis="nope"))
    refused("seq_axis", lambda: _model(name, attention={"seq_mesh": mesh}))
    refused("experts", lambda: create_model(name, _cfg(), device="cpu", mlp_config={
        "mlp_type": "moe", "num_experts": 3, "expert_mesh": _mesh(f"expert={world}")}))
    seq = _mesh(f"seq={world}")
    base = _model("baseline", seq, depth=1)
    refused("seq_mask", lambda: base.transformer_blocks[0].attention(
        torch.zeros(1, 17, 32), mask=torch.ones(1, 1, 17, 17, dtype=torch.bool)))
    refused("seq_maps", lambda: base(torch.zeros(1, 28, 28, 1), return_attention=True))
    drop = _model("baseline", seq, depth=1, dropout=0.1)
    drop.train()
    refused("seq_dropout", lambda: drop(torch.zeros(2, 28, 28, 1), torch.Generator()))
    model = _model(name, mesh)
    other = _model(name, mesh)
    state = create_sharded_train_state(model, _cfg(), mesh)
    refused("foreign_state", lambda: make_parallel_train_step(
        other, mesh, create_sharded_train_state(other, _cfg(), mesh))(
            state, torch.zeros(2, 28, 28, 1), torch.zeros(2, dtype=torch.long),
            torch.Generator()))
    return out


# ─── the GPipe pipeline ─────────────────────────────────────────────────

def _whole_grads(model, mesh):
    """{name: whole gradient} of this rank's parameters (split ones
    gathered over their axis)."""
    from efficient_rpe_vit_torch.parallel.mesh import gather_full, param_layouts

    layouts = param_layouts(model)
    return {n: _np(gather_full(p.grad, layouts[n]) if n in layouts else p.grad)
            for n, p in model.named_parameters() if p.grad is not None}


def pipe_forward(spec, name, x, variables, depth, microbatches, grads=False, moe=None):
    """Eval-mode GPipe logits of the global batch on this rank, the
    sequential model's logits from the same weights, and with `grads` the
    whole gradients of sum(logits ** 2) that this rank holds."""
    from efficient_rpe_vit_torch.parallel import (
        pipeline_vit_forward,
        reduce_pipeline_grads,
        stage_model,
    )

    mesh = _mesh(spec)
    model = _model(name, None, depth, moe, None, variables)
    model.eval()
    with torch.no_grad():
        sequential = model(torch.from_numpy(x))
    stage_model(model, mesh)
    logits = pipeline_vit_forward(model, torch.from_numpy(x), mesh, microbatches)
    out = {"logits": _np(logits), "sequential": _np(sequential),
           "stage": (model.stage.lo, model.stage.hi)}
    if grads:
        (logits ** 2).sum().backward()
        reduce_pipeline_grads(model)
        out["grads"] = _whole_grads(model, mesh)
    return out


def pipe_step(spec, name, x, y, variables=None, depth=2, microbatches=None, accum=1,
              steps=1, gen_seed=0, full=True, **cfg):
    """Pipelined train steps on the global batch, the stage's part of the
    flax variables loaded into it; the global losses and counts, and the
    whole model after them."""
    from efficient_rpe_vit_torch.parallel import (
        create_pipeline_train_state,
        make_pipeline_train_step,
    )
    from efficient_rpe_vit_torch.parallel.train_parallel import parameter_count
    from efficient_rpe_vit_torch.utils.import_flax import flax_to_state_dict

    mesh = _mesh(spec)
    model = _model(name, None, depth, **cfg)
    state = create_pipeline_train_state(
        model, _cfg(depth, **cfg), mesh, steps_per_epoch=10,
        state_dict=flax_to_state_dict(*variables) if variables is not None else None)
    train_step = make_pipeline_train_step(model, mesh, state, n_microbatches=microbatches,
                                          grad_accum=accum)
    gen = torch.Generator().manual_seed(gen_seed)
    losses, corrects = [], []
    for i in range(steps):
        state, loss, correct = train_step(state, torch.from_numpy(x[i % len(x)]),
                                          torch.from_numpy(y[i % len(y)]), gen)
        losses.append(float(loss))
        corrects.append(int(correct))
    out = {"loss": losses, "correct": corrects, "count": parameter_count(state)["total"],
           "names": sorted(n for n, _ in model.named_parameters())}
    if full:
        out["params"] = _full_params(state)
    return out


def pipe_checkpoint(spec, name, path, x, y, depth=2, microbatches=None):
    """A pipelined step, a save (every rank calls it) and a second step;
    then a fresh stage loads the file and takes that second step too."""
    from efficient_rpe_vit_torch.parallel import (
        create_pipeline_train_state,
        make_pipeline_train_step,
    )
    from efficient_rpe_vit_torch.train import load_checkpoint, save_checkpoint

    mesh = _mesh(spec)
    out = {}
    for load in (False, True):
        model = _model(name, None, depth)
        state = create_pipeline_train_state(model, _cfg(depth), mesh, steps_per_epoch=10,
                                            ema_decay=0.9)
        step = make_pipeline_train_step(model, mesh, state, n_microbatches=microbatches)
        args = (torch.from_numpy(x), torch.from_numpy(y))
        if load:
            state, _ = load_checkpoint(path, state)
        else:
            state, _, _ = step(state, *args, torch.Generator())
            save_checkpoint(path, state, epoch=1, metrics={"test_accuracy": 1.0})
            out["saved"] = _full_params(state)
        state, loss, _ = step(state, *args, torch.Generator())
        out["resumed" if load else "continued"] = {
            "loss": float(loss), "params": _full_params(state), "step": state.step}
    return out


def pipe_refusals(name):
    """What the pipeline refuses on this world, each as its message."""
    from efficient_rpe_vit_torch.parallel import (
        create_pipeline_train_state,
        make_pipeline_train_step,
        pipeline_vit_forward,
        stage_model,
    )

    out = {}

    def refused(key, fn):
        try:
            fn()
            out[key] = None
        except (ValueError, TypeError, RuntimeError) as e:
            out[key] = f"{type(e).__name__}: {e}"

    world = dist.get_world_size()
    mesh = _mesh(f"pipe={world}")
    refused("depth", lambda: stage_model(_model(name, depth=world + 1), mesh))
    staged = stage_model(_model(name, depth=world), mesh)
    refused("batch", lambda: pipeline_vit_forward(staged, torch.zeros(world + 1, 28, 28, 1),
                                                  mesh))
    refused("unstaged", lambda: pipeline_vit_forward(_model(name, depth=world),
                                                     torch.zeros(world, 28, 28, 1), mesh))
    refused("remote", lambda: staged(torch.zeros(world, 28, 28, 1)))
    refused("no_pipe", lambda: stage_model(_model(name, depth=world), _mesh(f"data={world}")))
    refused("seq", lambda: stage_model(_model(name, depth=world), _mesh(
        f"pipe={world // 2},seq=2")))
    model = _model(name, depth=world)
    state = create_pipeline_train_state(model, _cfg(world), mesh)
    step = make_pipeline_train_step(model, mesh, state, grad_accum=3)
    refused("accum", lambda: step(state, torch.zeros(8, 28, 28, 1),
                                  torch.zeros(8, dtype=torch.long), torch.Generator()))
    return out



def pipe_shared_masks(spec, name, x, depth=2):
    """Train-mode GPipe logits at dropout 0.1 over two microbatches, and
    the eval-mode logits of the same weights."""
    from efficient_rpe_vit_torch.parallel import pipeline_vit_forward, stage_model

    mesh = _mesh(spec)
    model = stage_model(_model(name, None, depth, dropout=0.1), mesh)
    model.train()
    with torch.no_grad():
        train = pipeline_vit_forward(model, torch.from_numpy(x), mesh, 2,
                                     torch.Generator().manual_seed(4))
        model.eval()
        evaluated = pipeline_vit_forward(model, torch.from_numpy(x), mesh, 2)
    return {"train": _np(train), "eval": _np(evaluated)}


def runner_ranks(out, fail_rank=None, skip_existing=False):
    """The benchmark runner on a data=2 mesh over this world, its runs
    faked: each run takes part in one all-reduce, as a mesh run's steps
    do, and raises on `fail_rank`; with `skip_existing` only the
    coordinator finds seed 42's metrics. Returns the seeds this rank ran
    and what the runner raised or returned."""
    from efficient_rpe_vit_torch import train as port_train
    from efficient_rpe_vit_torch.experiments import benchmark

    rank = dist.get_rank()
    metrics = {"aggregate": {"final_test_accuracy": 50.0, "best_test_accuracy": 50.0,
                             "final_test_loss": 1.0, "total_train_time": 1.0},
               "inference": {"throughput_images_per_sec": 1.0, "latency_mean_ms": 1.0}}
    calls = []

    def run(model, seed, out_dir, args, shared=None):
        calls.append(seed)
        if rank == fail_rank:
            raise ValueError(f"rank {rank} failed")
        dist.all_reduce(torch.ones(1))
        return metrics

    def load(path):
        return metrics if rank == 0 and "seed_42" in path else None

    plain_run, plain_load = benchmark.run_single_training, port_train.load_run_metrics
    benchmark.run_single_training, port_train.load_run_metrics = run, load
    argv = ["--models", "performer_favor_most_general", "--num-runs", "2", "--mesh", "data=2",
            "--cpu", "--quiet", "--output-dir", out, "--distributed", "127.0.0.1:1",
            "--num-processes", str(dist.get_world_size()), "--process-id", str(rank)]
    try:
        summary = benchmark.main(argv + (["--skip-existing"] if skip_existing else []))
        result = {"num_runs": summary["performer_favor_most_general"]["num_runs"]}
    except Exception as e:
        result = {"raised": f"{type(e).__name__}: {e}"}
    finally:
        benchmark.run_single_training, port_train.load_run_metrics = plain_run, plain_load
    return dict(result, calls=calls)
