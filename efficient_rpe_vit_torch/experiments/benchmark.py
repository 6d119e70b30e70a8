#!/usr/bin/env python
"""Multi-model, multi-seed benchmark runner of the port.

Counterpart of `experiments/benchmark.py` (the JAX package's), with its
flags, names and defaults plus `--cpu`: train every (model, seed) through
the port's train CLI, aggregate each model's runs (`aggregated_stats.json`),
print the summary table and write `benchmark_config.json` with the argv,
under `results/benchmark_{dataset}_{timestamp}` unless `--output-dir`.

    python -m efficient_rpe_vit_torch.experiments.benchmark \\
        --models performer_favor_most_general baseline --num-runs 3 --epochs 3

Runs go in process, one model's seeds sharing one `shared` dict (the first
seed's datasets, state and captured CUDA graphs, reset for each later
seed, `experiments/train.py::main`); `--subprocess` runs each in a fresh
interpreter. A failing run is printed and skipped; `--skip-existing`
keeps the runs whose metrics JSON exists. `--ensemble` trains all seeds of
a model together (`run_ensemble_benchmark`): one CUDA graph per chunk
holds every member's K steps, and each seed's metrics JSON has a
sequential run's schema. The default device is the GPU; `--cpu` runs on
the CPU.

`--mesh` and `--microbatches` are forwarded to every run, as the JAX
runner forwards them. A mesh needs one process per rank, and the runner
runs under those processes: start it as the train CLI is started for a
mesh, with `--distributed` (torchrun's environment, or `host:port` with
`--num-processes` and `--process-id`); it joins the process group once and
every rank runs every (model, seed) in process on it. The ranks decide
together: `--skip-existing` reads the coordinator's metrics files and every
rank takes its answer, and a run that fails on any rank stops the runner
(its exception propagates, so the peers' collectives fail with it) instead
of being skipped on that rank alone. The coordinator alone prints and
writes the aggregates; `--subprocess` and `--ensemble` do not compose with
`--mesh`.

    torchrun --nproc-per-node 4 -m efficient_rpe_vit_torch.experiments.benchmark \
        --models performer_favor_most_general --depth 4 --mesh data=2,pipe=2 \
        --microbatches 4 --distributed
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from datetime import datetime

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRAIN_MODULE = "efficient_rpe_vit_torch.experiments.train"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Benchmark ViT variants (PyTorch port)")
    p.add_argument("--models", type=str, nargs="+", required=True)
    p.add_argument("--dataset", type=str, default="mnist",
                   choices=["mnist", "cifar10"])
    p.add_argument("--num-runs", type=int, default=3)
    p.add_argument("--seeds", type=int, nargs="*", default=None,
                   help="explicit seeds; default 42+111*i")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--compute-dtype", type=str, default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--mlp-type", type=str, default=None,
                   choices=["dense", "moe"])
    p.add_argument("--num-experts", type=int, default=None)
    p.add_argument("--num-features", type=str, default=None,
                   help="kernel-attention feature count: int or 'mxu' "
                        "(forwarded to the train CLI)")
    p.add_argument("--augmentation", action="store_true", default=None)
    p.add_argument("--grad-accum", type=int, default=None,
                   help="forwarded to the train CLI's --grad-accum")
    p.add_argument("--fused-steps", type=int, default=None,
                   help="forwarded to the train CLI's --fused-steps (K steps "
                        "per CUDA graph replay)")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="forwarded to the train CLI's --ema-decay")
    p.add_argument("--label-smoothing", type=float, default=None,
                   help="forwarded to the train CLI's --label-smoothing")
    p.add_argument("--remat", action="store_true", default=None,
                   help="forwarded to the train CLI's --remat")
    p.add_argument("--mesh", type=str, default=None,
                   help="forwarded to the train CLI's --mesh (one process per rank: "
                        "run the runner under --distributed)")
    p.add_argument("--depth", type=int, default=None,
                   help="forwarded to the train CLI's --depth")
    p.add_argument("--microbatches", type=int, default=None,
                   help="forwarded to the train CLI's --microbatches (GPipe)")
    p.add_argument("--output-dir", type=str, default=None,
                   help="default results/benchmark_{dataset}_{timestamp}")
    p.add_argument("--skip-existing", action="store_true",
                   help="resume a partially completed benchmark")
    p.add_argument("--subprocess", action="store_true",
                   help="run each (model, seed) in a fresh interpreter")
    p.add_argument("--ensemble", action="store_true",
                   help="train all seeds of each model together: every "
                        "member's K steps of an epoch chunk in one CUDA graph "
                        "on the GPU (--fused-steps, default 64); per-seed "
                        "metrics JSONs with a sequential run's schema")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (tests, debugging); the default is the GPU")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--distributed", nargs="?", const="auto", default=None,
                   metavar="COORD",
                   help="join the ranks' process group before the runs, as the train "
                        "CLI's --distributed (bare: torchrun's environment)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="process count for an explicit --distributed COORD")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank for an explicit --distributed COORD")
    return p.parse_args(argv)


def setup_benchmark_directory(args) -> str:
    """results/benchmark_{dataset}_{timestamp}, or --output-dir."""
    if args.output_dir:
        out = args.output_dir
    else:
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        out = os.path.join("results", f"benchmark_{args.dataset}_{ts}")
    os.makedirs(out, exist_ok=True)
    return out


def _metrics_path(model_dir: str, run_idx: int, seed: int, model: str, dataset: str) -> str:
    return os.path.join(model_dir, f"run_{run_idx}_seed_{seed}",
                        f"{model}_{dataset}_metrics.json")


def train_cli_args(model: str, seed: int, run_dir: str, args):
    """The train CLI's argv for one (model, seed) run."""
    cli = ["--model", model, "--dataset", args.dataset, "--seed", str(seed),
           "--output-dir", run_dir, "--quiet"]
    for flag, value in (("--epochs", args.epochs), ("--batch-size", args.batch_size),
                        ("--compute-dtype", args.compute_dtype),
                        ("--mlp-type", args.mlp_type), ("--num-experts", args.num_experts),
                        ("--num-features", args.num_features),
                        ("--grad-accum", args.grad_accum),
                        ("--fused-steps", args.fused_steps),
                        ("--ema-decay", args.ema_decay),
                        ("--label-smoothing", args.label_smoothing),
                        ("--mesh", args.mesh), ("--depth", args.depth),
                        ("--microbatches", args.microbatches)):
        if value is not None:
            cli += [flag, str(value)]
    for flag, on in (("--augmentation", args.augmentation), ("--remat", args.remat),
                     ("--cpu", args.cpu), ("--distributed", args.distributed is not None)):
        if on:
            cli.append(flag)  # the group is joined already: the run takes it
    return cli


def run_single_training(model: str, seed: int, run_dir: str, args, shared=None):
    """One (model, seed) run -> its metrics dict: in process through the
    train CLI's `main(cli, shared=shared)`, or with `--subprocess` in a
    fresh interpreter (`python -m efficient_rpe_vit_torch.experiments.train`),
    raising on a non-zero exit with the tail of its stderr."""
    from ..train import load_run_metrics

    cli = train_cli_args(model, seed, run_dir, args)
    if args.subprocess:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
        result = subprocess.run([sys.executable, "-m", TRAIN_MODULE] + cli,
                                capture_output=True, text=True, env=env)
        if result.returncode != 0:
            raise RuntimeError(f"{TRAIN_MODULE} failed (rc={result.returncode}):\n"
                               f"{result.stderr[-2000:]}")
        return load_run_metrics(os.path.join(run_dir, f"{model}_{args.dataset}_metrics.json"))
    from .train import main as train_main

    return train_main(cli, shared=shared)


def run_ensemble_benchmark(model_name: str, seeds, model_dir: str, args):
    """Train all seeds of one model together and write one metrics JSON per
    seed, with a sequential run's schema, stamped `metadata.ensemble_size`.

    Member i is built as the train CLI builds seed i's model (its config's
    seed, `set_random_seeds(seed_i)`), draws dropout and augmentation from
    a generator seeded seed_i, as the CLI's, and its data order from
    `np.random.default_rng(seed_i)`, the stream of seed i's dataset: it
    computes what the sequential run of seed i computes with the same
    --fused-steps (default 64 here). On the GPU each epoch chunk is one CUDA
    graph replay for all members. `total_train_time` and each epoch's
    `epoch_time` are the ensemble's shared wall time
    (`aggregate.time_is_shared_ensemble_wall`)."""
    import numpy as np
    import torch

    from ..configs import get_dataset_config
    from ..data import get_dataloaders
    from ..models import count_parameters, create_model
    from ..train import (
        benchmark_inference,
        copy_module_,
        create_ensemble_train_state,
        ensemble_evaluate,
        ensemble_train_epoch,
        make_ensemble_gather_multi_eval,
        make_ensemble_gather_multi_step,
        make_inference_chain,
        save_run_metrics,
        set_random_seeds,
    )
    from ..train.metrics import compute_information_criteria
    from ..utils.device import resolve_device
    from .train import device_name, model_options

    # `or` would map an explicit --fused-steps 0 to the default
    fused_steps = 64 if args.fused_steps is None else args.fused_steps
    if fused_steps < 1:
        raise ValueError(f"--fused-steps must be >= 1, got {fused_steps}")
    device = resolve_device("cpu" if args.cpu else None)
    configs = [get_dataset_config(args.dataset, batch_size=args.batch_size,
                                  epochs=args.epochs, augmentation=args.augmentation,
                                  compute_dtype=args.compute_dtype, seed=s)
               for s in seeds]
    config = configs[0]
    set_random_seeds(seeds[0])
    train_ds, test_ds = get_dataloaders(config, seed=seeds[0], device=device)
    attention_config, mlp_config = model_options(
        model_name, args.mlp_type, 4 if args.num_experts is None else args.num_experts,
        args.num_features)
    models = []
    for seed, cfg in zip(seeds, configs):
        set_random_seeds(seed)
        models.append(create_model(model_name, cfg, attention_config=attention_config,
                                   mlp_config=mlp_config, device=device,
                                   **({"depth": args.depth} if args.depth else {})))
    S = len(seeds)
    state = create_ensemble_train_state(models, config, steps_per_epoch=len(train_ds),
                                        ema_decay=args.ema_decay or 0.0)
    n_params = count_parameters(models[0])
    ens_step = make_ensemble_gather_multi_step(
        models, label_smoothing=args.label_smoothing or 0.0, augment=train_ds.augment,
        per_member_order=True, device=device)
    ens_eval = make_ensemble_gather_multi_eval(state.eval_view(), device=device)
    member_rngs = [np.random.default_rng(s) for s in seeds]
    generators = [torch.Generator(device).manual_seed(s) for s in seeds]

    per_epoch = [[] for _ in range(S)]
    best_acc = [-1.0] * S
    t0 = time.perf_counter()
    for epoch in range(1, config.train.epochs + 1):
        state, tm = ensemble_train_epoch(state, ens_step, train_ds, generators, S,
                                         epoch=epoch, fused_steps=fused_steps,
                                         member_rngs=member_rngs, verbose=not args.quiet)
        state.eval_view()
        em = ensemble_evaluate(ens_eval, test_ds, S, fused_steps=fused_steps)
        for i in range(S):
            per_epoch[i].append({
                "epoch": epoch,
                "train_loss": tm["loss"][i],
                "train_accuracy": tm["accuracy"][i],
                "test_loss": em["loss"][i],
                "test_accuracy": em["accuracy"][i],
                "epoch_time": tm["time"],
            })
            best_acc[i] = max(best_acc[i], em["accuracy"][i])
    total_train_time = time.perf_counter() - t0

    # one inference chain over one serving model, each member's weights in turn
    bench_images, _ = next(iter(test_ds))
    server = create_model(model_name, config, attention_config=attention_config,
                          mlp_config=mlp_config, device=device,
                          **({"depth": args.depth} if args.depth else {}))
    chain_fn = make_inference_chain(server)
    runs = []
    for i, seed in enumerate(seeds):
        copy_module_(server, state.members[i].model)
        inference = benchmark_inference(server, bench_images, chain_fn=chain_fn)
        final = per_epoch[i][-1]
        metrics = {
            "metadata": {
                "model_name": model_name,
                "dataset": args.dataset,
                "attention_type": server.attention_type,
                "rpe_type": server.rpe_type,
                "seed": seed,
                "num_parameters": n_params["total"],
                "backend": device_name(device),
                "ensemble_size": S,
                **({"mlp_type": args.mlp_type, "num_experts": mlp_config["num_experts"]}
                   if args.mlp_type == "moe" else {}),
                "synthetic_data": bool(getattr(train_ds, "synthetic", False)),
                "config": {k: v for k, v in configs[i].to_dict().items()
                           if isinstance(v, (int, float, str, bool, tuple, list))},
            },
            "per_epoch": per_epoch[i],
            "aggregate": {
                "best_test_accuracy": best_acc[i],
                "final_test_accuracy": final["test_accuracy"],
                "final_test_loss": final["test_loss"],
                **compute_information_criteria(final["test_loss"], test_ds.num_samples,
                                               n_params["total"]),
                "final_train_accuracy": final["train_accuracy"],
                "final_train_loss": final["train_loss"],
                # the shared wall time in which all S members trained; the
                # stamp keeps a tool that sums train time over run
                # directories from counting it S times (each epoch_time too)
                "total_train_time": total_train_time,
                "time_is_shared_ensemble_wall": True,
            },
            "inference": inference,
        }
        save_run_metrics(_metrics_path(model_dir, i, seed, model_name, args.dataset), metrics)
        if not args.quiet:
            print(f"{model_name} seed {seed} [ensemble]: acc {final['test_accuracy']:.2f}% "
                  f"(best {best_acc[i]:.2f}%)")
        runs.append(metrics)
    return runs


MEASUREMENT_NOTE = (
    "train_time is host wall-clock seconds around the epochs (on the GPU: "
    "CUDA-graph replays of --fused-steps steps each, the first call of each "
    "chunk shape run eagerly and captured), evaluations included, so it "
    "moves with the host and the card's power limit and is indicative only; "
    "inference latency and throughput are timed with CUDA events around "
    "chains of data-dependent eager forwards, one host read per chain "
    "(train/training.py::benchmark_inference).")
ENSEMBLE_NOTE = (
    " Ensemble mode: train_time is the shared wall time in which all seeds "
    "trained together (every member's steps of a chunk in one CUDA graph on "
    "the GPU), so its spread across runs is zero by construction. Each "
    "member draws its own seed's data order, dropout and augmentation, as "
    "the sequential run of that seed does, so the accuracy spread is that "
    "of sequential multi-seed runs.")


def _aggregate_model(model, model_dir, runs, summary, args, write=True):
    """One model's runs -> aggregated_stats.json (when `write`) and its
    summary row."""
    from ..train import compute_aggregated_statistics, print_model_summary, save_run_metrics

    flat_runs = [{
        "test_accuracy": r["aggregate"]["final_test_accuracy"],
        "best_test_accuracy": r["aggregate"]["best_test_accuracy"],
        "test_loss": r["aggregate"]["final_test_loss"],
        "train_time": r["aggregate"]["total_train_time"],
        "throughput_images_per_sec": r["inference"]["throughput_images_per_sec"],
        "latency_mean_ms": r["inference"]["latency_mean_ms"],
    } for r in runs]
    agg = compute_aggregated_statistics(flat_runs)
    agg["measurement_note"] = MEASUREMENT_NOTE + (ENSEMBLE_NOTE if args.ensemble else "")
    if write:
        save_run_metrics(os.path.join(model_dir, "aggregated_stats.json"), agg)
    summary[model] = agg
    if not args.quiet:
        print_model_summary(model, agg)


def _refuse(args) -> None:
    """What the runner does not run: --ensemble with what its step does not
    compose with, and a mesh without its processes."""
    from .train import MICROBATCHES_NEED_PIPE, _mesh_axes

    if args.ensemble:
        for on, name in ((args.subprocess, "--subprocess"), (args.mesh, "--mesh"),
                         (args.grad_accum, "--grad-accum"), (args.remat, "--remat"),
                         (args.microbatches, "--microbatches")):
            if on:
                raise SystemExit(f"--ensemble does not compose with {name}: the ensemble "
                                 "step trains every member on one GPU, one plain step "
                                 "each")
    if args.microbatches and not args.mesh:
        raise SystemExit(MICROBATCHES_NEED_PIPE)
    explicit = args.distributed not in (None, "auto")
    for flag, value in (("--num-processes", args.num_processes),
                        ("--process-id", args.process_id)):
        if value is not None and not explicit:
            raise SystemExit(f"{flag} only applies to an explicit --distributed host:port")
    if not args.mesh:
        return
    if args.subprocess:
        raise SystemExit("--subprocess does not compose with --mesh: the ranks run every "
                         "seed in process on the process group the runner joined")
    need = 1
    for n in _mesh_axes(args).values():
        need *= n
    have = args.num_processes if explicit else (
        int(os.environ.get("WORLD_SIZE", "1")) if args.distributed else 1)
    if need != have:
        raise SystemExit(f"--mesh {args.mesh} needs {need} processes, the runner has {have}: "
                         f"start {need} ranks with --distributed (torchrun --nproc-per-node "
                         f"{need} ... --distributed)")


def main(argv=None):
    """Run the benchmark; returns {model: aggregated statistics}."""
    args = parse_args(argv)
    from ..models.factory import _resolve_variant
    from ..train import load_run_metrics, save_benchmark_config

    for m in args.models:
        # anything the factory builds: the named variants and the custom
        # "<attention>_<rpe>" compositions
        try:
            _resolve_variant(m)
        except ValueError as e:
            raise SystemExit(str(e))
    _refuse(args)
    joined = False
    if args.distributed is not None:
        from ..parallel import multihost
        from .train import _join

        joined = _join(args)  # quiets every rank but the coordinator
    coordinator = args.distributed is None or multihost.is_coordinator()
    say = print if coordinator else (lambda *a, **k: None)

    def existing(path):
        """--skip-existing's metrics of a run, the coordinator's on every rank."""
        if args.distributed is None:
            return load_run_metrics(path)
        return multihost.broadcast_scalar(load_run_metrics(path) if coordinator else None)

    seeds = args.seeds if args.seeds else [42 + 111 * i for i in range(args.num_runs)]
    if args.distributed is not None and not args.output_dir:  # one timestamp for all ranks
        args.output_dir = multihost.broadcast_scalar(
            setup_benchmark_directory(args) if coordinator else None)
    out_dir = setup_benchmark_directory(args)
    if coordinator:
        save_benchmark_config(out_dir, {
            "models": args.models, "dataset": args.dataset, "seeds": seeds,
            "epochs": args.epochs, "batch_size": args.batch_size,
            "augmentation": args.augmentation,
            "compute_dtype": args.compute_dtype,
            "mlp_type": args.mlp_type, "num_experts": args.num_experts,
            "num_features": args.num_features,
            "grad_accum": args.grad_accum, "ema_decay": args.ema_decay,
            "fused_steps": args.fused_steps,
            "label_smoothing": args.label_smoothing, "remat": args.remat,
            "mesh": args.mesh, "depth": args.depth,
            "microbatches": args.microbatches,
            "ensemble": args.ensemble,
            "timestamp": datetime.now().isoformat(),
        })
    say(f"Benchmark -> {out_dir} (models={args.models}, seeds={seeds})")

    summary = {}
    for model in args.models:
        model_dir = os.path.join(out_dir, model)
        paths = [_metrics_path(model_dir, i, s, model, args.dataset)
                 for i, s in enumerate(seeds)]
        runs = []
        if args.ensemble:
            # all seeds train together, so --skip-existing is all or nothing
            kept = [existing(p) for p in paths] if args.skip_existing else [None]
            if all(e is not None for e in kept):
                say(f"[skip-existing] {model} (ensemble, all seeds)")
                runs = kept
            else:
                t0 = time.perf_counter()
                try:
                    runs = run_ensemble_benchmark(model, seeds, model_dir, args)
                except Exception as e:  # one model's failure does not stop the others
                    say(f"[ERROR] {model} ensemble: {e}")
                    if args.distributed is not None:
                        raise
                    continue
                say(f"{model} ensemble x{len(seeds)}: "
                      f"{time.perf_counter() - t0:.0f}s total")
            _aggregate_model(model, model_dir, runs, summary, args, coordinator)
            continue
        shared = {}  # one model's datasets, state and graphs, across its seeds
        for run_idx, (seed, path) in enumerate(zip(seeds, paths)):
            if args.skip_existing:
                kept = existing(path)
                if kept is not None:
                    say(f"[skip-existing] {model} seed {seed}")
                    runs.append(kept)
                    continue
            t0 = time.perf_counter()
            try:
                metrics = run_single_training(model, seed, os.path.dirname(path), args,
                                              shared=shared)
            except Exception as e:  # one run's failure does not stop the others
                say(f"[ERROR] {model} seed {seed}: {e}")
                if args.distributed is not None:  # unless the ranks run it together
                    raise
                continue
            say(f"{model} seed {seed}: "
                  f"acc {metrics['aggregate']['final_test_accuracy']:.2f}% "
                  f"({time.perf_counter() - t0:.0f}s)")
            runs.append(metrics)
        _aggregate_model(model, model_dir, runs, summary, args, coordinator)

    say("\n===== SUMMARY =====")
    header = f"{'model':<36} {'test acc':<16} {'img/s':<12} {'train s':<10}"
    say(header)
    say("-" * len(header))
    for model, agg in summary.items():
        acc = agg.get("test_accuracy") or {}
        thr = agg.get("throughput_images_per_sec") or {}
        tt = agg.get("train_time") or {}
        say(f"{model:<36} "
              f"{acc.get('mean', float('nan')):6.2f}±{acc.get('std', 0):<7.2f} "
              f"{thr.get('mean', float('nan')):<12.1f} "
              f"{tt.get('mean', float('nan')):<10.1f}")
    if joined:
        import torch.distributed as dist

        dist.destroy_process_group()
    return summary


if __name__ == "__main__":
    main()
