#!/usr/bin/env python
"""Single-run training CLI of the port.

Counterpart of `experiments/train.py` (the JAX package's CLI), with its
flags, names and defaults: train any variant on MNIST / CIFAR-10 (or
their flagged synthetic stand-ins when the files are absent), evaluate
every epoch, keep the best checkpoint, benchmark inference on the first
test batch and write `<model>_<dataset>_metrics.json` with the JAX CLI's
key tree (`metadata`, `per_epoch`, `aggregate`, `inference`).

    python -m efficient_rpe_vit_torch.experiments.train \\
        --model performer_favor_most_general --dataset mnist --epochs 3

The run takes the GPU unless `--cpu` is given; with no card and no
`--cpu` it stops with the device error. `--fused-steps K` runs K train
steps per call, one CUDA graph replay on the GPU.

Sharded training runs one process per rank, joined by `--distributed`
(bare: torchrun's environment; or `host:port` with `--num-processes` and
`--process-id`), over a `--mesh` of 'data', 'model', 'seq', 'expert' and
'pipe' axes (`efficient_rpe_vit_torch.parallel`):

    torchrun --nproc-per-node 4 -m efficient_rpe_vit_torch.experiments.train \
        --mesh data=2,pipe=2 --depth 4 --microbatches 4 --distributed

Each data rank trains on its rows of every batch, evaluation sums the
ranks' counts, and only the coordinator prints, writes the metrics and
saves checkpoints. A 'pipe' axis trains through the GPipe step
(`parallel/pipeline.py`; `--microbatches` M, default the pipe size): each
pipe rank holds depth / pipe blocks, and evaluation and the inference
benchmark run through the pipeline too. `--checkpoint-backend orbax`
saves the best checkpoint as a sharded directory,
`<model>_<dataset>_best_orbax` (`train.checkpoint.save_checkpoint_sharded`,
on `torch.distributed.checkpoint`): under a mesh every rank writes its own
parts. `--resume auto` finds the backend's checkpoint, and `--resume DIR`
on a directory takes the sharded loader.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from ..utils import tracing


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a ViT variant (PyTorch port)")
    p.add_argument("--model", type=str, default="baseline",
                   help="model variant name (see list_available_models)")
    p.add_argument("--dataset", type=str, default="mnist",
                   choices=["mnist", "cifar10"])
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", "--learning-rate", dest="learning_rate",
                   type=float, default=None)
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument("--optimizer", type=str, default=None,
                   choices=["adam", "adamw", "sgd"])
    p.add_argument("--scheduler", type=str, default=None,
                   choices=["cosine", "warmup_cosine", "step", "constant"])
    p.add_argument("--warmup-epochs", type=int, default=None)
    p.add_argument("--augmentation", action="store_true", default=None)
    p.add_argument("--num-workers", type=int, default=0,
                   help="accepted for CLI compatibility; the device-resident "
                        "pipeline has no loader workers")
    p.add_argument("--visualize", action="store_true",
                   help="save a sample-batch grid PNG before training "
                        "(needs matplotlib)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (tests, debugging); the default is "
                        "the GPU")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save-model", action="store_true")
    p.add_argument("--save-metrics", action="store_true", default=True)
    p.add_argument("--save-plots", "--plot", dest="save_plots",
                   action="store_true", help="loss / accuracy curves PNG "
                                             "(needs matplotlib)")
    p.add_argument("--output-dir", type=str, default="results")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path to resume from, or 'auto' to "
                        "resume from this run's own best checkpoint when "
                        "one exists (a preempted run is re-invoked with "
                        "identical flags)")
    p.add_argument("--log-interval", type=float, default=0.02,
                   help="progress print interval as a fraction of batches")
    p.add_argument("--eval-detailed", action="store_true",
                   help="compute precision/recall/F1 at final eval")
    p.add_argument("--bench-warmup", type=int, default=10)
    p.add_argument("--bench-iters", type=int, default=100)
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="trace the first epoch with torch.profiler into DIR "
                        "(a Chrome trace and a table of operator times), with "
                        "the train step's rpe.* spans (utils/tracing.py)")
    p.add_argument("--compute-dtype", type=str, default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--checkpoint-backend", default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="msgpack: the single-file checkpoint (a torch.save "
                        "file here; under a mesh gathered and written by the "
                        "coordinator); orbax: a sharded directory of "
                        "torch.distributed.checkpoint files in which each "
                        "rank writes its own parts, restored on any layout "
                        "without a gather")
    p.add_argument("--label-smoothing", type=float, default=0.0,
                   metavar="S", help="uniform label smoothing on the "
                                     "training loss (eval stays unsmoothed)")
    p.add_argument("--ema-decay", type=float, default=0.0, metavar="D",
                   help="track an EMA shadow of the params (e.g. 0.999) "
                        "and evaluate/checkpoint with it")
    p.add_argument("--grad-accum", type=int, default=1, metavar="A",
                   help="split each batch into A microbatches inside one "
                        "step (gradients are exactly the full-batch mean)")
    p.add_argument("--fused-steps", type=int, default=1, metavar="K",
                   help="run the epoch in K-step chunks, one call each (one "
                        "CUDA graph replay on the GPU)")
    p.add_argument("--depth", type=int, default=None,
                   help="override the config's transformer depth")
    p.add_argument("--microbatches", type=int, default=None, metavar="M",
                   help="GPipe microbatch count for a --mesh 'pipe' axis "
                        "(default: the pipe size)")
    p.add_argument("--remat", action="store_true",
                   help="activation checkpointing: recompute each block's "
                        "activations in the backward")
    p.add_argument("--num-features", type=str, default=None, metavar="M",
                   help="random-feature count for kernel attention "
                        "(FAVOR+/ReLU/hyperbolic): an integer, or 'mxu' for "
                        "the nearest multiple of 128 "
                        "(ops/feature_maps.py::mxu_num_features)")
    p.add_argument("--mlp-type", type=str, default=None,
                   choices=["dense", "moe"],
                   help="block MLP: dense (reference) or soft mixture of "
                        "experts (models/layers.py::MoeMlp)")
    p.add_argument("--num-experts", type=int, default=4,
                   help="expert count for --mlp-type moe")
    p.add_argument("--mesh", type=str, default=None, metavar="AXES",
                   help="mesh of the run's processes for sharded training, e.g. "
                        "'data=2' (DP), 'data=2,model=2' (DP x TP), 'data=2,seq=2' "
                        "(DP x CP: sequence split inside attention), 'expert=2' "
                        "(with --mlp-type moe), 'data=2,pipe=2' (DP x PP: GPipe "
                        "over the blocks); needs --distributed and as many "
                        "processes as the sizes' product")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--distributed", nargs="?", const="auto", default=None,
                   metavar="COORD",
                   help="join a multi-process run before anything else: bare, "
                        "from torchrun's environment (RANK, WORLD_SIZE, "
                        "MASTER_ADDR, MASTER_PORT); or host:port with "
                        "--num-processes and --process-id")
    p.add_argument("--num-processes", type=int, default=None,
                   help="process count for an explicit --distributed COORD")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank for an explicit --distributed COORD")
    return p.parse_args(argv)


def _refuse(args) -> None:
    """The flags the port refuses, before anything runs."""
    explicit = args.distributed not in (None, "auto")
    for flag, value in (("--num-processes", args.num_processes),
                        ("--process-id", args.process_id)):
        if value is not None and not explicit:
            raise SystemExit(f"{flag} only applies to an explicit --distributed "
                             "host:port (bare --distributed reads torchrun's "
                             "environment)")
    if args.mesh and args.fused_steps > 1:
        raise SystemExit(
            "--fused-steps composes with the plain single-chip step only "
            "(not --mesh or --grad-accum); the sharded / accumulated steps "
            "have their own structure")


MICROBATCHES_NEED_PIPE = ("--microbatches only applies to a --mesh with a 'pipe' axis "
                          "(use --grad-accum for non-pipelined microbatching)")


def _refuse_pipe(args, axes, config) -> None:
    """The JAX CLI's refusals of `--microbatches` without a 'pipe' axis and
    of what a 'pipe' axis does not run, from the mesh spec's `axes` and the
    config alone."""
    if "pipe" not in axes:
        if args.microbatches:
            raise SystemExit(MICROBATCHES_NEED_PIPE)
        return
    if args.grad_accum > 1 or args.label_smoothing > 0:
        raise SystemExit("--mesh with a 'pipe' axis does not compose with --grad-accum "
                         "or --label-smoothing (the GPipe step schedules its own "
                         "microbatches)")
    n_pipe, depth = axes["pipe"], args.depth or config.model.depth
    if depth % n_pipe:
        raise SystemExit(f"model depth {depth} not divisible by pipe={n_pipe} stages")
    n_micro = args.microbatches or n_pipe
    if config.train.batch_size % n_micro:
        raise SystemExit(f"batch size {config.train.batch_size} not divisible by the "
                         f"{n_micro}-microbatch GPipe schedule")


def _join(args) -> bool:
    """`--distributed`: join the process group; True when this call made
    it. The coordinator alone keeps its voice."""
    from ..parallel import multihost

    if args.distributed is None:
        return False
    made = not torch.distributed.is_initialized()
    try:
        multihost.initialize(None if args.distributed == "auto" else args.distributed,
                             args.num_processes, args.process_id,
                             backend="gloo" if args.cpu else None)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"--distributed: {e}") from None
    if not multihost.is_coordinator():
        args.quiet = True
    return made


def _mesh_axes(args):
    from ..parallel.mesh import parse_mesh_spec

    try:
        return parse_mesh_spec(args.mesh)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}") from None


def _build_mesh(args, device: torch.device):
    """--mesh over the run's processes, or a refusal."""
    from ..parallel import Mesh

    axes = _mesh_axes(args)
    need = 1
    for n in axes.values():
        need *= n
    have = (torch.distributed.get_world_size() if torch.distributed.is_initialized()
            else 1)
    if not torch.distributed.is_initialized() or need != have:
        raise SystemExit(
            f"--mesh {args.mesh} needs {need} processes in a process group, have "
            f"{have} (launch with torchrun --nproc-per-node {need} ... --distributed, "
            f"or --distributed host:port --num-processes {need} --process-id R)")
    return Mesh(axes, device)


def device_name(device: torch.device) -> str:
    """The name a metrics file records as its backend."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def model_options(model: str, mlp_type=None, num_experts=4, num_features=None):
    """(attention_config, mlp_config) for `create_model` from the CLI's
    --mlp-type, --num-experts and --num-features."""
    mlp_config = None
    if mlp_type == "moe":
        mlp_config = {"mlp_type": "moe", "num_experts": num_experts}
    attention_config = None
    if num_features is not None:
        from ..models import MODEL_VARIANTS

        if MODEL_VARIANTS.get(model, ("", None))[0] == "softmax":
            raise SystemExit(
                "--num-features only applies to kernel attention variants "
                "(FAVOR+/ReLU); softmax attention has no random features")
        nf = num_features if num_features == "mxu" else int(num_features)
        attention_config = {"num_features": nf}
    return attention_config, mlp_config


# flags that do not change what a run builds, only what it is told or writes
_PER_RUN_FLAGS = ("seed", "output_dir", "resume")


def main(argv=None, shared=None):
    """Run one training job; returns the metrics dict it writes.

    `shared`: a dict that an in-process caller (experiments/benchmark.py)
    passes to every seed of one model. The first run keeps in it its
    datasets, train state (model and optimiser) and steps, and with them
    the CUDA graphs captured for that state; a later run whose flags differ
    only in --seed, --output-dir or --resume builds its model afresh from
    its seed and copies it into the kept one, zeroes the optimiser state in
    place (`reset_train_state`) and restarts the datasets' streams from its
    seed (`DeviceDataset.reseed`; the data is the same for every seed), so
    it computes what a run without `shared` computes, replaying the graphs
    the first run captured. Other flags start the dict afresh.
    """
    args = parse_args(argv)
    _refuse(args)
    joined = _join(args)
    signature = {k: v for k, v in vars(args).items() if k not in _PER_RUN_FLAGS}
    reuse = shared is not None and shared.get("signature") == signature
    if shared is not None and not reuse:
        shared.clear()

    from ..configs import get_dataset_config
    from ..data import get_dataloaders
    from ..models import MODEL_VARIANTS, count_parameters, create_model, get_model_info
    from ..train import (
        benchmark_inference,
        create_train_state,
        evaluate,
        load_checkpoint,
        load_checkpoint_sharded,
        make_eval_step,
        make_gather_multi_eval,
        make_gather_multi_step,
        make_inference_chain,
        make_multi_step,
        make_train_step,
        reset_train_state,
        save_checkpoint,
        save_checkpoint_sharded,
        save_run_metrics,
        set_random_seeds,
        train_epoch,
    )
    from ..train.metrics import compute_information_criteria
    from ..utils.device import resolve_device

    config = get_dataset_config(
        args.dataset,
        batch_size=args.batch_size,
        epochs=args.epochs,
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        dropout=args.dropout,
        optimizer=args.optimizer,
        scheduler=args.scheduler,
        warmup_epochs=args.warmup_epochs,
        augmentation=args.augmentation,
        seed=args.seed,
        compute_dtype=args.compute_dtype,
    )
    _refuse_pipe(args, _mesh_axes(args) if args.mesh else {}, config)
    if args.distributed is not None:
        from ..parallel.multihost import local_device

        device = local_device(args.cpu)
    else:
        device = resolve_device("cpu" if args.cpu else None)
    mesh = _build_mesh(args, device) if args.mesh else None
    pipe = mesh is not None and "pipe" in mesh
    n_micro = (args.microbatches or mesh.size("pipe")) if pipe else None
    set_random_seeds(args.seed)
    info = (get_model_info(args.model) if args.model in MODEL_VARIANTS
            else {"name": args.model})
    if not args.quiet:
        print(f"Model: {args.model} {info}")
        print(f"Device: {device} ({device_name(device)})")

    if reuse:
        train_ds, test_ds = shared["data"]
        train_ds.reseed(args.seed)
    else:
        train_ds, test_ds = get_dataloaders(config, seed=args.seed, device=device)
    if not args.quiet:
        print(f"Data: {train_ds.num_samples} train / {test_ds.num_samples} test"
              f"{' (synthetic)' if train_ds.synthetic else ''}")
    if args.visualize:
        from ..data import visualize_batch

        os.makedirs(args.output_dir, exist_ok=True)
        imgs, labs = next(iter(train_ds))
        path = visualize_batch(
            imgs, labs,
            os.path.join(args.output_dir, f"{args.dataset}_sample_batch.png"))
        if not args.quiet:
            print(f"Sample batch written to {path}")

    attention_config, mlp_config = model_options(args.model, args.mlp_type,
                                                 args.num_experts, args.num_features)
    if mesh is not None and "seq" in mesh:
        attention_config = dict(attention_config or {}, seq_mesh=mesh, seq_axis="seq")
    if mesh is not None and "expert" in mesh:
        if mlp_config is None:
            raise SystemExit("--mesh with an 'expert' axis requires --mlp-type moe")
        mlp_config.update(expert_mesh=mesh, expert_axis="expert")
    if args.fused_steps > 1 and args.grad_accum > 1:
        raise SystemExit(
            "--fused-steps composes with the plain single-chip step only "
            "(not --grad-accum); the accumulated step has its own structure")

    model = create_model(args.model, config, attention_config=attention_config,
                         mlp_config=mlp_config, remat=args.remat, device=device,
                         **({"depth": args.depth} if args.depth else {}))
    if reuse:  # this seed's weights into the kept model, its state zeroed
        state = reset_train_state(shared["state"], model)
        model = state.model
    elif mesh is not None:
        from ..parallel import create_pipeline_train_state, create_sharded_train_state
        from ..parallel.train_parallel import parameter_count

        make_state = create_pipeline_train_state if pipe else create_sharded_train_state
        state = make_state(model, config, mesh, steps_per_epoch=len(train_ds),
                           ema_decay=args.ema_decay)
    else:
        state = create_train_state(model, config, steps_per_epoch=len(train_ds),
                                   ema_decay=args.ema_decay)
    n_params = count_parameters(model) if mesh is None else parameter_count(state)
    if not args.quiet:
        print(f"Parameters: {n_params['total']:,}")

    start_epoch = 1
    sharded = args.checkpoint_backend == "orbax"
    ckpt_path = os.path.join(args.output_dir, f"{args.model}_{args.dataset}_best"
                             + ("_orbax" if sharded else ".pt"))
    save_ckpt = save_checkpoint_sharded if sharded else save_checkpoint
    if args.resume == "auto":
        args.resume = ckpt_path if os.path.exists(ckpt_path) else None
        if args.resume is None and not args.quiet:
            print("[resume auto] no checkpoint found; starting fresh")
    if args.resume:
        # sharded checkpoints are directories
        load = load_checkpoint_sharded if os.path.isdir(args.resume) else load_checkpoint
        state, meta = load(args.resume, state)
        start_epoch = int(meta.get("epoch", 0)) + 1
        if not args.quiet:
            print(f"Resumed from {args.resume} at epoch {start_epoch}")

    if reuse:
        train_step, eval_step, multi_step, gather_step, gather_eval = shared["steps"]
    elif pipe:
        from ..parallel import make_pipeline_eval_step, make_pipeline_train_step

        train_step = make_pipeline_train_step(model, mesh, state, n_microbatches=n_micro)
        eval_step = make_pipeline_eval_step(state.eval_view(), mesh, n_micro)
        multi_step = gather_step = gather_eval = None
    elif mesh is not None:
        from ..parallel import make_parallel_eval_step, make_parallel_train_step

        train_step = make_parallel_train_step(model, mesh, state,
                                              label_smoothing=args.label_smoothing,
                                              grad_accum=args.grad_accum)
        eval_step = make_parallel_eval_step(state.eval_view(), mesh)
        multi_step = gather_step = gather_eval = None
    else:
        train_step = make_train_step(model, grad_accum=args.grad_accum,
                                     label_smoothing=args.label_smoothing, device=device)
        eval_model = state.eval_view()  # the EMA copy (refreshed in place) or the model
        eval_step = make_eval_step(eval_model, device=device)
        multi_step = gather_step = gather_eval = None
        if args.fused_steps > 1:
            multi_step = make_multi_step(model, label_smoothing=args.label_smoothing,
                                         device=device)
            gather_step = make_gather_multi_step(model, label_smoothing=args.label_smoothing,
                                                 augment=train_ds.augment, device=device)
            gather_eval = make_gather_multi_eval(eval_model, device=device)
        if shared is not None:
            shared.update(signature=signature, data=(train_ds, test_ds), state=state,
                          steps=(train_step, eval_step, multi_step, gather_step, gather_eval))

    os.makedirs(args.output_dir, exist_ok=True)
    generator = torch.Generator(device).manual_seed(args.seed)
    per_epoch = []
    best_acc = -1.0
    t_train0 = time.perf_counter()
    for epoch in range(start_epoch, config.train.epochs + 1):
        profiling = bool(args.profile) and epoch == start_epoch
        tracing.enable(profiling)
        try:
            with _profiler(device) if profiling else contextlib.nullcontext() as profiler:
                if mesh is not None:
                    from ..parallel import parallel_train_epoch

                    state, tm = parallel_train_epoch(
                        state, train_step, train_ds, generator, mesh, epoch=epoch,
                        log_interval_frac=args.log_interval, verbose=not args.quiet)
                else:
                    state, tm = train_epoch(
                        state, train_step, train_ds, generator, epoch=epoch,
                        log_interval_frac=args.log_interval, verbose=not args.quiet,
                        multi_step=multi_step, gather_step=gather_step,
                        fused_steps=args.fused_steps)
                if profiling and device.type == "cuda":
                    torch.cuda.synchronize(device)
        finally:
            tracing.enable(False)
            tracing.clear()
        if profiling:
            _write_profile(profiler, args.profile, device, args.quiet)
        state.eval_view()
        em = evaluate(eval_step, test_ds, gather_eval=gather_eval,
                      fused_steps=args.fused_steps)
        per_epoch.append({
            "epoch": epoch,
            "train_loss": tm["loss"],
            "train_accuracy": tm["accuracy"],
            "test_loss": em["loss"],
            "test_accuracy": em["accuracy"],
            "epoch_time": tm["time"],
        })
        if not args.quiet:
            print(f"epoch {epoch}: train {tm['accuracy']:.2f}% "
                  f"test {em['accuracy']:.2f}% ({tm['time']:.1f}s)")
        if em["accuracy"] > best_acc:
            best_acc = em["accuracy"]
            if args.save_model:  # under a mesh every rank takes part
                save_ckpt(
                    ckpt_path, state, epoch,
                    metrics={"test_accuracy": em["accuracy"]},
                    metadata={"model_name": args.model,
                              "dataset": args.dataset,
                              "attention_type": model.attention_type,
                              "rpe_type": model.rpe_type,
                              # what a consumer (predict, a resume elsewhere)
                              # needs to rebuild the same module: the MoE
                              # shape, the feature count, the depth, the EMA
                              # template and the compute dtype
                              "mlp_type": args.mlp_type,
                              "num_experts": (args.num_experts
                                              if args.mlp_type == "moe" else None),
                              "num_features": args.num_features,
                              "depth": args.depth,
                              "ema_decay": args.ema_decay,
                              "compute_dtype": config.train.compute_dtype})
    total_train_time = time.perf_counter() - t_train0

    if args.eval_detailed or not per_epoch:
        state.eval_view()
        final_eval = evaluate(eval_step, test_ds, num_classes=config.model.num_classes,
                              detailed=args.eval_detailed, gather_eval=gather_eval,
                              fused_steps=args.fused_steps)
    else:
        # the epoch loop's last evaluation is the final one
        final_eval = {"accuracy": per_epoch[-1]["test_accuracy"],
                      "loss": per_epoch[-1]["test_loss"],
                      "samples": test_ds.num_samples}

    bench_images, _ = next(iter(test_ds))
    # on a mesh the ranks' forwards meet in collectives, so every rank runs
    # chains of one fixed length (no length search by each rank's clock)
    if pipe:
        from ..parallel.pipeline import make_pipeline_inference_chain

        chain = make_pipeline_inference_chain(model, mesh, n_micro)
    else:
        chain = make_inference_chain(model)
    inference = benchmark_inference(
        model, bench_images, num_warmup=args.bench_warmup,
        num_iterations=args.bench_iters, chain_fn=chain,
        target_chain_time=0 if mesh is not None else None)
    if not args.quiet:
        print(f"Inference: {inference['throughput_images_per_sec']:.1f} img/s, "
              f"{inference['latency_mean_ms']:.2f} ms/batch")

    metrics = {
        "metadata": {
            "model_name": args.model,
            "dataset": args.dataset,
            "attention_type": model.attention_type,
            "rpe_type": model.rpe_type,
            "seed": args.seed,
            "num_parameters": n_params["total"],
            "backend": device_name(device),
            **({"mesh": args.mesh} if args.mesh else {}),
            **({"mlp_type": args.mlp_type, "num_experts": args.num_experts}
               if args.mlp_type == "moe" else {}),
            "synthetic_data": bool(getattr(train_ds, "synthetic", False)),
            "config": {k: v for k, v in config.to_dict().items()
                       if isinstance(v, (int, float, str, bool, tuple, list))},
        },
        "per_epoch": per_epoch,
        "aggregate": {
            "best_test_accuracy": best_acc,
            "final_test_accuracy": final_eval["accuracy"],
            "final_test_loss": final_eval["loss"],
            **compute_information_criteria(
                final_eval["loss"], final_eval["samples"], n_params["total"]),
            "final_train_accuracy": per_epoch[-1]["train_accuracy"] if per_epoch else None,
            "final_train_loss": per_epoch[-1]["train_loss"] if per_epoch else None,
            "total_train_time": total_train_time,
            **({k: final_eval[k] for k in
                ("precision_weighted", "recall_weighted", "f1_weighted", "f1_macro")
                if k in final_eval}),
        },
        "inference": inference,
    }
    coordinator = not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0
    if args.save_metrics and coordinator:
        path = os.path.join(args.output_dir, f"{args.model}_{args.dataset}_metrics.json")
        save_run_metrics(path, metrics)
        if not args.quiet:
            print(f"Metrics written to {path}")
    if args.save_plots and per_epoch and coordinator:
        _save_plots(per_epoch, args)
    if joined:
        torch.distributed.destroy_process_group()
    return metrics


def _profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _write_profile(profiler, out_dir: str, device: torch.device, quiet: bool) -> None:
    """The first epoch's trace: a Chrome trace and a table of operator
    times sorted by device (else host) time, then one of the train step's
    spans and marker kernels (`utils/tracing.py`)."""
    from torch.autograd.profiler_util import EventList

    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, "trace.json")
    profiler.export_chrome_trace(trace)
    sort = "self_cuda_time_total" if device.type == "cuda" else "self_cpu_time_total"
    table = os.path.join(out_dir, "key_averages.txt")
    averages = profiler.key_averages()
    spans = EventList([e for e in averages
                       if e.key.startswith((tracing.PREFIX, "rpe_mark_"))])
    with open(table, "w") as f:
        f.write(averages.table(sort_by=sort, row_limit=40))
        if spans:
            f.write("\n" + spans.table(sort_by=sort, row_limit=-1))
    if not quiet:
        print(f"Profiler trace written to {trace} and {table}")


def _save_plots(per_epoch, args) -> None:
    """Loss / accuracy curves PNG."""
    from ..data.datasets import _pyplot

    plt = _pyplot()
    epochs = [e["epoch"] for e in per_epoch]
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    axes[0].plot(epochs, [e["train_loss"] for e in per_epoch], label="train")
    axes[0].plot(epochs, [e["test_loss"] for e in per_epoch], label="test")
    axes[0].set_title("Loss")
    axes[0].set_xlabel("epoch")
    axes[0].legend()
    axes[1].plot(epochs, [e["train_accuracy"] for e in per_epoch], label="train")
    axes[1].plot(epochs, [e["test_accuracy"] for e in per_epoch], label="test")
    axes[1].set_title("Accuracy (%)")
    axes[1].set_xlabel("epoch")
    axes[1].legend()
    fig.suptitle(f"{args.model} on {args.dataset}")
    out = os.path.join(args.output_dir, f"{args.model}_{args.dataset}_curves.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    if not args.quiet:
        print(f"Curves written to {out}")


if __name__ == "__main__":
    main()
