"""Training traffic: the port's train CLI path, K steps per CUDA graph.

The system under test is `train/training.py::make_gather_multi_step` over
uint8 images held on the card, the call `_train_epoch_gather_fused` makes
per [K, B] chunk of an epoch's order; the harness makes that call chunk by
chunk so that the window can end between replays (an epoch of the long
mix outlasts it).

Set-up: the port's kernels built (`ops/kernels/_build.py`, into the fixed
`build/` of the checkout: only a checkout's first run compiles), the model
built by the family and given the benchmark's weights by
name, the train state, the held images and labels drawn on the card, then
the first call on the first chunk (K eager steps, then the capture) and one
warm replay of that chunk from the same starting state, which must equal
the eager steps bit for bit. The window replays the graph over the next
chunks, epoch after epoch, until `--seconds` have passed, keeping one call
queued ahead of the host, and ends at a host read that waits for the last
update. After it, with the program freed, the plain reference follows the
first call's first three steps from the same weights and batches.

The model is the configuration's family's (`spec.family`): the program's
from `families/<family>.py`, its leaves, plain reference and step FLOPs
from `reference/` and `counts/<family>.py`.
"""

from __future__ import annotations

import gc
import sys
import time
from collections import deque

import torch

from .. import check, spec
from ..reference import train as reference
from ..trace import Tracer, reduce_events
from ..weights import chunks, make_images, make_weights, sub_seed

CHECKED_STEPS = 3


class Probe:
    """Readings of the program's own state during its first call's eager
    steps, from optimiser step hooks: after step 1 each leaf's gradient
    norm, worked out from AdamW's first moment (exp_avg = (1 - beta1) g),
    and after step CHECKED_STEPS each leaf's change from its start."""

    def __init__(self, model, optimizer, theta0):
        self.named = list(model.named_parameters())
        self.beta1 = optimizer.param_groups[0]["betas"][0]
        self.theta0 = theta0
        self.count = 0
        self.grad = self.delta = None
        self.handle = optimizer.register_step_post_hook(self._after)

    def _after(self, optimizer, args, kwargs):
        self.count += 1
        if self.count == 1:
            self.grad = torch.stack([optimizer.state[p]["exp_avg"].norm()
                                     for _, p in self.named]) / (1.0 - self.beta1)
        if self.count == CHECKED_STEPS:
            self.delta = [float((p.detach().to("cpu", torch.float32) - self.theta0[n]).norm())
                          for n, p in self.named]

    def remove(self):
        if self.handle is not None:
            self.handle.remove()
            self.handle = None

    def readings(self, losses) -> dict:
        names = [n for n, _ in self.named]
        return {"losses": [float(x) for x in losses[:CHECKED_STEPS]],
                "grad_norms": dict(zip(names, self.grad.tolist())),
                "delta_norms": dict(zip(names, self.delta))}


def _steps_per_epoch(mix: dict) -> int:
    return mix["held_images"] // (mix["batch"] * mix["fused_steps"]) * mix["fused_steps"]


@torch.no_grad()
def _load(model, weights) -> None:
    """The benchmark's weights into the model, by name; the two name sets
    must be equal."""
    ours = dict(model.named_parameters())
    ours.update(model.named_buffers())
    if sorted(ours) != sorted(weights):
        extra, missing = sorted(set(ours) - set(weights)), sorted(set(weights) - set(ours))
        raise ValueError(f"the model's leaves differ from the benchmark's: the model also "
                         f"has {extra[:5]}, lacks {missing[:5]}")
    for name, t in ours.items():
        t.copy_(weights[name])


@torch.no_grad()
def _restart(state, theta0, generator, generator_state) -> None:
    """The state as set-up made it: the weights back, AdamW's moments and
    step counts zero, no update counted, the generator where it was."""
    for name, p in state.model.named_parameters():
        p.copy_(theta0[name])
    for per_param in state.optimizer.state.values():
        for value in per_param.values():
            if isinstance(value, torch.Tensor):
                value.zero_()
    state.step = 0
    generator.set_state(generator_state)


def _host_params(model):
    return {n: p.detach().to("cpu", torch.float32, copy=True)
            for n, p in model.named_parameters()}


def _max_gap(a, b) -> float:
    return max(float((a[n] - b[n]).abs().max()) for n in a)


class Stages:
    """Set-up's parts on the host clock, logged to standard error as they
    end."""

    def __init__(self, clock_start: float):
        self.last = self.start = clock_start
        self.parts = {}

    def __call__(self, part: str) -> None:
        now = time.perf_counter()
        self.parts[part] = now - self.last
        self.last = now
        print(f"[perfbench {now - self.start:7.1f}s] set-up: {part} {self.parts[part]:.3f} s",
              file=sys.stderr, flush=True)


def run(cell, seed: int, seconds: float, trace: bool, clock_start: float,
        device: torch.device, peak: dict) -> dict:
    """One run of a training cell: {"attempted" (steps in the window),
    "failed" (of them, steps with a loss that is not finite), "metrics"
    (end-to-end, or per-layer when traced), "memory_peak_bytes", "trace",
    "numbers" and "limits" (the check's), "correct", "setup_s",
    "window_s"}."""
    stage = Stages(clock_start)
    from efficient_rpe_vit_torch.ops.kernels import _build
    from efficient_rpe_vit_torch.train import create_train_state, make_gather_multi_step

    config, mix = cell.config, cell.mix
    family = spec.family(config)
    k, batch = mix["fused_steps"], mix["batch"]
    if k < CHECKED_STEPS:
        raise ValueError(f"the first call must hold the {CHECKED_STEPS} checked steps, K = {k}")
    on_card = device.type == "cuda"
    stage("imports and the card")
    if on_card:
        _build.build()  # every source at once; a no-op once the checkout has them
    stage("kernel build")
    model, exp = family.program.build(config, mix, device, torch.Generator().manual_seed(0))
    stage("model")
    weights = make_weights(family.reference.parameter_spec(config, mix), seed, device)
    _load(model, weights)
    theta0 = {n: t.to("cpu", copy=True) for n, t in weights.items()}
    del weights
    stage("weights")
    state = create_train_state(model, exp, steps_per_epoch=_steps_per_epoch(mix))
    step = make_gather_multi_step(model, label_smoothing=config["label_smoothing"],
                                  augment=None, device=device)
    images, labels = make_images(mix["held_images"], mix["image_size"], config["in_channels"],
                                 config["num_classes"], seed, device)
    mean = torch.tensor(config["mean"], dtype=torch.float32, device=device)
    std = torch.tensor(config["std"], dtype=torch.float32, device=device)
    generator = torch.Generator(device).manual_seed(sub_seed(seed, "steps"))
    order = chunks(mix["held_images"], batch, k, seed)
    data = (images, labels, mean, std)
    stage("train state and held images")

    first = next(order)
    start = generator.get_state()
    probe = Probe(model, state.optimizer, theta0)

    def eager_done():
        probe.remove()
        if on_card:
            torch.cuda.synchronize(device)
        stage(f"first call: {k} eager steps")

    step.replays.before_capture = eager_done
    state, eager_losses, _ = step(state, *data, first, generator)
    probe.remove()  # on the CPU nothing is captured
    stage("first call: capture" if on_card else f"first call: {k} steps")
    eager_losses = eager_losses.to("cpu")
    eager = _host_params(model)
    program = probe.readings(eager_losses)
    _restart(state, theta0, generator, start)
    state, replay_losses, _ = step(state, *data, first, generator)
    replay_gap = max(float((replay_losses.to("cpu") - eager_losses).abs().max()),
                     _max_gap(_host_params(model), eager))
    del eager
    stage("warm replay from the same state, compared")

    # the window's own bookkeeping, run once here so that no kernel of it
    # loads inside the window
    bad = torch.zeros((), dtype=torch.int64, device=device)
    bad += (~torch.isfinite(replay_losses)).sum()
    attempted = 0
    pending = deque()
    with Tracer(trace) as tracer:
        if on_card:
            torch.cuda.synchronize(device)
        with tracer.span("window"):
            t0 = time.perf_counter()
            while True:
                with tracer.span("call"):
                    state, losses, _ = step(state, *data, next(order), generator)
                bad += (~torch.isfinite(losses)).sum()
                attempted += k
                if on_card:  # one call queued ahead of the host, no more
                    pending.append(torch.cuda.Event())
                    pending[-1].record()
                    if len(pending) > 1:
                        with tracer.span("wait"):
                            pending.popleft().synchronize()
                if time.perf_counter() - t0 >= seconds:
                    break
            with tracer.span("close"):
                leaf = next(model.parameters())
                failed = int(bad + (0.0 * leaf.detach().sum()).long())
            t1 = time.perf_counter()
    setup_s, window_s = t0 - clock_start, t1 - t0
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    batches = [(images[torch.as_tensor(r, device=device).long()].clone(),
                labels[torch.as_tensor(r, device=device).long()].clone())
               for r in first[:CHECKED_STEPS]]
    del state, step, model, images, labels, data, probe
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    traced = None
    if trace:
        traced = reduce_events(*tracer.events(), steps=attempted)
    ref = reference.run_steps(config, mix, theta0, batches, device)
    numbers = check.training_numbers(program, ref)
    numbers["replay_gap"] = replay_gap
    limits = cell.limits["limits"]

    if trace:
        run_info = {"config": config, "mix": mix, "peak": peak,
                    "counts": family.counts}
        metrics = {}
        for m in cell.per_layer:
            value = None if traced is None else spec.reader(m["name"]).read(traced, run_info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"train_images_per_s": attempted * batch / window_s,
                  "peak_mem_gib": memory_peak / 2 ** 30,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    return {"attempted": attempted, "failed": failed, "metrics": metrics,
            "memory_peak_bytes": memory_peak, "trace": traced, "numbers": numbers,
            "limits": limits, "correct": failed == 0 and check.judge(numbers, limits),
            "setup_s": setup_s, "window_s": window_s}
