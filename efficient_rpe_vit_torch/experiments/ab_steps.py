"""What the dispatch A/B experiments share: the card's label, the kernel
wrappers' launch counts, the one JSON line of rows, and model-level A/Bs of
full train steps.

A model-level A/B builds every arm's model, train state and batch in one
process, warms each arm up, then times chains of train steps in the order
parent, change, change, parent (A, B, B, A: drift between chains cancels to
first order). Each chain is closed by one host read of the loss and of a
parameter, which waits for the last update; its time is the host clock.
An arm's time is the mean of its two chains. The experiments that set the
`auto` dispatch (`crossover_ab`, `flash_ab`, `flash_crossover`,
`kerple_pallas_ab`, `rotation_kernel_ab`, `rot_isolated_ab`, `scaling_ab`,
`fused_phi_ab`, `chain_dtype_ab`) run on the GPU unless `--device cpu` is
given, and raise without one; each prints the card's name and power limit,
then one JSON line of rows.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..utils.device import resolve_device
from ..utils.timing import device_label

# ViT-B widths in bf16, as the JAX experiments build them on mnist_config
# (one input channel, ten classes); depth is never cut
VITB_WIDTHS = dict(dim=768, depth=12, heads=12, mlp_dim=3072, dropout=0.0,
                   compute_dtype="bfloat16")


def log(msg: str) -> None:
    print(f"[ab {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def wrappers() -> Dict[str, Callable]:
    """Every kernel wrapper by name; each counts its launches in `.launches`."""
    from ..ops.kernels import circulant_rotate as cr
    from ..ops.kernels import flash_attention as fa
    from ..ops.kernels import masked_linear as ml
    from ..ops.kernels import masked_linear_coeffs as mlc

    return {
        "masked_linear_coeffs_fwd": mlc.masked_linear_attention_coeffs_fwd,
        "masked_linear_coeffs_bwd_dq": mlc.masked_linear_attention_coeffs_bwd_dq,
        "masked_linear_coeffs_bwd_dkv": mlc.masked_linear_attention_coeffs_bwd_dkv,
        "masked_linear_coeffs_bwd_dc": mlc.masked_linear_attention_coeffs_bwd_dc,
        "masked_linear_coeffs_bwd_dc_reduce": mlc.masked_linear_attention_coeffs_bwd_dc_reduce,
        "kerple_fused_phi_fwd": mlc.kerple_attention_fused_phi_fwd,
        "flash_fwd": fa.flash_attention_fwd,
        "flash_bwd_fused": fa.flash_attention_bwd_fused,
        "flash_bwd_dq": fa.flash_attention_bwd_dq,
        "flash_bwd_dkv": fa.flash_attention_bwd_dkv,
        "circulant_rotate_fwd": cr.circulant_rotate_fwd,
        "circulant_rotate_bwd": cr.circulant_rotate_bwd,
        "masked_linear_fwd": ml.masked_linear_fwd,
        "masked_linear_bwd_dq": ml.masked_linear_bwd_dq,
        "masked_linear_bwd_dkv": ml.masked_linear_bwd_dkv,
        "masked_linear_bwd_dt": ml.masked_linear_bwd_dt,
    }


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches made since `before`, kernels with none left out."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def parser(doc: str, steps: int) -> argparse.ArgumentParser:
    """The flags every experiment takes: --device, --steps, --out."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU; default: the GPU (raises without one)")
    ap.add_argument("--steps", type=int, default=steps)
    ap.add_argument("--out", default=None, help="also write the JSON rows to this file")
    return ap


def width_flag(ap: argparse.ArgumentParser) -> None:
    """--width DIM DEPTH HEADS MLP (default ViT-B's), for the model-level
    experiments' CPU tests."""
    ap.add_argument("--width", type=int, nargs=4, metavar=("DIM", "DEPTH", "HEADS", "MLP"),
                    default=None, help="model widths (default: ViT-B's)")


def width_flags(ap: argparse.ArgumentParser) -> None:
    """--width (`width_flag`) and --shape IMAGE PATCH BATCH (repeatable,
    replacing the experiment's shapes), for the model-level experiments."""
    width_flag(ap)
    ap.add_argument("--shape", type=int, nargs=3, action="append",
                    metavar=("IMAGE", "PATCH", "BATCH"),
                    help="a shape to run (repeatable); default: the experiment's")


def widths(args) -> dict:
    if args.width is None:
        return dict(VITB_WIDTHS)
    dim, depth, heads, mlp = args.width
    return dict(VITB_WIDTHS, dim=dim, depth=depth, heads=heads, mlp_dim=mlp)


def start(args) -> Tuple[torch.device, str]:
    """Resolve the device (raising without a GPU unless --device cpu), print
    its label (the card's name and power limit) and return both."""
    device = resolve_device(args.device)
    card = device_label(device)
    print(card, flush=True)
    return device, card


def emit(result: dict, out: Optional[str]) -> dict:
    """Print the result as one JSON line and, with `out`, write it there."""
    print(json.dumps(result), flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    return result


def chain_barrier(state, loss) -> float:
    """A host read of the loss that also depends on a parameter: it waits
    for the last step's backward and update, not only its forward."""
    leaf = next(state.model.parameters())
    return float(loss.float().sum() + 0.0 * leaf.detach().float().sum())


def seq_len(image: int, patch: int) -> int:
    return (image // patch) ** 2 + 1


class StepArm:
    """One arm of a model-level A/B: a model built from seed 0 with the
    arm's configs, its train state, a fixed batch of normal images with
    labels arange(B) % classes, and the train-mode generator.

    `enter` / `leave` run around each of the arm's chains (a module switch
    that the arm's model reads at call time)."""

    def __init__(self, variant: str, cfg, device: torch.device,
                 attention_config=None, rpe_config=None,
                 enter: Optional[Callable[[], None]] = None,
                 leave: Optional[Callable[[], None]] = None):
        from ..models import create_model
        from ..train import create_train_state, make_train_step

        self.enter, self.leave = enter, leave
        self.model = create_model(variant, cfg, attention_config=attention_config,
                                  rpe_config=rpe_config, device=device,
                                  generator=torch.Generator().manual_seed(0))
        self.state = create_train_state(self.model, cfg, steps_per_epoch=100)
        self.step = make_train_step(self.model, device=device)
        m = cfg.model
        data = torch.Generator(device).manual_seed(0)
        self.images = torch.randn((cfg.train.batch_size, m.image_size, m.image_size,
                                   m.in_channels), generator=data, device=device)
        self.labels = torch.arange(self.images.shape[0], device=device) % m.num_classes
        self.generator = torch.Generator(device).manual_seed(1)
        self.times = []
        self.launches: Dict[str, int] = {}

    def chain(self, steps: int) -> float:
        """Seconds per step over `steps` chained steps, closed by a host read."""
        if self.enter:
            self.enter()
        try:
            before = launch_counts()
            t0 = time.perf_counter()
            for _ in range(steps):
                self.state, loss, _ = self.step(self.state, self.images, self.labels,
                                                self.generator)
            value = chain_barrier(self.state, loss)
            seconds = (time.perf_counter() - t0) / steps
            for k, n in launches_since(before).items():
                self.launches[k] = self.launches.get(k, 0) + n
        finally:
            if self.leave:
                self.leave()
        if not math.isfinite(value):
            raise FloatingPointError("a train step's loss is not finite")
        self.last_loss = value
        return seconds


def abba(arms: Dict[str, StepArm], steps: int, warmup: int = 3) -> Dict[str, dict]:
    """Time two arms parent, change, change, parent after `warmup` steps of
    each; per arm its step ms (mean of its two chains), images/s, the chains'
    ms, its launches per timed step, and the last loss."""
    names = list(arms)
    if len(names) != 2:
        raise ValueError(f"an A/B takes two arms, got {names}")
    for arm in arms.values():
        arm.chain(warmup)
        arm.launches = {}
    a, b = names
    for name in (a, b, b, a):
        arms[name].times.append(arms[name].chain(steps))
    rows = {}
    for name, arm in arms.items():
        step_s = sum(arm.times) / len(arm.times)
        rows[name] = {"step_ms": step_s * 1e3,
                      "images_per_sec": arm.images.shape[0] / step_s,
                      "chains_ms": [t * 1e3 for t in arm.times],
                      "launches_per_step": {k: n / (2 * steps) for k, n in arm.launches.items()},
                      "loss": arm.last_loss}
    return rows


def release() -> None:
    """Free the allocator's cached blocks between shapes."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def model_ab(variant: str, fields: dict, arms: Dict[str, dict], steps: int,
             device: torch.device) -> dict:
    """One model-level A/B row: `variant` on mnist_config(**fields), each arm
    built with its keyword arguments to `StepArm` (attention_config,
    rpe_config, enter, leave), timed by `abba` in the order of `arms`."""
    from ..configs import mnist_config

    cfg = mnist_config(**fields)
    built = {name: StepArm(variant, cfg, device, **kw) for name, kw in arms.items()}
    try:
        rows = abba(built, steps)
    finally:
        del built
        release()
    a, b = arms
    row = {"variant": variant, "N": seq_len(fields["image_size"], fields["patch_size"]),
           "batch": fields["batch_size"], "dim": fields["dim"], "heads": fields["heads"],
           "depth": fields["depth"], "steps": steps, **rows,
           f"speedup_{b}_over_{a}": rows[a]["step_ms"] / rows[b]["step_ms"]}
    log(f"{variant} N={row['N']} B={row['batch']}: {a} {rows[a]['step_ms']:.3f} ms, "
        f"{b} {rows[b]['step_ms']:.3f} ms")
    return row


def shape_fields(args, shapes) -> list:
    """(image, patch, batch) fields of each shape to run: --shape's, else
    `shapes`, at the widths of --width."""
    w = widths(args)
    return [dict(w, image_size=image, patch_size=patch, batch_size=batch)
            for image, patch, batch in (args.shape or shapes)]
