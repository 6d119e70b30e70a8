"""Every model-specific step of the harness is looked up by the
configuration's `family` (`spec.family`): the `vit` family gives the four
accepted cells what the harness gave them before the lookup, bit for bit,
and a family installed beside it under the three module names runs through
the runner, the reference and calibrate with no harness file edited."""

import dataclasses
import hashlib
import json
import math
import sys
import time
import types

import pytest
import torch
import torch.nn as nn

from conftest import CARD, tiny
from perfbench import calibrate, check, spec
from perfbench.reference import train as reference
from perfbench.trace import Trace
from perfbench.weights import chunks, make_images, make_weights

SEED, STAND_IN_SEED = 2 ** 31 + 11, 7

# Recorded on the tree before the lookup (the harness calling reference/vit.py
# and the port's create_model directly), with one CPU thread: the full-size
# leaf list (sha256 of its JSON [name, shape, init] rows), the step FLOPs and
# the op bounds on the H100's peaks, the tiny leaves' weights for SEED (sha256
# of name and float32 bytes, leaf by leaf), and the tiny runs: the runner's
# check numbers (float32), the reference's losses from the same inputs, and
# calibrate's control and faults (bfloat16, STAND_IN_SEED) as (loss_gap,
# grad_gap, step_gap).
PARENT = {
    "kerple-b16-train-n4097": {
        "leaves": 164,
        "spec": "0b58ca043886ad622a5ab9b3b17420723b30ec42e413a5f0d3ee7c8f13764f4c",
        "train_flops_per_step": 28034972133120.0,
        "op_least_seconds": (0.0005376761952679474, 0.0015087519903579374),
        "tiny_weights": "d5ef060e1dbc46149d866243ae736da0001a29473a01b4f872c6308d1432c797",
        "numbers": {"loss_gap": 8.466639155733836e-08, "grad_gap": 1.5806538089963227e-07,
                    "step_gap": 1.1197005831064727e-07, "replay_gap": 0.0},
        "reference_losses": [2.3428711891174316, 3.321810722351074, 2.815976619720459],
        "stand_ins": {
            "fp8": (0.02359142001887427, 0.07582913583043654, 0.06435680525425538),
            "half": (0.3590545810605005, 0.40553311701662387, 0.16698963628916508),
            "answer": (0.07331541875253993, 0.06638669138232714, 0.02787863530615066),
        },
    },
    "softmax-b16-train-n4097": {
        "leaves": 140,
        "spec": "97bbebc4e79bf1821f8d6fee207ad6b9238f79939e9ea92eb54a2f1606bb1df6",
        "train_flops_per_step": 15834783154176.0,
        "op_least_seconds": (0.00020855319089180992, 0.0005213829772295248),
        "tiny_weights": "c1a448036f246f0aea30a46a05e45c33f361607a1d7be46611ae609df3effedc",
        "numbers": {"loss_gap": 0.0, "grad_gap": 2.7518823735398256e-07,
                    "step_gap": 2.9773956125098256e-06, "replay_gap": 0.0},
        "reference_losses": [3.4777755737304688, 2.1951889991760254, 2.9192070960998535],
        "stand_ins": {
            "fp8": (0.010354587307156602, 0.06896125977726432, 0.04830017041667767),
            "half": (0.16388972410946845, 0.7018166705697932, 0.08453614121254995),
            "answer": (0.06087568205365787, 0.0020191225916313996, 0.015461499893788921),
        },
    },
    "kerple-b16-train-n197": {
        "leaves": 164,
        "spec": "4fb5552f4934466a4bab85b07f71e6e5e3443cffe172ec988d97f270038ca7fa",
        "train_flops_per_step": 15097787965440.0,
        "op_least_seconds": (0.00011923591164179105, 0.00022691009910447762),
        "tiny_weights": "d5ef060e1dbc46149d866243ae736da0001a29473a01b4f872c6308d1432c797",
        "numbers": {"loss_gap": 8.466639155733836e-08, "grad_gap": 1.5806538089963227e-07,
                    "step_gap": 1.1197005831064727e-07, "replay_gap": 0.0},
        "reference_losses": [2.3428711891174316, 3.321810722351074, 2.815976619720459],
        "stand_ins": {
            "fp8": (0.02359142001887427, 0.07582913583043654, 0.06435680525425538),
            "half": (0.3590545810605005, 0.40553311701662387, 0.16698963628916508),
            "answer": (0.07331541875253993, 0.06638669138232714, 0.02787863530615066),
        },
    },
    "softmax-b16-train-n197": {
        "leaves": 140,
        "spec": "07e87660ec481922bc5c71c74a3eedb64271d4d1eb663099eb2d4cb25a5a845c",
        "train_flops_per_step": 13489020076032.0,
        "op_least_seconds": (4.624689671641791e-05, 8.093206925373135e-05),
        "tiny_weights": "c1a448036f246f0aea30a46a05e45c33f361607a1d7be46611ae609df3effedc",
        "numbers": {"loss_gap": 0.0, "grad_gap": 2.7518823735398256e-07,
                    "step_gap": 2.9773956125098256e-06, "replay_gap": 0.0},
        "reference_losses": [3.4777755737304688, 2.1951889991760254, 2.9192070960998535],
        "stand_ins": {
            "fp8": (0.010354587307156602, 0.06896125977726432, 0.04830017041667767),
            "half": (0.16388972410946845, 0.7018166705697932, 0.08453614121254995),
            "answer": (0.06087568205365787, 0.0020191225916313996, 0.015461499893788921),
        },
    },
}


@pytest.fixture
def one_thread():
    """Bitwise CPU results want the thread count they were recorded at."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec_digest(leaves):
    rows = json.dumps([[n, list(s), k] for n, s, k in leaves])
    return hashlib.sha256(rows.encode()).hexdigest()


def _weights_digest(weights):
    h = hashlib.sha256()
    for name, t in weights.items():
        h.update(name.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _first_batches(config, mix, seed):
    images, labels = make_images(mix["held_images"], mix["image_size"], config["in_channels"],
                                 config["num_classes"], seed, "cpu")
    first = next(chunks(mix["held_images"], mix["batch"], mix["fused_steps"], seed))
    return [(images[torch.as_tensor(r).long()], labels[torch.as_tensor(r).long()])
            for r in first[:3]]


@pytest.mark.parametrize("workload", list(PARENT))
def test_perfbench_vit_family_spec_and_counts_unchanged(workload):
    cell = spec.load_cell(workload)
    family = spec.family(cell.config)
    assert family.name == "vit"
    leaves = family.reference.parameter_spec(cell.config, cell.mix)
    parent = PARENT[workload]
    assert len(leaves) == parent["leaves"]
    assert _spec_digest(leaves) == parent["spec"]
    assert family.counts.train_flops_per_step(cell.config, cell.mix) == \
        parent["train_flops_per_step"]
    least = spec.counts(cell.config["attention"]).op_least_seconds(cell.config, cell.mix,
                                                                    spec.peaks()[CARD])
    assert (least["forward"], least["backward"]) == parent["op_least_seconds"]


@pytest.mark.parametrize("workload", list(PARENT))
def test_perfbench_vit_family_tiny_runs_unchanged(one_thread, workload):
    cell = tiny(spec.load_cell(workload))
    config, mix = cell.config, cell.mix
    parent = PARENT[workload]
    leaves = spec.family(config).reference.parameter_spec(config, mix)
    weights = make_weights(leaves, SEED, "cpu")
    assert _weights_digest(weights) == parent["tiny_weights"]
    out = spec.runner(mix["kind"]).run(cell, SEED, 0.0, False, time.perf_counter(),
                                       torch.device("cpu"), spec.peaks()[CARD])
    assert out["numbers"] == parent["numbers"] and out["correct"]
    ref = reference.run_steps(config, mix, weights, _first_batches(config, mix, SEED), "cpu")
    assert ref["losses"] == parent["reference_losses"]
    readings = calibrate.stand_in_readings(tiny(spec.load_cell(workload), "bfloat16"),
                                           STAND_IN_SEED, torch.device("cpu"))
    for fault, numbers in parent["stand_ins"].items():
        got = readings[fault]
        assert (got["loss_gap"], got["grad_gap"], got["step_gap"]) == numbers, fault


# A family of its own: a convolutional patch embedding (a rank-4 xavier
# leaf), tanh, the mean over patches and a linear head.
TOY = {"name": "toy-conv", "family": "toy", "in_channels": 3, "patch_size": 4, "dim": 8,
       "num_classes": 5, "compute_dtype": "float32", "optimizer": "adamw",
       "base_learning_rate": 0.0005, "base_batch": 512, "weight_decay": 0.05,
       "scheduler": "cosine", "epochs": 300, "label_smoothing": 0.1,
       "mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}
TOY_MIX = {"name": "toy-train", "kind": "train", "image_size": 16, "batch": 4,
           "fused_steps": 3, "held_images": 24}


class _ToyModel(nn.Module):
    def __init__(self, config, generator):
        super().__init__()
        c, p, d = config["in_channels"], config["patch_size"], config["dim"]
        self.embed = nn.Conv2d(c, d, p, stride=p)
        self.head = nn.Linear(d, config["num_classes"])

    def forward(self, images, generator=None):
        h = torch.tanh(self.embed(images.permute(0, 3, 1, 2)))
        return self.head(h.mean((2, 3)))


def _toy_program():
    from efficient_rpe_vit_torch.configs import ExperimentConfig, ModelConfig, TrainConfig

    def build(config, mix, device, generator):
        exp = ExperimentConfig(
            model=ModelConfig(image_size=mix["image_size"], in_channels=config["in_channels"],
                              patch_size=config["patch_size"],
                              num_classes=config["num_classes"], dim=config["dim"]),
            train=TrainConfig(batch_size=mix["batch"],
                              learning_rate=reference.learning_rate(config, mix, 0),
                              weight_decay=config["weight_decay"], epochs=config["epochs"],
                              optimizer=config["optimizer"], scheduler=config["scheduler"],
                              compute_dtype=config["compute_dtype"]))
        return _ToyModel(config, generator).to(device), exp

    return {"build": build, "tiny": lambda config, mix: (config, mix)}


def _toy_reference():
    def parameter_spec(config, mix):
        c, p, d, k = (config["in_channels"], config["patch_size"], config["dim"],
                      config["num_classes"])
        return [("embed.weight", (d, c, p, p), "xavier"), ("embed.bias", (d,), "small"),
                ("head.weight", (k, d), "xavier"), ("head.bias", (k,), "small")]

    def forward(w, x, config, prods):
        b, size, _, c = x.shape
        p = config["patch_size"]
        g = size // p
        patches = (x.permute(0, 3, 1, 2).reshape(b, c, g, p, g, p)
                   .permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, c * p * p))
        embed = w["embed.weight"].reshape(w["embed.weight"].shape[0], -1)
        h = torch.tanh(prods.linear(patches, embed, w["embed.bias"]))
        return prods.linear(h.mean(1), w["head.weight"], w["head.bias"])

    return {"parameter_spec": parameter_spec, "trains": lambda init: True, "forward": forward,
            "block_rows": lambda config, mix, budget_bytes=16e9: mix["batch"]}


def _toy_counts():
    def shape(config, mix):
        p = config["patch_size"]
        return {"B": mix["batch"], "patches": (mix["image_size"] // p) ** 2,
                "patch_dim": config["in_channels"] * p * p, "dim": config["dim"],
                "classes": config["num_classes"]}

    def train_flops_per_step(config, mix):
        s = shape(config, mix)
        forward = 2 * s["patches"] * s["patch_dim"] * s["dim"] + 2 * s["dim"] * s["classes"]
        return 3.0 * s["B"] * forward

    return {"shape": shape, "train_flops_per_step": train_flops_per_step}


@pytest.fixture
def toy_family(monkeypatch):
    """The toy family installed as perfbench.{families,reference,counts}.toy
    for the test's length; no file is written."""
    for package, members in (("families", _toy_program()), ("reference", _toy_reference()),
                              ("counts", _toy_counts())):
        module = types.ModuleType(f"perfbench.{package}.toy")
        module.__dict__.update(members)
        monkeypatch.setitem(sys.modules, module.__name__, module)
    template = spec.load_cell("softmax-b16-train-n197")
    entry = dict(template.entry, name="toy-conv-train", config=TOY["name"],
                 traffic=TOY_MIX["name"])
    return dataclasses.replace(template, name=entry["name"], entry=entry, config=dict(TOY),
                               mix=dict(TOY_MIX))


def test_perfbench_toy_family_runs_through_the_harness(toy_family):
    cell = toy_family
    family = spec.family(cell.config)
    assert family.name == "toy"
    assert family.program is sys.modules["perfbench.families.toy"]
    assert family.reference is sys.modules["perfbench.reference.toy"]
    assert family.counts is sys.modules["perfbench.counts.toy"]

    out = spec.runner(cell.mix["kind"]).run(cell, SEED, 0.3, False, time.perf_counter(),
                                            torch.device("cpu"), spec.peaks()[CARD])
    n = out["numbers"]
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 1e-5 and n["step_gap"] < 1e-4
    assert n["replay_gap"] == 0.0
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0

    leaves = family.reference.parameter_spec(cell.config, cell.mix)
    weights = make_weights(leaves, SEED, "cpu")
    conv = weights["embed.weight"]  # [8, 3, 4, 4]: fans 3 x 16 and 8 x 16
    assert conv.shape == (8, 3, 4, 4)
    ref = reference.run_steps(cell.config, cell.mix, weights,
                              _first_batches(cell.config, cell.mix, SEED), "cpu")
    assert len(ref["losses"]) == 3 and all(math.isfinite(x) for x in ref["losses"])
    assert sorted(ref["grad_norms"]) == sorted(ref["delta_norms"]) == sorted(weights)

    readings = calibrate.stand_in_readings(cell, STAND_IN_SEED, torch.device("cpu"))
    assert set(readings) == set(calibrate.FAULTS)
    assert not check.judge(dict(readings["half"], replay_gap=0.0), cell.limits["limits"])

    run_info = {"config": cell.config, "mix": cell.mix, "peak": spec.peaks()[CARD],
                "counts": family.counts}
    mfu = spec.reader("step_mfu.train").read(Trace(1.0, 1.0, 10, {}), run_info)
    assert mfu == pytest.approx(100 * 10 * 3 * 4 * (2 * 16 * 48 * 8 + 2 * 8 * 5) / 67e12)


def test_perfbench_unknown_family_fails_by_name(monkeypatch):
    assert "vit" in spec.families()
    with pytest.raises(KeyError, match=r"no model family 'resnet'.*'vit'"):
        spec.family({"family": "resnet"})
    half = types.ModuleType("perfbench.families.half_toy")
    monkeypatch.setitem(sys.modules, half.__name__, half)
    with pytest.raises(KeyError, match=r"reference/half_toy\.py is missing"):
        spec.family({"family": "half_toy"})
