"""The port's long-N convergence run (`experiments/longn_train.py`'s
counterpart) on the CPU: the JAX variants and flag defaults, every run's
JAX keys, a falling loss on a tiny model (deterministic on the CPU), and
`main` raising without a GPU."""

import json
import math

import pytest
import torch

from efficient_rpe_vit_torch.experiments import longn_train
from torch_experiment_cli import flag_defaults, jax_experiment

torch.set_num_threads(2)

JAX = jax_experiment("longn_train")
JAX_RUN_KEYS = {"variant", "steps", "lr", "batch", "n_train", "dropout", "losses",
                "accuracies", "loss_first5_mean", "loss_last5_mean", "decreased",
                "finite", "wall_s"}
TINY = ["--device", "cpu", "--width", "32", "2", "2", "64", "--shape", "16", "4", "4"]


def test_variants_and_flags_are_the_jax_ones():
    assert longn_train.VARIANTS == JAX.VARIANTS
    jax_flags = flag_defaults(JAX.main)
    port_flags = flag_defaults(longn_train.main)
    # the port writes a file only with --out (the JAX default holds TPU
    # rows), and adds --device and the CPU tests' --width and --shape
    assert set(port_flags) - set(jax_flags) == {"device", "width", "shape"}
    for dest, default in jax_flags.items():
        if dest != "out":
            assert port_flags[dest] == default, dest
    assert port_flags["shape"] == [128, 2, 4]  # N = 4097, batch 4, as JAX
    assert longn_train.N_TRAIN == 16 and longn_train.DROPOUT == 0.1


def test_runs_carry_the_jax_keys_and_the_loss_falls(tmp_path):
    out = tmp_path / "longn.json"
    result = longn_train.main([*TINY, "--steps", "30", "--lr", "1e-3", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    assert set(result) == {"backend", "N", "dims", "note", "runs"}
    assert result["N"] == 17 and result["backend"].startswith("cpu")
    assert [r["variant"] for r in result["runs"]] == JAX.VARIANTS
    for run in result["runs"]:
        assert set(run) == JAX_RUN_KEYS | {"launches"}, run
        assert (run["steps"], run["batch"], run["n_train"], run["dropout"]) == (30, 4, 16, 0.1)
        assert len(run["losses"]) == len(run["accuracies"]) == 30
        assert run["finite"] and all(math.isfinite(x) for x in run["losses"])
        assert run["decreased"], run["losses"]
        assert run["loss_last5_mean"] < 0.6 * run["loss_first5_mean"], run["losses"]
        assert run["launches"] == {}  # CPU: the plain versions


def test_a_run_is_deterministic_on_the_cpu():
    a, b = (longn_train.run("performer_favor_most_general", 6, 1e-3, image=16, patch=4,
                            device="cpu", widths=dict(longn_train.ab_steps.VITB_WIDTHS, dim=32,
                                                      depth=2, heads=2, mlp_dim=64))
            for _ in range(2))
    assert a["losses"] == b["losses"] and a["accuracies"] == b["accuracies"]


def test_main_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the run without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        longn_train.main(["--steps", "1"])
