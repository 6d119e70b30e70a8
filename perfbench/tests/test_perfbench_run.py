"""`run.py` fails without a card, names the reason, prints no result and
never falls back to the CPU; it fails too in a directory that holds only
the benchmark."""

import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

ARGS = ["--workload", "kerple-b16-train-n4097", "--seed", str(2 ** 31 + 9), "--seconds", "1",
        "--trace", "0"]


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the refusal is for machines without one")


def test_perfbench_run_without_a_card_fails():
    _no_card()
    out = subprocess.run([sys.executable, "perfbench/run.py", *ARGS], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_perfbench_run_in_a_bare_directory_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", *ARGS], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
