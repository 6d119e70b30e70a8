"""Nothing the harness or the reference loads is `jax`, `jaxlib`, `flax` or
the JAX package, by whole top-level module names; the reference loads
nothing of the port."""

import ast
import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "efficient_rpe_vit_tpu"}


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_perfbench_sources_import_no_jax():
    for path in (ROOT / "perfbench").rglob("*.py"):
        assert not _top_level_imports(path) & FORBIDDEN, path
    for path in (ROOT / "perfbench" / "reference").rglob("*.py"):
        assert "efficient_rpe_vit_torch" not in _top_level_imports(path), path


SCRIPT = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from perfbench import spec, calibrate
from perfbench.reference import train
sys.path.insert(0, sys.argv[1] + "/perfbench/tests")
from conftest import tiny, CARD
cell = tiny(spec.load_cell("kerple-b16-train-n4097"))
calibrate.stand_in_readings(cell, 1, torch.device("cpu"))
reference_only = sorted({m.split(".")[0] for m in sys.modules})
spec.runner("train").run(cell, 1, 0.1, False, time.perf_counter(), torch.device("cpu"),
                         spec.peaks()[CARD])
for m in cell.per_layer:
    spec.reader(m["name"])
print(json.dumps({"reference": reference_only,
                  "all": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_perfbench_loaded_modules():
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not set(loaded["all"]) & FORBIDDEN
    assert "efficient_rpe_vit_torch" not in loaded["reference"]
    assert "efficient_rpe_vit_torch" in loaded["all"]
