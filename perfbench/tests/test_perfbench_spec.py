"""BENCHMARK.json keeps to the contract, and every name in it is found."""

import json
import math

import pytest

from conftest import CELLS, ROOT
from perfbench import spec

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# the cells accepted so far, which later cells follow
ACCEPTED = ["kerple-b16-train-n4097", "softmax-b16-train-n4097",
            "kerple-b16-train-n197", "softmax-b16-train-n197"]
VIT_B16 = [c["name"] for c in spec.load_benchmark()["configs"]
           if c["name"].startswith("vit-b16-")]


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def _line(text, most=200):
    return isinstance(text, str) and 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_perfbench_top_level(bench):
    assert set(bench) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits its time: 2 + 14 x cells runs
    cells = 24
    need = (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_perfbench_entries_keep_their_keys(bench, section):
    entries = bench[section]
    assert entries
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[section] <= set(e) <= ENTRY_KEYS[section] | extra, e
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for name in names:
        assert spec.NAME_RE.match(name), name


def test_perfbench_names_units_and_lines(bench):
    for c in bench["configs"]:
        assert _line(c["why"]) and _line(c["source"]) and c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16 and all(spec.NAME_RE.match(k) for k in c["reduced"])
        assert c["file"].startswith("perfbench/")
    for w in bench["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert spec.NAME_RE.match(w["config"]) and spec.NAME_RE.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert spec.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert _line(m["layer"]) and m["moves"] in e2e
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_perfbench_every_config_is_used_and_cells_are_in_order(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    assert CELLS == [w["name"] for w in bench["workloads"]]
    assert CELLS[:len(ACCEPTED)] == ACCEPTED


@pytest.mark.parametrize("workload", CELLS)
def test_perfbench_cell_finds_everything_by_name(bench, workload):
    cell = spec.load_cell(workload, bench)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.mix["name"] == cell.entry["traffic"]
    assert spec.runner(cell.mix["kind"]).run
    family = spec.family(cell.config)
    assert family.name == cell.config["family"]
    assert family.program.build and family.reference.forward
    assert family.counts.train_flops_per_step(cell.config, cell.mix) > 0
    if cell.mix["kind"] == "train":
        assert set(cell.limits["limits"]) == {"loss_gap", "grad_gap", "step_gap",
                                              "replay_gap"}
        assert cell.limits["limits"]["replay_gap"] == 0
        assert {m["name"] for m in cell.end_to_end} == {"train_images_per_s", "peak_mem_gib",
                                                        "setup_s"}
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]).read)
    for m in bench["per_layer"]:
        for w in m.get("workloads", []):
            assert w in CELLS


def test_perfbench_kernel_groups():
    groups = spec.kernel_groups()
    files = sorted((spec.HERE / "kernel_groups").glob("*.json"))
    assert [g["name"] for g in groups] == [f.stem for f in files]
    assert spec.classify("void mlc_bwd_dkv_mma_kernel<272, 64, 64>", groups) == "kerple"
    assert spec.classify("(anonymous namespace)::mlc_bwd_dc_reduce_kernel(float const*)",
                         groups) == "kerple"
    assert spec.classify("void flash_bwd_fused_mma_kernel<64, 13, 32>", groups) == "flash"
    assert spec.classify("sm80_xmma_gemm_f32f32_f32f32_f32_nn", groups) == "gemm"
    assert spec.classify("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN", groups) == "gemm"
    assert spec.classify("vectorized_layer_norm_kernel", groups) == "pointwise"
    assert spec.classify("multi_tensor_apply_kernel<TensorListMetadata<3>, copy>", groups) is None
    assert spec.classify("Memcpy HtoD (Pinned -> Device)", groups) is None


def test_perfbench_kernel_groups_hold_the_cards_kernels_once():
    """Every kernel name of a traced window of the four cells on the H100
    (kernel_names.json) is in one group at most, and those of the groups
    the readers sum stay in them."""
    groups = spec.kernel_groups()
    seen = json.loads((spec.HERE / "tests" / "kernel_names.json").read_text())
    for kernel, group in seen.items():
        found = spec.classify(kernel, groups)
        if group is not None:
            assert found == group, kernel


def test_perfbench_overlapping_groups_fail():
    """A group added beside the others takes no kernel from them: one that
    would is an error, so no reader's number moves without an edit."""
    groups = spec.kernel_groups() + [{"name": "phi", "patterns": ["exp_kernel"]}]
    kernel = "void at::native::vectorized_elementwise_kernel<4, at::native::exp_kernel_cuda>"
    with pytest.raises(ValueError, match="overlap"):
        spec.classify(kernel, groups)
    assert spec.classify("void rot_fwd_mma_kernel<64>", groups + [
        {"name": "rotation", "patterns": ["rot_fwd_"]}]) == "rotation"


@pytest.mark.parametrize("name", VIT_B16)
def test_perfbench_configs_keep_vit_b16_widths(name):
    config = spec.load_json(spec.config_file(name))
    assert (config["dim"], config["depth"], config["heads"], config["mlp_dim"],
            config["patch_size"], config["num_classes"]) == (768, 12, 12, 3072, 16, 1000)
    assert config["reduced"] == [] and config["assumed"]
    if config["attention"] == "kerple":
        assert config["num_features"] == math.floor(64 * math.log(64))


def test_perfbench_limits_record_their_readings():
    for workload in CELLS:
        data = json.loads(spec.limits_file(workload).read_text())
        assert set(data["limits"]) <= set(data["readings"]["lower"]) | {"replay_gap"}
