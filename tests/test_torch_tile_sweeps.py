"""The port's tile sweeps (`experiments/flash_tune.py` and
`experiments/coeffs_tune.py` counterparts) on the CPU, where no kernel
builds: every shipped text the sweeps swap is in the current `csrc/`
exactly once; the grid -> template mapping (each kernel's tile, dq's
split, MINB by the registers and shared memory) gives the shipped tiles
their shipped instantiations; a point's copy of `csrc/` differs from the
sources only in the swapped instantiations; the flags are the JAX ones
(the default grids are the H100 kernels'); both mains raise without a
GPU, with `--device cpu` too; and the sweeps' shared loop records a failed
build or a refused launch as its point's row and restores the shipped
libraries."""

import sys
import types

import pytest
import torch

from efficient_rpe_vit_torch.experiments import coeffs_tune, flash_tune, tile_trial
from efficient_rpe_vit_torch.ops.kernels import _build
from torch_experiment_cli import flag_defaults, jax_experiment


def _source(name: str) -> str:
    return (_build.CSRC / f"{name}.cu").read_text()


def _all_swaps(module, points):
    for point in points:
        for source, pairs in module.swaps(*point).items():
            for shipped, swapped in pairs:
                yield point, source, shipped, swapped


@pytest.mark.parametrize("module, points", [
    (flash_tune, [(q, kv) for q in flash_tune.BLOCKS_Q for kv in flash_tune.BLOCKS_KV]),
    (coeffs_tune, coeffs_tune.CONFIGS)], ids=["flash", "coeffs"])
def test_every_swapped_text_is_in_the_sources_once(module, points):
    seen = 0
    for point, source, shipped, swapped in _all_swaps(module, points):
        assert _source(source).count(shipped) == 1, (point, shipped)
        seen += 1
    assert seen >= len(points)


def test_flash_grid_mapping_gives_the_shipped_instantiations():
    fwd, bwd = _source("flash_attention_fwd"), _source("flash_attention_bwd")
    # the shipped choices at D <= 64, with the MINB the rule gives their tiles
    for n, (rows, stage) in ((4097, (128, 64)), (197, (64, 64))):
        tile = flash_tune.shipped_tiles(n)["flash_fwd"]
        assert tile == (rows, stage)
        minb = flash_tune.min_blocks("flash_fwd", *tile)
        assert f"fwd_choice<DP, {rows // 16}, {stage}, {minb}>()" in fwd
    for kernel, choice in (("flash_bwd_dq", "dq_choice"), ("flash_bwd_dkv", "dkv_choice")):
        rows, stage = flash_tune.shipped_tiles(4097)[kernel]
        minb = flash_tune.min_blocks(kernel, rows, stage)
        assert f"{choice}<DP, {rows // 16}, {stage}, DP <= 64 ? {minb} :" in bwd
    # the roles: the forward and dq own query rows, dkv key/value rows
    assert flash_tune.tiles(128, 32) == {"flash_fwd": (128, 32), "flash_bwd_dq": (128, 32),
                                         "flash_bwd_dkv": (32, 128)}
    assert flash_tune.swaps(64, 128)["flash_attention_bwd"][1][1].endswith(
        "if constexpr (DP == 64) return dkv_choice<64, 8, 64, 1>();\n")
    # MINB: registers bound it at 4-warp forward tiles, shared memory at wide stages
    assert flash_tune.min_blocks("flash_fwd", 64, 128) == 2
    assert flash_tune.min_blocks("flash_bwd_dkv", 128, 128) == 1
    for q in flash_tune.BLOCKS_Q:
        for kv in flash_tune.BLOCKS_KV:
            for kernel, (rows, stage) in flash_tune.tiles(q, kv).items():
                assert flash_tune.smem_bytes(kernel, rows, stage) <= 227 * 1024


def test_coeffs_grid_mapping_gives_the_shipped_instantiations():
    fwd, bwd = _source("masked_linear_coeffs_fwd"), _source("masked_linear_coeffs_bwd")
    for kernel, (source, texts) in coeffs_tune.SHIPPED.items():
        assert coeffs_tune.instantiation(kernel, *coeffs_tune.SHIPPED_TILES[kernel]) == texts
        for text in texts:
            assert text in (fwd if source.endswith("fwd") else bwd)
    # the templates' limits: dq's split keeps 16 warps where the stage allows
    # it and divides the stage; dkv streams 32-row query stages; dc's block
    # is a multiple of the 64-row window tile, its stage divides it
    for bq, bkv in coeffs_tune.CONFIGS:
        split = coeffs_tune.dq_split(bq, bkv)
        assert bkv % (16 * split) == 0 and bq // 16 * split <= 16
        t = coeffs_tune.tiles(bq, bkv)
        assert (t["masked_linear_coeffs_bwd_dkv"] is None) == (bq != 32)
        assert (t["masked_linear_coeffs_bwd_dc"] is None) == (bq == 32)
    assert coeffs_tune.dq_split(128, 64) == 2 and coeffs_tune.dq_split(64, 64) == 4
    assert coeffs_tune.dq_split(32, 32) == 2
    # every kernel leaves its shipped tile at some point of the grid
    for kernel in coeffs_tune.KERNELS:
        tiles = {coeffs_tune.tiles(*p)[kernel] for p in coeffs_tune.CONFIGS} - {None}
        assert tiles - {coeffs_tune.SHIPPED_TILES[kernel]}, kernel


@pytest.mark.parametrize("module, point", [(flash_tune, (64, 64)), (coeffs_tune, (32, 32))],
                         ids=["flash", "coeffs"])
def test_a_copy_differs_only_in_its_instantiations(tmp_path, module, point):
    paths = tile_trial.write_copy(tmp_path / "copy", module.swaps(*point))
    for source, path in paths.items():
        got, shipped = path.read_text(), _source(source)
        for old, new in module.swaps(*point)[source]:
            assert new in got
            shipped = shipped.replace(old, new)
        assert got == shipped
    # the rest of csrc/ is copied unchanged (headers included)
    for other in _build.CSRC.iterdir():
        if other.stem not in paths:
            assert (tmp_path / "copy" / other.name).read_bytes() == other.read_bytes()


def test_flags_are_the_jax_ones():
    jax_flash = flag_defaults(jax_experiment("flash_tune").main)
    port_flash = flag_defaults(flash_tune.main)
    assert set(port_flash) - set(jax_flash) == {"device", "out"}
    for dest, default in jax_flash.items():
        if dest not in ("blocks_q", "blocks_kv"):  # TPU tiles there, the H100 grid here
            assert port_flash[dest] == default, dest
    assert (port_flash["blocks_q"], port_flash["blocks_kv"]) == ([64, 128], [32, 64, 128])
    jax_coeffs = jax_experiment("coeffs_tune")
    port_coeffs = flag_defaults(coeffs_tune.main)
    assert set(port_coeffs) - set(flag_defaults(jax_coeffs.main)) == {"device"}
    for dest, default in flag_defaults(jax_coeffs.main).items():
        if dest != "out":
            assert port_coeffs[dest] == default, dest
    # the JAX grid is of TPU blocks (256-1024 rows), the port's of the H100 tiles
    assert coeffs_tune.CONFIGS == [(32, 32), (32, 64), (64, 32), (64, 64), (128, 32), (128, 64)]


@pytest.mark.parametrize("module", [flash_tune, coeffs_tune], ids=["flash", "coeffs"])
def test_main_needs_a_gpu(module):
    if torch.cuda.is_available():
        pytest.skip("checks the sweep without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main([])
    with pytest.raises(RuntimeError, match="needs the GPU"):
        module.main(["--device", "cpu"])


def test_sweep_points_records_failures_and_restores_the_loaders(monkeypatch):
    module = types.ModuleType("fake_wrappers")
    module.loader = shipped = object()
    monkeypatch.setitem(sys.modules, module.__name__, module)

    def use_library(mod, loader, path, originals):
        originals.setdefault((mod.__name__, loader), getattr(mod, loader))
        setattr(mod, loader, path)

    def measure():
        if module.loader == "b.so":
            raise RuntimeError("too many resources requested for launch")
        return {"fwd_ms": 1.0, "loaded": module.loader}

    monkeypatch.setattr(tile_trial, "use_library", use_library)
    built = {(1, 1): ({}, "x.cu: error"), (2, 2): ({"src": "a.so"}, None),
             (3, 3): ({"src": "b.so"}, None)}
    rows = tile_trial.sweep_points(list(built), built, [(module, "loader", "src")],
                                   lambda point: {"label": point}, measure)
    assert rows == [{"label": (1, 1), "failed": "build: x.cu: error"},
                    {"label": (2, 2), "fwd_ms": 1.0, "loaded": "a.so"},
                    {"label": (3, 3), "failed": "RuntimeError: too many resources "
                                                "requested for launch"}]
    assert module.loader is shipped
