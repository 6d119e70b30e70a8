"""The frozen counts against a hand count at a small shape, and the
rooflines' independence of kernel names."""

import pytest

from perfbench import spec
from perfbench.counts import kerple, softmax, vit
from perfbench.trace import Trace

# dim 8, 2 heads (D = 4), depth 1, mlp 16, patch 2 over 4x4x3 images: N = 5
CONFIG = {"dim": 8, "heads": 2, "depth": 1, "mlp_dim": 16, "patch_size": 2,
          "in_channels": 3, "num_classes": 3, "num_features": 5,
          "compute_dtype": "bfloat16"}
MIX = {"image_size": 4, "batch": 2}
PEAK = {"bfloat16_flops_per_s": 1e12, "float32_flops_per_s": 1e11, "hbm_bytes_per_s": 1e9}

# per image, one forward, by hand: qkv 2*5*8*24 = 1920, proj 2*5*8*8 = 640,
# mlp 2*2*5*8*16 = 2560, patch embedding 2*4*12*8 = 768, head 2*8*3 = 48
SHARED = 1920 + 640 + 2560 + 768 + 48
# softmax: S and P v, 2 * 2 * H * N^2 * D = 2 * 2 * 2 * 25 * 4
SOFTMAX = 800
# kerple: phi's projections 2 * 2 * H * N * D * F = 800, q'k'^T 2*H*N^2*F =
# 500, W v 2*H*N^2*D = 400
KERPLE = 800 + 500 + 400


def test_perfbench_counts_shared_part():
    assert vit.shared_forward_flops_per_image(vit.shape(CONFIG, MIX)) == SHARED


@pytest.mark.parametrize("module, own", [(softmax, SOFTMAX), (kerple, KERPLE)])
def test_perfbench_counts_train_step_is_three_forwards(module, own):
    assert module.train_flops_per_step(CONFIG, MIX) == 3 * MIX["batch"] * (SHARED + own)


def test_perfbench_counts_softmax_op_bounds():
    b = softmax.op_least_seconds(CONFIG, MIX, PEAK)
    product = 2 * 2 * 2 * 25 * 4  # 2 B H N^2 D
    bhnd = 2 * 2 * 5 * 4
    assert b["forward"] == pytest.approx(max(2 * product / 1e12, 2 * 4 * bhnd / 1e9))
    assert b["backward"] == pytest.approx(max(5 * product / 1e12, 2 * 7 * bhnd / 1e9))


def test_perfbench_counts_kerple_op_bounds():
    b = kerple.op_least_seconds(CONFIG, MIX, PEAK)
    nn, bhn, F, D = 2 * 2 * 25, 2 * 2 * 5, 5, 4
    coeffs = 4 * 2 * 9
    fwd = max(2 * nn * (F + D) / 1e12, (2 * bhn * (2 * F + 2 * D) + coeffs) / 1e9)
    # backward: A = q'k'^T again (F), M = g v^T (D), dv (D), dq' (F), dk' (F)
    bwd = max(2 * nn * (F + D + D + F + F) / 1e12,
              (2 * bhn * (2 * F + 2 * D) + 2 * bhn * (2 * F + D) + 2 * coeffs) / 1e9)
    assert b["forward"] == pytest.approx(fwd)
    assert b["backward"] == pytest.approx(bwd)


@pytest.mark.parametrize("metric, group, attention", [
    ("kerple_roofline.train", "kerple", "kerple"),
    ("flash_roofline.train", "flash", "softmax"),
])
def test_perfbench_roofline_reads_shapes_not_kernel_names(monkeypatch, metric, group,
                                                          attention):
    """The bound is the same whatever the kernel groups hold; only the
    measured time of the group divides it."""
    run = {"config": dict(CONFIG, attention=attention), "mix": MIX, "peak": PEAK}
    least = spec.counts(attention).op_least_seconds(run["config"], MIX, PEAK)
    reader = spec.reader(metric)
    kernel = {"kerple": "mlc_fwd_mma_kernel<272>", "flash": "flash_fwd_mma_kernel<64>"}[group]
    first = reader.read(Trace(window_s=1.0, busy_s=1.0, steps=10, kernels={kernel: 1e-3}), run)
    assert first == pytest.approx(100.0 * 10 * (least["forward"] + least["backward"]) / 1e-3)
    monkeypatch.setattr(spec, "kernel_groups", lambda: [{"name": group,
                                                         "patterns": ["renamed_"]}])
    assert spec.counts(attention).op_least_seconds(run["config"], MIX, PEAK) == least
    assert reader.read(Trace(1.0, 1.0, 10, {"renamed_kernel": 1e-3}), run) == first
    assert reader.read(Trace(1.0, 1.0, 10, {kernel: 1.0}), run) is None


def test_perfbench_counts_import_no_kernel_names():
    for module in (vit, softmax, kerple):
        source = open(module.__file__).read()
        assert "kernel_groups" not in source and "efficient_rpe_vit" not in source
