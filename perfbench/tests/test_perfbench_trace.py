"""The traced window's reduction and the per-layer readers, on synthetic
events."""

import pytest

from perfbench import spec
from perfbench.trace import reduce_events

MS = 1_000_000  # ns


def _events():
    host = [("perfbench.window", 0, 100 * MS), ("perfbench.call", 10 * MS, 12 * MS),
            ("perfbench.wait", 50 * MS, 60 * MS)]
    device = [("mlc_fwd_mma_kernel<272>", 5 * MS, 30 * MS),
              ("nvjet_tst_192x192", 20 * MS, 40 * MS),           # overlaps the first
              ("vectorized_elementwise_kernel", 55 * MS, 70 * MS),
              ("flash_bwd_dq_mma_kernel", 95 * MS, 120 * MS),    # cut at the window's end
              ("before the window", -20 * MS, -10 * MS)]
    return device, host


def test_perfbench_busy_groups_and_gaps():
    t = reduce_events(*_events(), steps=4)
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx((40 - 5 + 15 + 5) * 1e-3)
    assert t.group_s("kerple") == pytest.approx(0.025)
    assert t.group_s("gemm") == pytest.approx(0.020)
    assert t.group_s("flash") == pytest.approx(0.005)
    gaps = dict((round(s * 1e3), n) for n, s in t.gaps)
    assert gaps == {5: "perfbench.window", 15: "perfbench.window", 25: "perfbench.window"}
    b = t.breakdown()
    assert b["device_ops"][0] == ["mlc_fwd_mma_kernel<272>", pytest.approx(0.025)]
    assert len(b["idle_gaps"]) == 3


def test_perfbench_gap_named_by_innermost_span():
    device, host = _events()
    host.append(("perfbench.close", 70 * MS, 95 * MS))
    t = reduce_events(device, host, steps=1)
    assert ("perfbench.close", pytest.approx(0.025)) in [(n, s) for n, s in t.gaps]


def test_perfbench_no_window_no_trace():
    device, host = _events()
    assert reduce_events(device, host[1:], steps=1) is None


def test_perfbench_readers():
    t = reduce_events(*_events(), steps=4)
    run = {"config": spec.load_json(spec.config_file("vit-b16-kerple")),
           "mix": spec.load_json(spec.mix_file("train-1024px-b4-k4")),
           "peak": spec.peaks()["NVIDIA H100 80GB HBM3"]}
    run["counts"] = spec.counts("kerple")
    idle = spec.reader("device_idle_pct.train").read(t, run)
    assert idle == pytest.approx(45.0)
    assert spec.reader("gemm_ms_per_step.train").read(t, run) == pytest.approx(5.0)
    assert spec.reader("pointwise_ms_per_step.train").read(t, run) == pytest.approx(15 / 4)
    mfu = spec.reader("step_mfu.train").read(t, run)
    assert mfu == pytest.approx(100 * 4 * run["counts"].train_flops_per_step(
        run["config"], run["mix"]) / 0.1 / 989e12)
    assert spec.reader("kerple_roofline.train").read(t, run) > 0
    empty = reduce_events([], _events()[1], steps=4)
    for name in ("device_idle_pct.train", "gemm_ms_per_step.train",
                 "pointwise_ms_per_step.train", "kerple_roofline.train",
                 "flash_roofline.train"):
        assert spec.reader(name).read(empty, run) is None
