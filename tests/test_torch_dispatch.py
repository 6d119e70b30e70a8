"""The port's `auto` dispatch against the JAX package's, on the CPU.

With the JAX package's constants patched into the port, every rule decides
as the JAX package does on a grid of (b, h, n, d) that holds every shape of
tests/test_attention_core.py's flash-dispatch test: softmax
(`softmax_needs_flash`, and the arm `auto` runs, return_attention
included), KERPLE (`kerple_arm` against the arm JAX `kerple_linear_attention`
picks), the materialised-T backward (`masked_linear_bwd_mode` against
`_masked_linear_bwd_wants_pallas`, with the port's time crossover moved past
every N, since JAX has none), the Toeplitz window and the rotation's
`prefer_kernel`. JAX's `_pallas_ok()` is False on the CPU, so the JAX arm
is read with it patched to True and with its arms stubbed to return their
names: the decision functions are compared, not the arms JAX would run
here. Nothing in the JAX package is edited.

With the port's own constants, the rules bracket the H100 rows of PERF.md
that set them. `auto` equals the arm its rule names bit for bit on CPU
tensors; return_attention past the budget raises; the default-config
flagship and `baseline` export under a symbolic batch on either side of
their wall and give the live model's logits; and each dispatch experiment
runs with `--device cpu` at a tiny shape and prints its JSON rows.
"""

import itertools
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from efficient_rpe_vit_tpu.ops import attention_core as jax_core
from efficient_rpe_vit_tpu.ops import fft_toeplitz as jax_fft
from efficient_rpe_vit_tpu.ops import rotations as jax_rot
from efficient_rpe_vit_tpu.ops.pallas import attention_kernels as jax_kernels
from efficient_rpe_vit_torch.configs import mnist_config
from efficient_rpe_vit_torch.models import create_model
from efficient_rpe_vit_torch.models.attention import rotation_prefers_kernel
from efficient_rpe_vit_torch.ops import attention_core, fft_toeplitz, rotations
from efficient_rpe_vit_torch.ops.kernels import flash_attention as fa
from efficient_rpe_vit_torch.ops.kernels import masked_linear as ml
from efficient_rpe_vit_torch.ops.kernels import masked_linear_coeffs as mlc
from efficient_rpe_vit_torch.serve import export_forward

torch.set_num_threads(2)

# every shape of tests/test_attention_core.py's flash-dispatch test, as (b, h, n)
JAX_TEST_SHAPES = [(8, 2, 197), (256, 2, 197), (32, 12, 577), (24, 12, 785),
                   (16, 12, 1025), (8, 12, 2026), (8, 8, 4096), (1, 8, 16384),
                   (64, 8, 4096), (8, 8, 2048)]
GRID_B = (1, 2, 8, 16, 24, 32, 64, 256)
GRID_H = (1, 2, 8, 12)
GRID_N = (5, 17, 127, 128, 197, 256, 511, 512, 577, 767, 768, 785, 1025, 2026,
          4096, 4097, 8191, 8192, 16384)
GRID_D = (16, 44, 64, 127, 128, 266)
GRID = sorted({(b, h, n) for b, h, n in itertools.product(GRID_B, GRID_H, GRID_N)}
              | set(JAX_TEST_SHAPES))
PORT_CONSTANTS = [(attention_core, name) for name in (
    "FLASH_MIN_N", "SOFTMAX_DENSE_MEMORY_BUDGET", "KERPLE_DENSE_CROSSOVER_N",
    "KERPLE_DENSE_MEMORY_BUDGET")] + [(fft_toeplitz, name) for name in (
        "FFT_MIN_N", "FFT_MAX_N", "FFT_MAX_D")]


@pytest.fixture
def jax_constants(monkeypatch):
    """The JAX package's constants in the port (and no time crossover for
    the materialised-T backward, which JAX keeps on the residual formula
    below its budget at every N); the linear modules' rotation as JAX calls
    it (no `prefer_kernel`); JAX's Pallas taken as available."""
    for module, name in PORT_CONSTANTS:
        source = jax_core if module is attention_core else jax_fft
        monkeypatch.setattr(module, name, getattr(source, name))
    monkeypatch.setattr(ml, "MASKED_LINEAR_BWD_CROSSOVER_N", 1 << 62)
    monkeypatch.setattr(rotations, "KERNEL_BEFORE_PHI", False)
    monkeypatch.setattr(jax_core, "_pallas_ok", lambda: True)
    assert jax_rot.USE_PALLAS_ROTATION == "auto"


def _shaped(*shape):
    return SimpleNamespace(shape=shape, ndim=len(shape))


def _jax_kerple_arm(monkeypatch, b, h, n):
    for arm in ("pallas", "dense", "fft"):
        monkeypatch.setattr(jax_core, f"_kerple_{arm}", lambda *a, arm=arm: arm)
    return jax_core.kerple_linear_attention(_shaped(b, h, n, 8), None, None, None,
                                            method="auto")


def _jax_toeplitz_arm(monkeypatch, n, d):
    monkeypatch.setattr(jax_fft, "toeplitz_matmul_dense", lambda c, x: "dense")
    monkeypatch.setattr(jax_fft, "toeplitz_matmul_fft", lambda c, x: "fft")
    return jax_fft.toeplitz_matmul(_shaped(2, 2 * n - 1), _shaped(2, n, d), method="auto")


def _jax_softmax_arm(b, h, n, return_attention):
    """The arm JAX's softmax_attention runs (with Pallas available and a
    concrete batch), 'raises' past the budget with return_attention."""
    if jax_core.softmax_needs_flash(b, h, n) and not return_attention:
        return "flash"
    if return_attention and jax_core._dense_softmax_busts_budget(_shaped(b, h, n, 64)):
        return "raises"
    return "dense"


def _port_softmax_arm(b, h, n, return_attention):
    try:
        return attention_core.softmax_arm("auto", b, h, n, return_attention)
    except NotImplementedError:
        return "raises"


def test_softmax_rules_equal_jax(jax_constants):
    for b, h, n in GRID:
        assert attention_core.softmax_needs_flash(b, h, n) == jax_core.softmax_needs_flash(b, h, n)
        for ra in (False, True):
            assert _port_softmax_arm(b, h, n, ra) == _jax_softmax_arm(b, h, n, ra), (b, h, n, ra)
    # the JAX test's decisions, read through the port
    assert not attention_core.softmax_needs_flash(32, 12, 577)
    assert attention_core.softmax_needs_flash(24, 12, 785)
    assert attention_core.softmax_needs_flash(8, 8, 4096)


def test_kerple_rule_equals_jax(jax_constants, monkeypatch):
    for b, h, n in GRID:
        assert attention_core.kerple_arm(b, h, n) == _jax_kerple_arm(monkeypatch, b, h, n), (b, h, n)


def test_bwd_mode_rule_equals_jax(jax_constants):
    for b, h, n in GRID:
        wants = jax_kernels._masked_linear_bwd_wants_pallas(b, h, n)
        assert ml.masked_linear_bwd_mode(b, h, n) == ("pallas" if wants else "jnp_residual")


def test_toeplitz_window_equals_jax(jax_constants, monkeypatch):
    for n, d in itertools.product(GRID_N, GRID_D):
        want = _jax_toeplitz_arm(monkeypatch, n, d)
        assert ("fft" if fft_toeplitz.fft_window(n, d) else "dense") == want, (n, d)


def test_rotation_prefer_equals_jax(jax_constants):
    """Softmax: JAX's `prefer` (models/attention.py:99-112) with no seq_mesh
    and a concrete batch, then the rule; linear attention passes none in
    JAX. A seq_mesh turns it off in both; a symbolic batch turns it off in
    JAX only (its Pallas grids are static; the port's op exports at any
    batch), so the grid's batches are concrete."""
    for (b, h, n), ra in itertools.product(GRID, (False, True)):
        arm = _port_softmax_arm(b, h, n, ra)
        if arm == "raises":
            continue
        jax_prefer = not ra and jax_core.softmax_needs_flash(b, h, n)
        port = rotation_prefers_kernel(None, arm == "flash")
        assert port == jax_prefer, (b, h, n, ra)
        jax_arm = "pallas" if jax_rot.rotation_kernel_enabled(jax_prefer) else "chain"
        assert rotations._resolve("auto", port) == jax_arm
        assert not rotation_prefers_kernel("mesh", arm == "flash")
    assert not rotation_prefers_kernel(None, rotations.KERNEL_BEFORE_PHI)
    assert rotations._resolve("auto", True) == "pallas"
    assert rotations._resolve("auto", False) == "chain"
    assert rotations._resolve("chain", True) == "chain"
    assert rotations._resolve("pallas", False) == "pallas"


# ─── the port's constants bracket the H100 rows that set them ───────────
# PERF.md §6 "Dispatch on the H100" (NVIDIA H100 80GB HBM3, 700.00 W):
# (N, batch, heads) of each model-level row; in every one the kernel arm
# won or tied within its chains' spread, none had the dense arm ahead
FLASH_ROWS = [(5, 512, 12), (17, 256, 12), (65, 192, 12), (197, 64, 12), (577, 32, 12),
              (785, 24, 12), (1025, 16, 12), (5, 32, 2), (17, 32, 2), (197, 256, 2)]
KERPLE_ROWS = [(5, 512, 12), (17, 256, 12), (65, 192, 12), (197, 64, 12), (1025, 16, 12),
               (5, 32, 2), (17, 32, 2), (197, 256, 2)]
ROTATION_ROWS = [(197, 64, 12), (4097, 4, 12)]
# ([B, H, N, d] of the Toeplitz product, the faster arm)
TOEPLITZ_ROWS = [((8, 2, n, 44), "dense") for n in (197, 256, 512, 1024)] + \
    [((8, 2, n, 44), "fft") for n in (2048, 4096)] + \
    [((2, 12, n, 266), "dense") for n in (197, 256, 512, 1024)] + \
    [((2, 12, n, 266), "fft") for n in (2048, 4096)]
# (B, H, N) of each materialised-T backward row: the kernels won every one
BWD_ROWS = [(256, 2, 197), (8, 2, 1024), (32, 4, 512), (4, 12, 4097)]
# the walls: (N, largest batch that fit, first batch out of memory), ViT-B heads
SOFTMAX_WALLS = [(1025, 48, 64), (4097, 3, 4)]
KERPLE_WALLS = [(1025, 96, 128), (4097, 8, 12)]


def test_own_constants_bracket_the_h100_rows():
    for n, b, h in FLASH_ROWS:
        assert attention_core.softmax_needs_flash(b, h, n)
        assert attention_core.softmax_arm("auto", b, h, n) == "flash"
    for n, b, h in KERPLE_ROWS:
        assert attention_core.kerple_arm(b, h, n) == "pallas"
    for n, b, h in ROTATION_ROWS:
        assert rotation_prefers_kernel(None, attention_core.softmax_arm("auto", b, h, n)
                                       == "flash")
        assert rotation_prefers_kernel(None, rotations.KERNEL_BEFORE_PHI)
    for (b, h, n, d), arm in TOEPLITZ_ROWS:
        assert ("fft" if fft_toeplitz.fft_window(n, d) else "dense") == arm, (n, d)
    for walls, temps, budget in ((SOFTMAX_WALLS, 3, attention_core.SOFTMAX_DENSE_MEMORY_BUDGET),
                                 (KERPLE_WALLS, 5, attention_core.KERPLE_DENSE_MEMORY_BUDGET)):
        count = lambda n, b: temps * b * 12 * n * n * 4  # noqa: E731
        # the budget is the smallest count that fit; every count that did
        # not fit lies past it
        assert budget == min(count(n, fit) for n, fit, _ in walls)
        assert all(count(n, fail) > budget for n, _, fail in walls)
    assert attention_core._dense_softmax_busts_budget(4, 12, 4097)
    for b, h, n in BWD_ROWS:
        assert ml.masked_linear_bwd_mode(b, h, n) == "pallas", (b, h, n)


# ─── `auto` is the named arm, bit for bit, on CPU tensors ───────────────

def _normal(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


@pytest.mark.parametrize("side", ["below", "past"])
def test_softmax_auto_is_the_named_arm(side, monkeypatch):
    q, k, v = (_normal(2, 2, 17, 16, seed=s) for s in range(3))
    monkeypatch.setattr(attention_core, "FLASH_MIN_N", 18 if side == "below" else 17)
    named = "dense" if side == "below" else "flash"
    assert attention_core.softmax_arm("auto", 2, 2, 17) == named
    auto = attention_core.softmax_attention(q, k, v, 0.25, dropout_rate=0.1, dropout_seed=3)
    want = attention_core.softmax_attention(q, k, v, 0.25, dropout_rate=0.1, dropout_seed=3,
                                            method=named)
    assert torch.equal(auto, want)


@pytest.mark.parametrize("side", ["below", "past"])
def test_kerple_auto_is_the_named_arm(side, monkeypatch):
    qp, kp = (_normal(2, 2, 17, 8, seed=s).abs() for s in range(2))
    v, c = _normal(2, 2, 17, 4, seed=2), _normal(2, 33, seed=3).exp()
    crossover = 18 if side == "below" else 17
    monkeypatch.setattr(attention_core, "KERPLE_DENSE_CROSSOVER_N", crossover)
    monkeypatch.setattr(attention_core, "KERPLE_DENSE_MEMORY_BUDGET", 1 << 40)
    named = "dense" if side == "below" else "pallas"
    assert attention_core.kerple_arm(2, 2, 17) == named

    def run(method):
        leaves = [x.clone().requires_grad_() for x in (qp, kp, v, c)]
        out = attention_core.kerple_linear_attention(*leaves, method=method)
        return (out, *torch.autograd.grad((out ** 2).sum(), leaves))

    for a, b in zip(run("auto"), run(named)):
        assert torch.equal(a, b)
    # the byte wall alone turns the kernel on
    monkeypatch.setattr(attention_core, "KERPLE_DENSE_CROSSOVER_N", 1 << 20)
    monkeypatch.setattr(attention_core, "KERPLE_DENSE_MEMORY_BUDGET", 5 * 2 * 2 * 17 * 17 * 4 - 1)
    assert attention_core.kerple_arm(2, 2, 17) == "pallas"


@pytest.mark.parametrize("side", ["below", "past"])
def test_masked_linear_auto_backward_is_the_named_mode(side, monkeypatch):
    qp, kp = (_normal(2, 2, 17, 8, seed=s).abs() for s in range(2))
    v = _normal(2, 2, 17, 4, seed=2)
    t = _normal(2, 17, 17, seed=3).exp()
    count = 5 * 2 * 2 * 17 * 17 * 4
    monkeypatch.setattr(ml, "MASKED_LINEAR_BWD_CROSSOVER_N", 18)
    monkeypatch.setattr(attention_core, "KERPLE_DENSE_MEMORY_BUDGET",
                        count if side == "below" else count - 1)
    named = "jnp_residual" if side == "below" else "pallas"
    assert ml.masked_linear_bwd_mode(2, 2, 17) == named

    def grads(mode):
        leaves = [x.clone().requires_grad_() for x in (qp, kp, v, t)]
        out = ml.fused_masked_linear_attention(*leaves, bwd_mode=mode)
        return torch.autograd.grad((out ** 2).sum(), leaves)

    for a, b in zip(grads("auto"), grads(named)):
        assert torch.equal(a, b)
    # the time crossover alone turns the kernels on
    monkeypatch.setattr(ml, "MASKED_LINEAR_BWD_CROSSOVER_N", 17)
    assert ml.masked_linear_bwd_mode(2, 2, 17) == "pallas"


@pytest.mark.parametrize("side", ["inside", "outside"])
def test_toeplitz_auto_is_the_named_arm(side, monkeypatch):
    c, x = _normal(2, 33, seed=0), _normal(2, 17, 5, seed=1)
    monkeypatch.setattr(fft_toeplitz, "FFT_MIN_N", 17 if side == "inside" else 18)
    monkeypatch.setattr(fft_toeplitz, "FFT_MAX_N", 64)
    monkeypatch.setattr(fft_toeplitz, "FFT_MAX_D", 6)
    named = "fft" if side == "inside" else "dense"
    assert torch.equal(fft_toeplitz.toeplitz_matmul(c, x),
                       fft_toeplitz.toeplitz_matmul(c, x, method=named))


@pytest.mark.parametrize("prefer", [True, False])
def test_rotation_auto_is_the_named_arm(prefer):
    q, k = (_normal(2, 2, 17, 16, seed=s).to(torch.bfloat16) for s in range(2))
    pos, coeffs = rotations.grid_positions_2d(16), _normal(2, 2, 16, seed=2, scale=0.1)
    named = "pallas" if prefer else "chain"
    auto = rotations.apply_circulant_string(q, k, pos, coeffs, prefer_kernel=prefer)
    want = rotations.apply_circulant_string(q, k, pos, coeffs, method=named)
    for a, b in zip(auto, want):
        assert torch.equal(a, b)


def test_return_attention_past_the_budget_raises(monkeypatch):
    q, k, v = (_normal(2, 2, 17, 16, seed=s) for s in range(3))
    monkeypatch.setattr(attention_core, "SOFTMAX_DENSE_MEMORY_BUDGET", 3 * 2 * 2 * 17 * 17 * 4)
    out, attn = attention_core.softmax_attention(q, k, v, 0.25, return_attention=True)
    assert attn.shape == (2, 2, 17, 17)
    monkeypatch.setattr(attention_core, "SOFTMAX_DENSE_MEMORY_BUDGET", 3 * 2 * 2 * 17 * 17 * 4 - 1)
    with pytest.raises(NotImplementedError, match="return_attention"):
        attention_core.softmax_attention(q, k, v, 0.25, return_attention=True)
    # the explicit dense arm keeps its behaviour
    attention_core.softmax_attention(q, k, v, 0.25, return_attention=True, method="dense")
    model = create_model("baseline", mnist_config(depth=1, dropout=0.0), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="return_attention"):
        model(_normal(2, 28, 28, 1), return_attention=True)


# ─── exports under a symbolic batch on either side of the wall ──────────

EXPORT_CASES = {"flagship": ("performer_favor_most_general", "KERPLE_DENSE_CROSSOVER_N",
                             mlc.masked_linear_attention_coeffs_fwd,
                             "efficient_rpe_vit.masked_linear_attention_coeffs_fwd.default"),
                "baseline": ("baseline", "FLASH_MIN_N", fa.flash_attention_fwd,
                             "efficient_rpe_vit.flash_attention_fwd.default")}


@pytest.mark.parametrize("side", ["below", "past"])
@pytest.mark.parametrize("case", sorted(EXPORT_CASES))
def test_default_model_exports_on_either_side_of_the_wall(case, side, monkeypatch):
    """Under `torch.export.Dim("b")` the byte count is symbolic and counts as
    below the budget (as JAX counts it), so the wall is moved by the N
    constant: N = 17 below it takes the dense arm, past it the kernel op,
    both with the live model's logits at batches 1 and 3."""
    name, constant, _, op = EXPORT_CASES[case]
    monkeypatch.setattr(attention_core, constant, 18 if side == "below" else 17)
    monkeypatch.setattr(attention_core, "KERPLE_DENSE_MEMORY_BUDGET", 1 << 40)
    monkeypatch.setattr(attention_core, "SOFTMAX_DENSE_MEMORY_BUDGET", 1 << 40)
    model = create_model(name, mnist_config(depth=2, dropout=0.0), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    exported = export_forward(model, image_size=28, in_channels=1, device="cpu")
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets.count(op) == (0 if side == "below" else 2)
    served = exported.module()
    for batch in (1, 3):
        x = _normal(batch, 28, 28, 1, seed=batch)
        with torch.inference_mode():
            torch.testing.assert_close(served(x), model(x), atol=1e-5, rtol=1e-5)


# ─── the dispatch experiments on the CPU ────────────────────────────────

TINY = ["--device", "cpu", "--steps", "1"]
TINY_MODEL = TINY + ["--width", "32", "1", "2", "64", "--shape", "8", "2", "2"]
EXPERIMENTS = {
    "crossover_ab": (TINY + ["--sizes", "17", "--toeplitz", "2", "2", "8"],
                     lambda r: [set(r["kerple"][0]["fwd_ms"]), set(r["toeplitz"][0]["ms"])],
                     [{"dense", "fft", "pallas"}, {"dense", "fft"}]),
    "flash_ab": (TINY + ["--sizes", "17", "--batch", "2", "--heads", "2", "--head-dim", "16"],
                 lambda r: [set(r["rows"][0]["grad_ms"])], [{"dense", "flash"}]),
    "flash_crossover": (TINY_MODEL, None, ["dense", "flash"]),
    "kerple_pallas_ab": (TINY_MODEL, None, ["dense", "pallas"]),
    "rotation_kernel_ab": (TINY_MODEL + ["--variants", "baseline_circulant"], None,
                           ["chain", "pallas"]),
    "rot_isolated_ab": (TINY + ["--shape", "2", "2", "17", "16"],
                        lambda r: [set(r["rows"][0]["fwd_ms"])], [{"chain", "kernel"}]),
    "fused_phi_ab": (TINY_MODEL + ["--variants", "performer_favor_most_general"], None,
                     ["unfused_phi", "fused_phi"]),
    "chain_dtype_ab": (TINY_MODEL + ["--variants", "performer_favor_circulant"], None,
                       ["fp32", "indtype"]),
    "scaling_ab": (TINY + ["--sizes", "16", "--token-budget", "32", "--wall-images", "8",
                           "--wall-max", "2", "--width", "32", "1", "2", "64"],
                   lambda r: [set(r["rows"][0]["grad_ms"]), len(r["walls"])],
                   [{"softmax_dense", "softmax_flash", "linear"}, 2]),
}


def _finite(value) -> bool:
    if isinstance(value, dict):
        return all(_finite(v) for v in value.values())
    if isinstance(value, list):
        return all(_finite(v) for v in value)
    if isinstance(value, float):
        return np.isfinite(value)
    return True


@pytest.mark.parametrize("name", sorted(EXPERIMENTS))
def test_experiment_runs_on_the_cpu(name, capsys):
    import importlib

    argv, read, want = EXPERIMENTS[name]
    module = importlib.import_module(f"efficient_rpe_vit_torch.experiments.{name}")
    module.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu")
    result = json.loads(lines[-1])
    assert result["experiment"] == name and _finite(result)
    if read is None:  # a model-level A/B: both arms' rows, with their losses
        row = result["rows"][0]
        for arm in want:
            assert row[arm]["step_ms"] > 0 and np.isfinite(row[arm]["loss"])
    else:
        assert read(result) == want
