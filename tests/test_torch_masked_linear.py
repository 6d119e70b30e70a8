"""The port's materialised-T KERPLE op (`ops/kernels/masked_linear.py`) and
its `pallas_ab` entry point on the CPU.

On CPU tensors every wrapper runs its kernel's plain version; here they are
held against the JAX package's Pallas kernels run in interpret mode, as
tests/test_pallas_kernels.py runs them (`fused_masked_linear_attention(...,
128, 128, True)`, `masked_linear_bwd(..., interpret=True)`), and the
autograd op against `jax.grad` of the JAX op under the matching
`MASKED_LINEAR_BWD_MODE` (set and restored as that file does). The CUDA
kernels are compared with the same plain versions on the GPU by
chip_smoke.py (phase 3f).

Tolerances: fp32 rtol/atol 1e-5 for the forward and gradients (atol scaled
by the tensor's largest value: only the summation order differs). bf16:
both sides round W (and the output) to bf16 from fp32 sums taken in another
order, so the port is held against the JAX fp32 result and its error must
stay within BF16_ERROR_FACTOR of the JAX bf16 op's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_rpe_vit_tpu.ops.pallas import attention_kernels as ak
from efficient_rpe_vit_tpu.ops.pallas.masked_linear_bwd import masked_linear_bwd as jax_bwd
from efficient_rpe_vit_torch.experiments import pallas_ab
from efficient_rpe_vit_torch.ops.kernels import masked_linear as ml

torch.set_num_threads(2)

TOL = 1e-5
BF16_ERROR_FACTOR = 2.0
SHAPES = [(2, 2, 197, 44, 16), (3, 2, 17, 44, 16)]
IDS = ["N197", "N17"]


def _inputs(seed, B, H, N, F, D):
    """q', k' = |normal| x 0.1, v and the cotangent normal, T = the Toeplitz
    matrix of exp(0.02 normal) coefficients, all fp32 numpy."""
    rng = np.random.default_rng(seed)
    qp = np.abs(rng.normal(size=(B, H, N, F))).astype(np.float32) * 0.1
    kp = np.abs(rng.normal(size=(B, H, N, F))).astype(np.float32) * 0.1
    v = rng.normal(size=(B, H, N, D)).astype(np.float32)
    g = rng.normal(size=(B, H, N, D)).astype(np.float32)
    coeffs = np.exp(rng.normal(size=(H, 2 * N - 1)) * 0.02).astype(np.float32)
    idx = np.arange(N)
    t = np.ascontiguousarray(coeffs[:, idx[None, :] - idx[:, None] + N - 1])
    return qp, kp, v, t, g


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def _jax_grads(qp, kp, v, t, mode, argnums=(0, 1, 2, 3)):
    old = ak.MASKED_LINEAR_BWD_MODE
    try:
        ak.MASKED_LINEAR_BWD_MODE = mode
        return jax.grad(lambda *a: jnp.sum(
            ak.fused_masked_linear_attention(*a, 128, 128, True) ** 2),
            argnums=argnums)(*(jnp.asarray(a) for a in (qp, kp, v, t)))
    finally:
        ak.MASKED_LINEAR_BWD_MODE = old


def _port_grads(qp, kp, v, t, mode, need_t=True):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (qp, kp, v)]
    tt = torch.from_numpy(t).requires_grad_(need_t)
    out = ml.fused_masked_linear_attention(*leaves, tt, bwd_mode=mode)
    (out ** 2).sum().backward()
    return [x.grad for x in leaves] + [tt.grad]


# ─── forward ────────────────────────────────────────────────────────────

@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_forward_matches_jax_kernel_fp32(shape):
    qp, kp, v, t, _ = _inputs(0, *shape)
    out, den = ml.masked_linear_fwd(*(torch.from_numpy(a) for a in (qp, kp, v, t)))
    j_args = [jnp.asarray(a) for a in (qp, kp, v, t)]
    j_out, j_den = ak._masked_linear_fwd_impl(*j_args, block_q=128, block_kv=128,
                                              interpret=True)
    assert out.dtype == torch.float32 and den.shape == shape[:3]
    _close(out, j_out)
    _close(den, j_den)
    _close(ml.masked_linear_fwd_reference(*(torch.from_numpy(a) for a in (qp, kp, v, t)))[0],
           ak.fused_masked_linear_attention(*j_args, 128, 128, True))


def test_plain_forward_bf16_within_the_jax_bf16_error():
    qp, kp, v, t, _ = _inputs(1, *SHAPES[0])
    ref = np.asarray(ak.fused_masked_linear_attention(
        *(jnp.asarray(a) for a in (qp, kp, v, t)), 128, 128, True))
    j16 = ak.fused_masked_linear_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (qp, kp, v)), jnp.asarray(t),
        128, 128, True)
    out, den = ml.masked_linear_fwd(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (qp, kp, v)), torch.from_numpy(t))
    assert out.dtype == torch.bfloat16 and den.dtype == torch.float32
    jax_err = np.abs(np.asarray(j16.astype(jnp.float32)) - ref).max()
    port_err = np.abs(out.float().numpy() - ref).max()
    assert 0 < jax_err < 0.05
    assert port_err <= BF16_ERROR_FACTOR * jax_err, (port_err, jax_err)


def test_bf16_t_is_read_in_fp32():
    qp, kp, v, t, _ = _inputs(2, *SHAPES[1])
    args = [torch.from_numpy(a) for a in (qp, kp, v)]
    t16 = torch.from_numpy(t).to(torch.bfloat16)
    out, den = ml.masked_linear_fwd(*args, t16)
    want, want_den = ml.masked_linear_fwd(*args, t16.float())
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(den, want_den, rtol=0, atol=0)


# ─── backward ───────────────────────────────────────────────────────────

@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_backward_matches_jax_kernels(shape):
    """dq', dk', dv, dT of the backward (each kernel's plain version) against
    the JAX backward kernels fed the same den, out and g."""
    qp, kp, v, t, g = _inputs(3, *shape)
    targs = [torch.from_numpy(a) for a in (qp, kp, v, t)]
    out, den = ml.masked_linear_fwd(*targs)
    got = ml.masked_linear_bwd(*targs, den, out, torch.from_numpy(g))
    want = jax_bwd(*(jnp.asarray(a) for a in (qp, kp, v, t)), jnp.asarray(den.numpy()),
                   jnp.asarray(out.numpy()), jnp.asarray(g), block_q=128, block_kv=128,
                   interpret=True)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b)
    # the residual formula (bwd_mode 'jnp_residual') is the same function
    for a, b in zip(ml.masked_linear_bwd_reference(*targs, den, out, torch.from_numpy(g)), got):
        _close(a, b)


@pytest.mark.parametrize("mode", ["pallas", "jnp_residual"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_autograd_op_matches_jax_grad(shape, mode):
    qp, kp, v, t, _ = _inputs(4, *shape)
    got = _port_grads(qp, kp, v, t, mode)
    want = _jax_grads(qp, kp, v, t, mode)
    for a, b in zip(got, want):
        _close(a, b)


def test_auto_is_pallas():
    qp, kp, v, t, _ = _inputs(5, *SHAPES[1])
    for a, b in zip(_port_grads(qp, kp, v, t, "auto"), _port_grads(qp, kp, v, t, "pallas")):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("need_t", [False, True])
def test_dt_only_when_t_needs_a_gradient(monkeypatch, need_t):
    calls = []
    real = ml.masked_linear_bwd_dt

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(ml, "masked_linear_bwd_dt", spy)
    qp, kp, v, t, _ = _inputs(6, *SHAPES[1])
    grads = _port_grads(qp, kp, v, t, "pallas", need_t=need_t)
    assert len(calls) == int(need_t)
    assert (grads[3] is not None) == need_t
    assert all(x is not None for x in grads[:3])


# ─── input checks ───────────────────────────────────────────────────────

def _args(dtype=torch.float32):
    qp, kp, v, t, g = (torch.from_numpy(a) for a in _inputs(7, 1, 2, 9, 8, 4))
    return [qp.to(dtype), kp.to(dtype), v.to(dtype), t], g.to(dtype)


def _bad_forward_inputs():
    cases = {}
    a, _ = _args()
    a[3] = a[3][:, :-1]
    cases["T shape"] = (a, ValueError)
    a, _ = _args()
    a[3] = a[3].half()
    cases["T dtype"] = (a, TypeError)
    a, _ = _args()
    a[3] = a[3].transpose(1, 2)
    cases["T not contiguous"] = (a, ValueError)
    a, _ = _args()
    a[3] = a[3].to("meta")
    cases["T on another device"] = (a, ValueError)
    a, _ = _args()
    a[1] = a[1].to(torch.bfloat16)
    cases["mixed dtypes"] = (a, TypeError)
    a, _ = _args()
    a[2] = a[2][:, :, :-1]
    cases["v length"] = (a, ValueError)
    return cases


@pytest.mark.parametrize("case", list(_bad_forward_inputs()))
def test_forward_rejects_malformed_inputs(case):
    args, exc = _bad_forward_inputs()[case]
    with pytest.raises(exc):
        ml.masked_linear_fwd(*args)
    with pytest.raises(exc):
        ml.fused_masked_linear_attention(*args)


def test_backward_and_op_reject_malformed_inputs():
    a, g = _args()
    out, den = ml.masked_linear_fwd(*a)
    with pytest.raises(ValueError):
        ml.masked_linear_bwd(*a, den.double(), out, g)
    with pytest.raises(ValueError):
        ml.masked_linear_bwd(*a, den, out, g[..., :-1])
    gn, s = torch.zeros_like(g), torch.zeros(g.shape[:3])
    with pytest.raises(TypeError):
        ml.masked_linear_bwd_dq(gn, s, a[2], a[1], a[3].to(torch.bfloat16))
    with pytest.raises(ValueError):
        ml.fused_masked_linear_attention(*a, bwd_mode="fused")


# ─── the pallas_ab entry point ──────────────────────────────────────────

def test_pallas_ab_entry_point_on_cpu(capsys):
    pallas_ab.main(["--device", "cpu", "--shape", "2", "2", "17", "8", "4", "--steps", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu")
    assert lines[1].startswith("B=2 H=2 N=17 F=8 D=4:")
    for row in pallas_ab.ROWS:
        assert f" {row}=" in lines[1]


def test_pallas_ab_launches_by_row_on_cpu():
    """CPU wrappers take their plain versions and count nothing; the rows
    run in order and every time is positive."""
    launches = {}
    rows = pallas_ab.bench_shape(1, 2, 9, 8, 4, steps=2, device="cpu", launches=launches)
    assert list(rows) == list(pallas_ab.ROWS) == list(launches)
    assert all(sec > 0 for sec in rows.values())
    assert all(n == 0 for ran in launches.values() for n in ran.values())


def test_pallas_ab_needs_a_gpu_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pallas_ab.main(["--shape", "1", "2", "9", "8", "4"])


# ─── utils/timing.py, which the entry point times with ──────────────────

@pytest.mark.parametrize("seconds", [0.25, 59.9, 61.0, 3599.0, 3725.5])
def test_format_time_matches_jax(seconds):
    from efficient_rpe_vit_tpu.utils.timing import format_time as jax_format_time
    from efficient_rpe_vit_torch.utils.timing import format_time

    assert format_time(seconds) == jax_format_time(seconds)


def test_timing_helpers_on_cpu():
    from efficient_rpe_vit_torch.utils import timing

    x = torch.tensor([[-1.0, 2.0], [3.0, -4.0]])
    assert timing.fetch_barrier((x, {"y": [x.to(torch.bfloat16)]})) == 20.0
    assert timing.device_memory_stats("cpu") == {}
    calls = []
    sec = timing.chained_time(lambda a: calls.append(a) or a + 1, (x,), steps=3,
                              feedback=lambda cur, out: (out,), repeats=3)
    assert sec > 0 and len(calls) == 1 + 3 * 3
    assert timing.device_label(torch.device("cpu")).startswith("cpu")
