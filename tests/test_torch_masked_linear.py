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


def _inputs(seed, B, H, N, F, D, toeplitz=True):
    """q', k' = |normal| x 0.1, v and the cotangent normal, T = the Toeplitz
    matrix of exp(0.02 normal) coefficients (toeplitz False: every element
    uniform in [0.5, 1.5), as chip_smoke.py's phase 3f draws a T that is
    not Toeplitz), all fp32 numpy."""
    rng = np.random.default_rng(seed)
    qp = np.abs(rng.normal(size=(B, H, N, F))).astype(np.float32) * 0.1
    kp = np.abs(rng.normal(size=(B, H, N, F))).astype(np.float32) * 0.1
    v = rng.normal(size=(B, H, N, D)).astype(np.float32)
    g = rng.normal(size=(B, H, N, D)).astype(np.float32)
    if toeplitz:
        coeffs = np.exp(rng.normal(size=(H, 2 * N - 1)) * 0.02).astype(np.float32)
        idx = np.arange(N)
        t = np.ascontiguousarray(coeffs[:, idx[None, :] - idx[:, None] + N - 1])
    else:
        t = (rng.random(size=(H, N, N)) + 0.5).astype(np.float32)
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


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_versions_over_a_non_toeplitz_t_match_jax_kernels(shape):
    """The kernels take any positive T, not only a Toeplitz one: the plain
    forward and backward over a T drawn element by element against the JAX
    kernels (interpret mode) fed the same T."""
    qp, kp, v, t, g = _inputs(8, *shape, toeplitz=False)
    targs = [torch.from_numpy(a) for a in (qp, kp, v, t)]
    j_args = [jnp.asarray(a) for a in (qp, kp, v, t)]
    out, den = ml.masked_linear_fwd(*targs)
    j_out, j_den = ak._masked_linear_fwd_impl(*j_args, block_q=128, block_kv=128,
                                              interpret=True)
    _close(out, j_out)
    _close(den, j_den)
    got = ml.masked_linear_bwd(*targs, den, out, torch.from_numpy(g))
    want = jax_bwd(*j_args, jnp.asarray(den.numpy()), jnp.asarray(out.numpy()), jnp.asarray(g),
                   block_q=128, block_kv=128, interpret=True)
    for a, b in zip(got, want):
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


# ─── dT's batch groups (csrc/masked_linear_bwd.cu `dt_groups`) ──────────
#
# The bf16 dT kernel sums the batch in groups, each group's elements in
# order into a scratch of partial sums, then the groups in order. The
# wrapper mirrors the library's rule; chip_smoke.py holds the two equal on
# the card. Expected: the pallas_ab shapes, long N and a batch the groups
# do not divide; fp32 takes the staged kernel (one group, no scratch).

DT_GROUP_CASES = [  # (B, H, N, F, D, dtype), groups
    ((256, 2, 197, 44, 16, torch.bfloat16), 16),
    ((8, 2, 1024, 44, 16, torch.bfloat16), 1),
    ((32, 4, 512, 128, 64, torch.bfloat16), 1),
    ((4, 12, 4097, 266, 64, torch.bfloat16), 1),
    ((20, 2, 300, 44, 16, torch.bfloat16), 7),
    ((256, 2, 197, 44, 16, torch.float32), 1),
    ((256, 2, 197, 532, 64, torch.bfloat16), 1),
]


@pytest.mark.parametrize("case", DT_GROUP_CASES, ids=[
    "ab197", "ab1024", "ab512", "longN", "B20_not_divided", "fp32_staged", "F532_staged"])
def test_dt_batch_groups_and_scratch(case):
    (B, H, N, F, D, dtype), groups = case
    assert ml.dt_batch_groups(B, H, N, F, D, dtype) == groups
    want = groups * H * N * N if groups > 1 else 0
    assert ml.dt_scratch_floats(B, H, N, F, D, dtype) == want
    assert want <= ml.DT_SCRATCH_CAP
    # every group non-empty
    per = -(-B // groups)
    assert (groups - 1) * per < B <= groups * per


def test_dt_scratch_cap_bounds_the_groups(monkeypatch):
    """With a smaller cap on the partial sums the groups shrink until they
    fit; the waves rule then picks among the counts that do."""
    B, H, N = 256, 2, 197
    free = ml.dt_batch_groups(B, H, N, 44, 16, torch.bfloat16)
    monkeypatch.setattr(ml, "DT_SCRATCH_CAP", 500_000)
    groups = ml.dt_batch_groups(B, H, N, 44, 16, torch.bfloat16)
    assert 1 < groups < free
    assert groups * H * N * N <= 500_000 < (groups + 1) * H * N * N
    assert ml.dt_scratch_floats(B, H, N, 44, 16, torch.bfloat16) == groups * H * N * N


@pytest.mark.parametrize("shape", [(20, 2, 300, 8, 4), (5, 2, 33, 8, 4)], ids=["B20", "B5"])
def test_dt_group_partition_and_ordered_sum_equal_the_plain_dt(shape):
    """The dT kernel's arithmetic on the CPU in fp32: the batch split by
    `dt_batch_groups` (groups of ceil(B / groups), the last shorter where
    they do not divide B), each group's (M - s) * A summed over its elements
    in order, then the groups in order, against `kerple_dense_bwd_dt`."""
    from efficient_rpe_vit_torch.ops.kernels import masked_linear_coeffs as mlc

    B, H, N, F, D = shape
    qp, kp, v, t, g = (torch.from_numpy(a) for a in _inputs(9, *shape, toeplitz=False))
    out, den = ml.masked_linear_fwd(qp, kp, v, t)
    gn, s = mlc.kerple_bwd_residuals(den, out, g)
    # the rule at this shape in bf16 (the dtype the mma.sync kernel takes)
    groups = ml.dt_batch_groups(B, H, N, 44, 16, torch.bfloat16)
    per = -(-B // groups)
    bounds = [(i * per, min(B, (i + 1) * per)) for i in range(groups)]
    assert groups > 1 and bounds[-1][1] == B and all(b0 < b1 for b0, b1 in bounds)
    parts = []
    for b0, b1 in bounds:
        part = torch.zeros(H, N, N)
        for b in range(b0, b1):
            a = qp[b] @ kp[b].transpose(-1, -2)
            m = gn[b] @ v[b].transpose(-1, -2)
            part += (m - s[b][..., None]) * a
        parts.append(part)
    dt = parts[0]
    for part in parts[1:]:
        dt = dt + part
    want = mlc.kerple_dense_bwd_dt(gn, s, v, qp, kp)
    torch.testing.assert_close(dt, want, rtol=TOL, atol=TOL * want.abs().max().item())
    assert torch.equal(ml.masked_linear_bwd_dt(gn, s, v, qp, kp), want)


# ─── launch_info and the dispatch rule ──────────────────────────────────

@pytest.mark.parametrize("kernel", ["masked_linear_fwd", "masked_linear_bwd_dq",
                                    "masked_linear_bwd_dkv", "masked_linear_bwd_dt"])
def test_launch_info_needs_a_gpu(monkeypatch, kernel):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        ml.launch_info(kernel, 197, 44, 16, torch.bfloat16)
    with pytest.raises(ValueError):
        ml.launch_info("masked_linear_bwd_dc", 197, 44, 16, torch.bfloat16)
    with pytest.raises(TypeError):
        ml.launch_info(kernel, 197, 44, 16, torch.float16)
    with pytest.raises(ValueError):
        ml.launch_info(kernel, 0, 44, 16, torch.bfloat16)


def test_mma_rule_and_sources():
    """bf16 at even F <= 272 and D <= 64 runs the mma.sync kernels, the rest
    the staged ones; the sources hold both, share the forward's and dkv's
    mask-policy stages of kerple_common.cuh with the coefficient kernels
    and use no float atomics."""
    from efficient_rpe_vit_torch.ops.kernels import _build

    assert ml.mma_takes(44, 16, torch.bfloat16) and ml.mma_takes(266, 64, torch.bfloat16)
    assert not ml.mma_takes(44, 16, torch.float32)
    assert not ml.mma_takes(532, 64, torch.bfloat16) and not ml.mma_takes(45, 16, torch.bfloat16)
    assert not ml.mma_takes(266, 128, torch.bfloat16)
    fwd = (_build.CSRC / "masked_linear_fwd.cu").read_text()
    bwd = (_build.CSRC / "masked_linear_bwd.cu").read_text()
    common = (_build.CSRC / "kerple_common.cuh").read_text()
    for name in ("mlt_fwd_mma_kernel", "mlc_t_fwd_kernel", "mlt_fwd_launch_info",
                 "fwd_mma_stage<", "TileMask", "FragMask", "fwd_t_in_registers"):
        assert name in fwd
    for name in ("mlt_bwd_dq_mma_kernel", "mlt_bwd_dkv_mma_kernel", "mlt_bwd_dt_mma_kernel",
                 "mlt_bwd_dt_group_sum_kernel", "mlt_bwd_dt_scratch_floats", "mlt_bwd_dt_groups",
                 "mlt_bwd_launch_info", "dq_mma_stage<", "dkv_mma_stage<", "dq_t_in_registers",
                 "DT_SCRATCH_CAP = 8LL << 20", f"SMS = {ml.DT_SMS}"):
        assert name in bwd
    assert "void dq_mma_stage(" in bwd
    for name in ("struct WindowMask", "struct TileMask", "struct FragMask",
                 "void dkv_mma_stage(", "void fwd_mma_stage(", "void stage_t_tile("):
        assert name in common
    for src in (fwd, bwd):
        assert "atomicAdd" not in src


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
