"""The port's KERPLE kernel wrapper on the CPU.

On CPU tensors the wrapper runs the kernel's plain version; here it is
held against the JAX package's Pallas kernel run in interpret mode, as
tests/test_pallas_kernels.py runs it, at that file's tolerance (fp32 rtol
2e-3 / atol 2e-4). The CUDA kernel itself is compared with the same plain
version on the GPU by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_rpe_vit_tpu.ops.pallas import masked_linear_attention_coeffs as jax_mlc
from efficient_rpe_vit_tpu.ops.pallas.masked_linear_coeffs import _fwd_impl as jax_fwd_impl
from efficient_rpe_vit_torch.ops.kernels import masked_linear_coeffs as mlc

torch.set_num_threads(2)

FP32_TOL = dict(rtol=2e-3, atol=2e-4)
# bf16: both sides round the weights and the output to bf16 (2^-8
# relative); a weight on the other side of a rounding boundary moves an
# output by up to one ulp, so compare at a few ulps.
BF16_TOL = dict(rtol=2e-2, atol=2e-3)


def _inputs(seed, B, H, N, F, D):
    rng = np.random.default_rng(seed)
    qp = np.abs(rng.normal(size=(B, H, N, F))).astype(np.float32) * 0.1
    kp = np.abs(rng.normal(size=(B, H, N, F))).astype(np.float32) * 0.1
    v = rng.normal(size=(B, H, N, D)).astype(np.float32)
    coeffs = np.exp(rng.normal(size=(H, 2 * N - 1)) * 0.02).astype(np.float32)
    return qp, kp, v, coeffs


@pytest.mark.parametrize("shape", [(2, 2, 197, 44, 16), (3, 2, 17, 44, 16)],
                         ids=["N197", "N17"])
def test_plain_version_matches_jax_kernel_fp32(shape):
    qp, kp, v, coeffs = _inputs(0, *shape)
    out, den = mlc.masked_linear_attention_coeffs_fwd(
        *(torch.from_numpy(a) for a in (qp, kp, v, coeffs)))
    j_args = [jnp.asarray(a) for a in (qp, kp, v, coeffs)]
    j_out, j_den = jax_fwd_impl(*j_args, block_q=128, block_kv=128,
                                interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **FP32_TOL)
    np.testing.assert_allclose(den.numpy(), np.asarray(j_den), **FP32_TOL)
    # the public op (out only) agrees with the JAX public op
    j_pub = jax_mlc(*j_args, 128, 128, True)
    np.testing.assert_allclose(
        mlc.masked_linear_attention_coeffs(
            *(torch.from_numpy(a) for a in (qp, kp, v, coeffs))).numpy(),
        np.asarray(j_pub), **FP32_TOL)


def test_plain_version_matches_jax_kernel_bf16():
    qp, kp, v, coeffs = _inputs(1, 2, 2, 197, 44, 16)
    t_args = [torch.from_numpy(a).to(torch.bfloat16) for a in (qp, kp, v)]
    out, den = mlc.masked_linear_attention_coeffs_fwd(
        *t_args, torch.from_numpy(coeffs))
    assert out.dtype == torch.bfloat16 and den.dtype == torch.float32
    j_args = [jnp.asarray(a).astype(jnp.bfloat16) for a in (qp, kp, v)]
    j_out, j_den = jax_fwd_impl(*j_args, jnp.asarray(coeffs), block_q=128,
                                block_kv=128, interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(j_out.astype(jnp.float32)),
                               **BF16_TOL)
    # den is accumulated in fp32 from the same bf16 inputs on both sides
    np.testing.assert_allclose(den.numpy(), np.asarray(j_den), rtol=1e-4)


def _good(dtype=torch.float32, B=1, H=2, N=9, F=8, D=4):
    qp, kp, v, coeffs = (torch.from_numpy(a) for a in _inputs(2, B, H, N, F, D))
    return [qp.to(dtype), kp.to(dtype), v.to(dtype), coeffs]


def _bad_inputs():
    cases = {}
    a = _good()
    a[1] = a[1][:, :, :-1]
    cases["k_shape"] = a
    a = _good()
    a[2] = a[2][:, :1]
    cases["v_heads"] = a
    a = _good()
    a[3] = a[3][:, :-2]
    cases["coeffs_length"] = a
    a = _good()
    a[2] = a[2].to(torch.bfloat16)
    cases["mixed_dtype"] = a
    cases["float16"] = _good(torch.float16)
    a = _good()
    a[3] = a[3].double()
    cases["coeffs_dtype"] = a
    a = _good()
    a[2] = a[2].transpose(2, 3).contiguous().transpose(2, 3)
    cases["non_contiguous"] = a
    a = _good()
    a[0] = a[0][0]
    cases["rank"] = a
    a = _good()
    a[3] = a[3].to("meta")
    cases["two_devices"] = a
    cases["meta_device"] = [t.to("meta") for t in _good()]
    return cases


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_rejects_bad_inputs(case):
    with pytest.raises((ValueError, TypeError)):
        mlc.masked_linear_attention_coeffs_fwd(*_bad_inputs()[case])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_count_does_not_move_on_cpu(dtype):
    before = mlc.masked_linear_attention_coeffs_fwd.launches
    out, den = mlc.masked_linear_attention_coeffs_fwd(*_good(dtype))
    assert out.dtype == dtype and den.dtype == torch.float32
    assert out.shape == (1, 2, 9, 4) and den.shape == (1, 2, 9)
    assert mlc.masked_linear_attention_coeffs_fwd.launches == before


def test_kernel_source_is_in_the_package():
    """The build step compiles the CUDA source shipped in the package, into
    a library named by the source's and the flags' hash."""
    from efficient_rpe_vit_torch.ops.kernels import _build

    assert (_build.CSRC / f"{mlc._SOURCE}.cu").is_file()
    path = _build.library_path(mlc._SOURCE)
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path == _build.library_path(mlc._SOURCE)
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    # the bf16 forward is the register-resident kernel on the flash kernels'
    # mma.sync fragments; the staged kernel keeps fp32 and large F, and the
    # 4-byte row staging and fragment store live once, in the shared header
    src = (_build.CSRC / f"{mlc._SOURCE}.cu").read_text()
    assert "atomicAdd" not in src  # den sums in a fixed order
    for header in ("kerple_common.cuh", "flash_attention_mma.cuh"):
        assert f'#include "{header}"' in src
    for name in ("mlc_fwd_mma_kernel", "mlc_fwd_kernel", "mlc_fwd_launch_info"):
        assert name in src
    common = (_build.CSRC / "kerple_common.cuh").read_text()
    bwd = (_build.CSRC / f"{mlc._BWD_SOURCE}.cu").read_text()
    for helper in ("void stage_words4(", "void store_block("):
        assert helper in common and helper not in src and helper not in bwd


# ─── backward ───────────────────────────────────────────────────────────
#
# The port's plain backward against jax.grad of the JAX package's Pallas op
# (interpret mode, 128-blocks, as tests/test_pallas_kernels.py runs it) at
# that file's fp32 tolerance, and against the JAX dense VJP at a ragged N.

import jax  # noqa: E402

from efficient_rpe_vit_tpu.ops import attention_core as jax_core  # noqa: E402


def _cotangent(seed, B, H, N, D):
    return np.random.default_rng(seed).normal(size=(B, H, N, D)).astype(np.float32)


def _port_bwd(qp, kp, v, coeffs, g, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype) for a in (qp, kp, v)]
    c = torch.from_numpy(coeffs)
    out, den = mlc.masked_linear_attention_coeffs_fwd(*t, c)
    return mlc.masked_linear_attention_coeffs_bwd(
        *t, c, den, out, torch.from_numpy(g).to(dtype))


def _jax_grads(fn, qp, kp, v, coeffs, g):
    return jax.grad(lambda *a: jnp.vdot(fn(*a), jnp.asarray(g)),
                    argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (qp, kp, v, coeffs)))


@pytest.mark.parametrize("shape", [(2, 2, 197, 44, 16), (1, 2, 65, 266, 64)],
                         ids=["jax_test_shape", "main_path_width"])
def test_plain_backward_matches_jax_pallas_backward(shape):
    B, H, N, F, D = shape
    qp, kp, v, coeffs = _inputs(3, *shape)
    g = _cotangent(4, B, H, N, D)
    got = _port_bwd(qp, kp, v, coeffs, g)
    want = _jax_grads(lambda *a: jax_mlc(*a, 128, 128, True), qp, kp, v, coeffs, g)
    assert got[3].dtype == torch.float32 and got[3].shape == (H, 2 * N - 1)
    for name, a, b in zip(("dq'", "dk'", "dv", "dcoeffs"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **FP32_TOL)


def test_plain_backward_matches_jax_dense_vjp_ragged():
    qp, kp, v, coeffs = _inputs(5, 3, 2, 17, 44, 16)
    g = _cotangent(6, 3, 2, 17, 16)
    got = _port_bwd(qp, kp, v, coeffs, g)
    want = _jax_grads(jax_core._kerple_dense, qp, kp, v, coeffs, g)
    for name, a, b in zip(("dq'", "dk'", "dv", "dcoeffs"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **FP32_TOL)


def test_plain_backward_matches_jax_dense_vjp_bf16():
    """bf16 inputs: gn, dA and A*T are rounded to bf16 where the JAX VJP
    rounds them; dcoeffs are fp32 sums in both."""
    qp, kp, v, coeffs = _inputs(7, 2, 2, 50, 44, 16)
    g = _cotangent(8, 2, 2, 50, 16)
    got = _port_bwd(qp, kp, v, coeffs, g, torch.bfloat16)
    assert [t.dtype for t in got] == [torch.bfloat16] * 3 + [torch.float32]
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    want = jax.grad(lambda q, k, vv, c: jnp.vdot(
        jax_core._kerple_dense(q, k, vv, c).astype(jnp.float32), jnp.asarray(g)),
        argnums=(0, 1, 2, 3))(bf(qp), bf(kp), bf(v), jnp.asarray(coeffs))
    for name, a, b in zip(("dq'", "dk'", "dv", "dcoeffs"), got, want):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   err_msg=name, **BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [17, 130])
def test_per_kernel_plain_versions_compose_to_the_backward(n, dtype):
    """The plain versions of the dq, dkv, dc and reduce kernels, chained as
    the CUDA path chains the kernels, give the plain backward; the dc
    windows use the dtype's tile (BWD_TILE) and the ragged last tile."""
    qp, kp, v, coeffs = (torch.from_numpy(a) for a in _inputs(9, 2, 3, n, 20, 8))
    qp, kp, v = qp.to(dtype), kp.to(dtype), v.to(dtype)
    g = torch.from_numpy(_cotangent(10, 2, 3, n, 8)).to(dtype)
    out, den = mlc.masked_linear_attention_coeffs_fwd(qp, kp, v, coeffs)
    want = mlc.masked_linear_attention_coeffs_bwd_reference(qp, kp, v, coeffs, den, out, g)
    gn, s = mlc.kerple_bwd_residuals(den, out, g)
    dq = mlc.masked_linear_attention_coeffs_bwd_dq(gn, s, v, kp, coeffs)
    dk, dv = mlc.masked_linear_attention_coeffs_bwd_dkv(gn, s, v, qp, kp, coeffs)
    windows = mlc.masked_linear_attention_coeffs_bwd_dc(gn, s, v, qp, kp)
    tile = mlc.BWD_TILE[dtype]
    n_t = -(-n // tile)
    assert windows.shape == (3, n_t, n_t, 2 * tile - 1)
    dc = mlc.masked_linear_attention_coeffs_bwd_dc_reduce(windows, n)
    for a, b in zip((dq, dk, dv), want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # dcoeffs: the same fp32 products summed in another order
    torch.testing.assert_close(dc, want[3], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [17, 130])
def test_dc_windows_fold_each_batch_element_then_sum(n, dtype):
    """The fold into diagonal windows is linear, so the windows of each
    batch element on its own, summed over b in order (what the bf16 dc
    kernel and its batch-sum kernel compute), are the full batch's windows
    up to fp32 rounding; ragged last tiles included."""
    qp, kp, v, coeffs = (torch.from_numpy(a) for a in _inputs(15, 3, 2, n, 20, 8))
    qp, kp, v = qp.to(dtype), kp.to(dtype), v.to(dtype)
    g = torch.from_numpy(_cotangent(16, 3, 2, n, 8)).to(dtype)
    out, den = mlc.masked_linear_attention_coeffs_fwd(qp, kp, v, coeffs)
    gn, s = mlc.kerple_bwd_residuals(den, out, g)
    want = mlc.masked_linear_attention_coeffs_bwd_dc_reference(gn, s, v, qp, kp)
    got = torch.zeros_like(want)
    for b in range(v.shape[0]):
        got += mlc.masked_linear_attention_coeffs_bwd_dc_reference(
            *(t[b:b + 1] for t in (gn, s, v, qp, kp)))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    dc = mlc.masked_linear_attention_coeffs_bwd_dc_reduce(got, n)
    torch.testing.assert_close(
        dc, mlc.masked_linear_attention_coeffs_bwd_dc_reduce(want, n), rtol=1e-5, atol=1e-5)


def _dq_blocked(gn, s, v, k_prime, coeffs, bm, bn):
    """dq' as the bf16 dq kernel walks it: query blocks of bm rows, key/value
    stages of bn rows, T read from the window w[t] = c[j0 - i0 + N - bm + t]
    (zero outside [0, 2N - 1)) as T[i, j] = w[(j - j0) - (i - i0) + bm - 1],
    each weight rounded to the input dtype, dq' accumulated in fp32 stage by
    stage and rounded once at the end; rows and columns past N zero-filled."""
    B, H, n, f = k_prime.shape
    out = torch.zeros(B, H, n, f)
    c = coeffs.float()
    for i0 in range(0, n, bm):
        rows = torch.arange(i0, i0 + bm)
        acc = torch.zeros(B, H, bm, f)
        gn_b = torch.zeros(B, H, bm, gn.shape[-1])
        s_b = torch.zeros(B, H, bm)
        gn_b[:, :, :min(bm, n - i0)] = gn[:, :, i0:i0 + bm].float()
        s_b[:, :, :min(bm, n - i0)] = s[:, :, i0:i0 + bm]
        for j0 in range(0, n, bn):
            cols = torch.arange(j0, j0 + bn)
            v_s = torch.zeros(B, H, bn, v.shape[-1])
            k_s = torch.zeros(B, H, bn, f)
            v_s[:, :, :min(bn, n - j0)] = v[:, :, j0:j0 + bn].float()
            k_s[:, :, :min(bn, n - j0)] = k_prime[:, :, j0:j0 + bn].float()
            m = torch.arange(bm + bn - 1) + j0 - i0 + n - bm
            w = torch.where((m >= 0) & (m < 2 * n - 1), c[:, m.clamp(0, 2 * n - 2)],
                            torch.zeros(()))  # [H, bm + bn - 1]
            t_idx = (cols - j0)[None, :] - (rows - i0)[:, None] + bm - 1
            tile = w[:, t_idx]  # [H, bm, bn]
            dw = torch.einsum("bhid,bhjd->bhij", gn_b, v_s) - s_b[..., None]
            valid = (rows[:, None] < n) & (cols[None, :] < n)
            da = torch.where(valid, dw * tile, torch.zeros(())).to(k_prime.dtype).float()
            acc += torch.einsum("bhij,bhjf->bhif", da, k_s)
        out[:, :, i0:i0 + bm] = acc[:, :, :min(bm, n - i0)]
    return out.to(k_prime.dtype)


@pytest.mark.parametrize("tile", [(128, 64), (64, 32)], ids=["shipped", "64x32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [31, 33, 65, 130])
def test_dq_blocked_by_the_kernel_window_matches_plain_dq(n, dtype, tile):
    """The bf16 dq kernel's index arithmetic (query blocks of tile[0] rows,
    key/value stages of tile[1] rows, the window's offset set by the query
    block's extent, ragged last block and stage zero-filled), run on the
    CPU, gives the plain dq. Coefficients spread over [0.1, 2] so that a
    window off by one diagonal moves dq' by far more than the tolerance."""
    B, H, D, F_ = 2, 3, 16, 40
    qp, kp, v, _ = (torch.from_numpy(a) for a in _inputs(17, B, H, n, F_, D))
    coeffs = torch.from_numpy(np.random.default_rng(18).uniform(
        0.1, 2.0, size=(H, 2 * n - 1)).astype(np.float32))
    qp, kp, v = qp.to(dtype), kp.to(dtype), v.to(dtype)
    g = torch.from_numpy(_cotangent(19, B, H, n, D)).to(dtype)
    out, den = mlc.masked_linear_attention_coeffs_fwd(qp, kp, v, coeffs)
    gn, s = mlc.kerple_bwd_residuals(den, out, g)
    want = mlc.masked_linear_attention_coeffs_bwd_dq_reference(gn, s, v, kp, coeffs)
    got = _dq_blocked(gn, s, v, kp, coeffs, *tile)
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **tol)


def _fwd_blocked(q_prime, k_prime, v, coeffs, bm, bn):
    """(out, den) as the bf16 forward kernel walks them: query blocks of bm
    rows, key/value stages of bn rows, T read from the window w[t] =
    c[j0 - i0 + N - bm + t] (zero outside [0, 2N - 1)) as T[a, b] =
    w[b - a + bm - 1] for the block's row a and the stage's row b, W = S * T
    zero past N, den summed from the fp32 W stage by stage, each weight
    rounded to the input dtype before W v; rows past N zero-filled."""
    B, H, n, f = q_prime.shape
    d = v.shape[-1]
    out = torch.zeros(B, H, n, d)
    den = torch.zeros(B, H, n)
    c = coeffs.float()
    for i0 in range(0, n, bm):
        rows = torch.arange(i0, i0 + bm)
        q_b = torch.zeros(B, H, bm, f)
        q_b[:, :, :min(bm, n - i0)] = q_prime[:, :, i0:i0 + bm].float()
        acc = torch.zeros(B, H, bm, d)
        den_b = torch.zeros(B, H, bm)
        for j0 in range(0, n, bn):
            cols = torch.arange(j0, j0 + bn)
            k_s = torch.zeros(B, H, bn, f)
            v_s = torch.zeros(B, H, bn, d)
            k_s[:, :, :min(bn, n - j0)] = k_prime[:, :, j0:j0 + bn].float()
            v_s[:, :, :min(bn, n - j0)] = v[:, :, j0:j0 + bn].float()
            m = torch.arange(bm + bn - 1) + j0 - i0 + n - bm
            w = torch.where((m >= 0) & (m < 2 * n - 1), c[:, m.clamp(0, 2 * n - 2)],
                            torch.zeros(()))  # [H, bm + bn - 1]
            tile = w[:, (cols - j0)[None, :] - (rows - i0)[:, None] + bm - 1]  # [H, bm, bn]
            valid = (rows[:, None] < n) & (cols[None, :] < n)
            wt = torch.where(valid, torch.einsum("bhif,bhjf->bhij", q_b, k_s) * tile,
                             torch.zeros(()))
            den_b += wt.sum(dim=-1)
            acc += torch.einsum("bhij,bhjd->bhid", wt.to(v.dtype).float(), v_s)
        rq = min(bm, n - i0)
        out[:, :, i0:i0 + rq] = acc[:, :, :rq] / (den_b[:, :, :rq, None] + mlc.EPS)
        den[:, :, i0:i0 + rq] = den_b[:, :, :rq]
    return out.to(v.dtype), den


@pytest.mark.parametrize("tile", [(128, 64), (64, 32)], ids=["shipped", "64x32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [31, 33, 65, 130, 197])
def test_fwd_blocked_by_the_kernel_window_matches_plain_fwd(n, dtype, tile):
    """The bf16 forward kernel's index arithmetic (query blocks of tile[0]
    rows, key/value stages of tile[1] rows, the window's offset set by the
    query block's extent, ragged last block and stage zero-filled), run on
    the CPU, gives the plain forward's out and den. Coefficients spread over
    [0.1, 2] so that a window off by one diagonal moves out and den by far
    more than the tolerance."""
    B, H, D, F_ = 2, 3, 16, 40
    qp, kp, v, _ = (torch.from_numpy(a) for a in _inputs(21, B, H, n, F_, D))
    coeffs = torch.from_numpy(np.random.default_rng(22).uniform(
        0.1, 2.0, size=(H, 2 * n - 1)).astype(np.float32))
    qp, kp, v = qp.to(dtype), kp.to(dtype), v.to(dtype)
    want_out, want_den = mlc.masked_linear_attention_coeffs_reference(qp, kp, v, coeffs)
    got_out, got_den = _fwd_blocked(qp, kp, v, coeffs, *tile)
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got_out.float().numpy(), want_out.float().numpy(), **tol)
    # den: fp32 sums of the same fp32 weights in both dtypes, in another order
    np.testing.assert_allclose(got_den.numpy(), want_den.numpy(), **FP32_TOL)


def _fused_inputs(seed, B, H, N, D, F):
    """L2-normalised q, k (the KERPLE contract), v and Omega [H, D, F]."""
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(B, H, N, D)).astype(np.float32) for _ in range(2))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rng.normal(size=(B, H, N, D)).astype(np.float32)
    omega = rng.normal(size=(H, D, F)).astype(np.float32)
    return (torch.from_numpy(a) for a in (q, k, v, omega))


def _phi_by_kernel_rules(x, omega, kind):
    """phi of a block of raw rows x [B, H, rows, D] as the fused kernel builds
    it: u = x round(Omega) in fp32, phi+ = exp((u - max over the F lanes) -
    ||x||^2/2) / sqrt(F) or relu(u) / sqrt(F), rounded to x's dtype."""
    f = omega.shape[-1]
    u = torch.einsum("bhrd,hdf->bhrf", x.float(), omega.to(x.dtype).float())
    if kind == "relu":
        phi = torch.relu(u) * (1.0 / f ** 0.5)
    else:
        norm_half = (x.float() ** 2).sum(dim=-1, keepdim=True) * 0.5
        phi = torch.exp((u - u.amax(dim=-1, keepdim=True)) - norm_half) * (1.0 / f ** 0.5)
    return phi.to(x.dtype)


def _fused_blocked(q, k, v, omega, coeffs, kind, bm, bn):
    """(out, den) as the bf16 fused-phi kernel walks them: query blocks of bm
    rows whose phi_q is built once, key/value stages of bn rows whose phi_k
    is built from the stage's raw k rows (zero-filled past N) with its rows
    past N set to exactly 0 after phi, T read from the window w[t] =
    c[j0 - i0 + N - bm + t] (zero outside [0, 2N - 1)) as T[a, b] =
    w[b - a + bm - 1]; W = S * T with no mask by index (cells past N vanish
    through phi_k's zero rows), den summed from the fp32 W stage by stage,
    each weight rounded to v's dtype before W v."""
    B, H, n, d = q.shape
    dv = v.shape[-1]
    out = torch.zeros(B, H, n, dv)
    den = torch.zeros(B, H, n)
    c = coeffs.float()
    for i0 in range(0, n, bm):
        rows = torch.arange(i0, i0 + bm)
        q_b = torch.zeros(B, H, bm, d, dtype=q.dtype)
        q_b[:, :, :min(bm, n - i0)] = q[:, :, i0:i0 + bm]
        phi_q = _phi_by_kernel_rules(q_b, omega, kind).float()
        acc = torch.zeros(B, H, bm, dv)
        den_b = torch.zeros(B, H, bm)
        for j0 in range(0, n, bn):
            cols = torch.arange(j0, j0 + bn)
            k_s = torch.zeros(B, H, bn, d, dtype=k.dtype)
            v_s = torch.zeros(B, H, bn, dv)
            k_s[:, :, :min(bn, n - j0)] = k[:, :, j0:j0 + bn]
            v_s[:, :, :min(bn, n - j0)] = v[:, :, j0:j0 + bn].float()
            phi_k = _phi_by_kernel_rules(k_s, omega, kind).float()
            phi_k[:, :, cols >= n] = 0.0
            m = torch.arange(bm + bn - 1) + j0 - i0 + n - bm
            w = torch.where((m >= 0) & (m < 2 * n - 1), c[:, m.clamp(0, 2 * n - 2)],
                            torch.zeros(()))  # [H, bm + bn - 1]
            tile = w[:, (cols - j0)[None, :] - (rows - i0)[:, None] + bm - 1]  # [H, bm, bn]
            wt = torch.einsum("bhif,bhjf->bhij", phi_q, phi_k) * tile
            den_b += wt.sum(dim=-1)
            acc += torch.einsum("bhij,bhjd->bhid", wt.to(v.dtype).float(), v_s)
        rq = min(bm, n - i0)
        out[:, :, i0:i0 + rq] = acc[:, :, :rq] / (den_b[:, :, :rq, None] + mlc.EPS)
        den[:, :, i0:i0 + rq] = den_b[:, :, :rq]
    return out.to(v.dtype), den


@pytest.mark.parametrize("tile", [(128, 64), (64, 32)], ids=["shipped", "64x32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [31, 65, 130, 197])
@pytest.mark.parametrize("kind", ["favor_plus", "relu"])
def test_fused_blocked_by_the_kernel_stages_matches_plain_fused(kind, n, dtype, tile):
    """The bf16 fused-phi kernel's blocking (phi_q per query block of tile[0]
    rows, phi_k per key/value stage of tile[1] rows with Omega rounded, the
    max over the F real lanes and rows past N zeroed after phi, the window's
    offset set by the query block's extent), run on the CPU, gives the plain
    fused forward's out and den. Every n leaves a ragged last stage, so phi+
    rows past N left unzeroed would add to den; coefficients spread over
    [0.1, 2] so that a window off by one diagonal moves out and den by far
    more than the tolerance."""
    B, H, D, F_ = 2, 3, 16, 44
    q, k, v, omega = _fused_inputs(23, B, H, n, D, F_)
    coeffs = torch.from_numpy(np.random.default_rng(24).uniform(
        0.1, 2.0, size=(H, 2 * n - 1)).astype(np.float32))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    want_out, want_den = mlc.kerple_attention_fused_phi_fwd_reference(q, k, v, omega, coeffs,
                                                                      kind)
    got_out, got_den = _fused_blocked(q, k, v, omega, coeffs, kind, *tile)
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got_out.float().numpy(), want_out.float().numpy(), **tol)
    # den: fp32 sums of fp32 weights; in bf16 a phi feature computed in
    # another order may round one ulp the other way (2^-8 relative at most)
    den_tol = FP32_TOL if dtype == torch.float32 else dict(rtol=2 ** -8, atol=0)
    np.testing.assert_allclose(got_den.numpy(), want_den.numpy(), **den_tol)


def test_dc_windows_follow_the_forward_window_convention():
    """Window m of tile pair (iq, jk) is coefficient
    (jk - iq) * tile + N - tile + m: a dT that is 1 on one element (i, j)
    and 0 elsewhere puts its 1 at coefficient j - i + N - 1."""
    n, tile = 70, mlc.BWD_TILE[torch.float32]
    windows = torch.zeros(1, 3, 3, 2 * tile - 1)
    i, j = 40, 5  # tile pair (1, 0), local (a, b) = (8, 5)
    windows[0, 1, 0, 5 - 8 + tile - 1] = 1.0
    dc = mlc.masked_linear_attention_coeffs_bwd_dc_reduce(windows, n)
    assert dc.shape == (1, 2 * n - 1)
    assert dc[0, j - i + n - 1] == 1.0 and dc.sum() == 1.0


def _bwd_bad_inputs():
    gn, s, v, kp, qp, coeffs = _bwd_good()
    cases = {
        "s_dtype": (gn, s.double(), v, kp, qp, coeffs),
        "gn_shape": (gn[:, :, :-1], s, v, kp, qp, coeffs),
        "q_shape": (gn, s, v, kp, qp[..., :-1], coeffs),
        "coeffs_length": (gn, s, v, kp, qp, coeffs[:, :-1]),
        "mixed_dtype": (gn.to(torch.bfloat16), s, v, kp, qp, coeffs),
        "non_contiguous": (gn, s, v, kp.transpose(2, 3).contiguous().transpose(2, 3),
                           qp, coeffs),
        "meta_device": (gn.to("meta"), s.to("meta"), v.to("meta"), kp.to("meta"),
                        qp.to("meta"), coeffs.to("meta")),
    }
    return cases


def _bwd_good(dtype=torch.float32):
    qp, kp, v, coeffs = (torch.from_numpy(a) for a in _inputs(11, 1, 2, 9, 8, 4))
    qp, kp, v = qp.to(dtype), kp.to(dtype), v.to(dtype)
    g = torch.from_numpy(_cotangent(12, 1, 2, 9, 4)).to(dtype)
    out, den = mlc.masked_linear_attention_coeffs_fwd(qp, kp, v, coeffs)
    gn, s = mlc.kerple_bwd_residuals(den, out, g)
    return gn, s, v, kp, qp, coeffs


@pytest.mark.parametrize("case", sorted(_bwd_bad_inputs()))
def test_backward_wrappers_reject_bad_inputs(case):
    """Each backward wrapper rejects every malformed input it takes."""
    gn, s, v, kp, qp, coeffs = _bwd_bad_inputs()[case]
    calls = {
        "dq": lambda: mlc.masked_linear_attention_coeffs_bwd_dq(gn, s, v, kp, coeffs),
        "dkv": lambda: mlc.masked_linear_attention_coeffs_bwd_dkv(gn, s, v, qp, kp, coeffs),
        "dc": lambda: mlc.masked_linear_attention_coeffs_bwd_dc(gn, s, v, qp, kp),
    }
    takes = {"q_shape": ("dkv", "dc"), "coeffs_length": ("dq", "dkv")}
    for name in takes.get(case, calls):
        with pytest.raises((ValueError, TypeError)):
            calls[name]()


def test_dc_reduce_checks_its_windows():
    reduce = mlc.masked_linear_attention_coeffs_bwd_dc_reduce
    ok = torch.zeros(1, 3, 3, 63)  # three 32-row tiles cover n = 70
    assert reduce(ok, 70).shape == (1, 139)
    for bad in (torch.zeros(1, 3, 2, 63), torch.zeros(1, 3, 3, 62),
                torch.zeros(1, 2, 2, 63), torch.zeros(3, 63), ok.double(),
                torch.zeros(1, 3, 63, 3).transpose(2, 3)):
        with pytest.raises(ValueError):
            reduce(bad, 70)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_launch_counts_do_not_move_on_cpu(dtype):
    fns = (mlc.masked_linear_attention_coeffs_bwd_dq,
           mlc.masked_linear_attention_coeffs_bwd_dkv,
           mlc.masked_linear_attention_coeffs_bwd_dc,
           mlc.masked_linear_attention_coeffs_bwd_dc_reduce)
    before = [f.launches for f in fns]
    qp, kp, v, coeffs = _good(dtype)
    out, den = mlc.masked_linear_attention_coeffs_fwd(qp, kp, v, coeffs)
    dq, dk, dv, dc = mlc.masked_linear_attention_coeffs_bwd(
        qp, kp, v, coeffs, den, out, torch.ones_like(out))
    assert (dq.dtype, dk.dtype, dv.dtype, dc.dtype) == (dtype,) * 3 + (torch.float32,)
    assert [f.launches for f in fns] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_matches_dense_arm(dtype):
    """The differentiable op (the autograd Function over the kernel wrapper,
    here on its plain version) and the dense arm's Function give the same
    output and q', k', v gradients bit for bit, and the same bias gradient
    up to summation order; the cotangent arrives non-contiguous, as it does
    through the head merge."""
    from efficient_rpe_vit_torch.ops import kerple_linear_attention

    base = [torch.from_numpy(a) for a in _inputs(13, 2, 3, 40, 20, 8)]
    g = torch.from_numpy(_cotangent(14, 2, 40, 3, 8)).to(dtype).transpose(1, 2)
    results = {}
    for method in ("pallas", "dense"):
        qp, kp, v = (a.to(dtype).requires_grad_() for a in base[:3])
        bias = torch.log(base[3]).requires_grad_()
        out = kerple_linear_attention(qp, kp, v, torch.exp(bias), method=method)
        assert out.grad_fn is not None and out.dtype == dtype
        out.backward(g)
        results[method] = [out.detach()] + [t.grad for t in (qp, kp, v, bias)]
    assert "MaskedLinearCoeffs" in type(
        mlc.masked_linear_attention_coeffs(
            *(a.to(dtype).requires_grad_() for a in base[:3]), base[3]).grad_fn).__name__
    for a, b in zip(results["pallas"][:4], results["dense"][:4]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the bias gradient: the same fp32 dT summed along its diagonals
    # (toeplitz_diag_sums) vs autograd's scatter-add of the T gather
    torch.testing.assert_close(results["pallas"][4], results["dense"][4],
                               rtol=1e-4, atol=1e-6)


def test_op_without_autograd_is_the_forward_alone():
    """Under inference mode or no_grad the op records nothing and the
    forward wrapper is all that runs (the serving path)."""
    qp, kp, v, coeffs = (t.requires_grad_() if t.is_floating_point() else t
                         for t in _good())
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            out = mlc.masked_linear_attention_coeffs(qp, kp, v, coeffs)
        assert out.grad_fn is None and not out.requires_grad


def test_backward_kernel_source_is_in_the_package():
    from efficient_rpe_vit_torch.ops.kernels import _build

    assert (_build.CSRC / f"{mlc._BWD_SOURCE}.cu").is_file()
    path = _build.library_path(mlc._BWD_SOURCE)
    assert path.parent == _build.BUILD_DIR and path != _build.library_path(mlc._SOURCE)
    src = (_build.CSRC / f"{mlc._BWD_SOURCE}.cu").read_text()
    assert "atomicAdd" not in src  # dcoeffs are reduced in a fixed order
    # the bf16 dkv kernel is the register-resident one, on the flash kernels'
    # mma.sync fragments; the staged kernels keep the shared KERPLE header
    for header in ("kerple_common.cuh", "flash_attention_mma.cuh"):
        assert (_build.CSRC / header).is_file()
        assert f'#include "{header}"' in src
    for kernel in ("mlc_bwd_dq_mma_kernel", "mlc_bwd_dkv_mma_kernel", "mlc_bwd_dkv_kernel",
                   "mlc_bwd_dq_kernel", "mlc_bwd_dc_kernel", "mlc_bwd_launch_info"):
        assert kernel in src
    # the bf16 dc kernel folds each batch element into a scratch the wrapper
    # allocates, and a second kernel sums it over the batch in order
    for kernel in ("mlc_bwd_dc_mma_kernel", "mlc_bwd_dc_batch_sum_kernel",
                   "mlc_bwd_dc_scratch_floats"):
        assert kernel in src


def test_fused_kernel_source_shares_the_forwards_stage():
    """The bf16 fused-phi kernel runs the unfused forward's register-resident
    stage and epilogue from the shared header, and keeps the exact
    exponential and fixed-order sums (no fast exp, no float atomics)."""
    from efficient_rpe_vit_torch.ops.kernels import _build

    fused = (_build.CSRC / f"{mlc._FUSED_SOURCE}.cu").read_text()
    fwd = (_build.CSRC / f"{mlc._SOURCE}.cu").read_text()
    common = (_build.CSRC / "kerple_common.cuh").read_text()
    for name in ("kfp_fwd_mma_kernel", "kfp_mma_takes", "kfp_fwd_launch_info", "kfp_fwd_kernel"):
        assert name in fused
    assert '#include "flash_attention_mma.cuh"' in common
    for name in ("fwd_mma_stage", "fwd_mma_store"):
        assert f"void {name}(" in common
        assert f"{name}<" in fused and f"{name}<" in fwd
    assert "expf((u - mx) - nh)" in fused
    for banned in ("atomicAdd", "__expf", "exp2", "ex2("):
        assert banned not in fused


@pytest.mark.parametrize("args, error", [
    (("masked_linear_coeffs_bwd", 197, 266, 64, torch.bfloat16), ValueError),
    (("masked_linear_coeffs_fwd_dq", 197, 266, 64, torch.bfloat16), ValueError),
    (("masked_linear_coeffs_bwd_dkv", 197, 266, 64, torch.float16), TypeError),
    (("masked_linear_coeffs_bwd_dq", 0, 266, 64, torch.bfloat16), ValueError),
    (("masked_linear_coeffs_bwd_dkv", 197, 0, 64, torch.float32), ValueError),
    (("masked_linear_coeffs_bwd_dc", 197, 266, -1, torch.bfloat16), ValueError),
    (("kerple_fused_phi", 197, 266, 64, torch.bfloat16), ValueError),
    (("kerple_fused_phi_fwd", 197, 266, 64, torch.float16), TypeError),
    (("kerple_fused_phi_fwd", 0, 266, 64, torch.bfloat16), ValueError),
    (("kerple_fused_phi_fwd", 197, -1, 64, torch.bfloat16), ValueError),
    (("kerple_fused_phi_fwd", 197, 266, 0, torch.float32), ValueError),
    (("masked_linear_coeffs_fwd", 197, 266, 64, torch.float16), TypeError),
    (("masked_linear_coeffs_fwd", 0, 266, 64, torch.bfloat16), ValueError),
    (("masked_linear_coeffs_fwd", 197, -2, 64, torch.float32), ValueError),
    (("masked_linear_coeffs_fwd", 197, 266, 0, torch.bfloat16), ValueError),
])
def test_mlc_launch_info_refuses_bad_arguments(args, error):
    """launch_info checks its arguments before it asks the library (which
    needs a GPU), and names what it reports."""
    with pytest.raises(error):
        mlc.launch_info(*args)
    assert mlc.LAUNCH_INFO_KEYS == ("rows", "threads", "smem_bytes", "blocks_per_sm",
                                    "registers", "spill_bytes")
