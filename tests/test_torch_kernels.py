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


def test_plain_backward_matches_jax_pallas_backward():
    shape = (2, 2, 197, 44, 16)
    qp, kp, v, coeffs = _inputs(3, *shape)
    g = _cotangent(4, 2, 2, 197, 16)
    got = _port_bwd(qp, kp, v, coeffs, g)
    want = _jax_grads(lambda *a: jax_mlc(*a, 128, 128, True), qp, kp, v, coeffs, g)
    assert got[3].dtype == torch.float32 and got[3].shape == (2, 393)
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
