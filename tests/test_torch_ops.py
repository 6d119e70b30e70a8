"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

Inputs are drawn with numpy and handed to both packages. Tolerances:
fp32 results differ only in summation order (rtol 1e-5 unless stated);
bf16 results are rounded to bf16 in both (2^-8 relative per rounding), and
the two frameworks round intermediates at slightly different places, so
bf16 compares at rtol 2e-2 — a few bf16 ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_rpe_vit_tpu.ops import attention_core as jax_core
from efficient_rpe_vit_tpu.ops import feature_maps as jax_fm
from efficient_rpe_vit_tpu.ops import fft_toeplitz as jax_ft
from efficient_rpe_vit_torch.ops import (
    default_num_features,
    gaussian_features,
    kerple_linear_attention,
    linear_attention,
    mxu_num_features,
    orthogonal_gaussian_features,
    phi_positive,
    phi_relu,
    masked_linear_vjp_residual,
    toeplitz_diag_sums,
    toeplitz_from_coeffs,
)

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=2e-2, atol=2e-3)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a torch and a jax array of `dtype`."""
    t_dt, j_dt = DTYPES[dtype]
    return torch.from_numpy(a).to(t_dt), jnp.asarray(a).astype(j_dt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _kerple_inputs(rng, B, H, N, F, D):
    qp = np.abs(rng.normal(size=(B, H, N, F))).astype(np.float32) * 0.1
    kp = np.abs(rng.normal(size=(B, H, N, F))).astype(np.float32) * 0.1
    v = rng.normal(size=(B, H, N, D)).astype(np.float32)
    coeffs = np.exp(rng.normal(size=(H, 2 * N - 1)) * 0.02).astype(np.float32)
    return qp, kp, v, coeffs


@pytest.mark.parametrize("head_dim", [8, 16, 32, 64, 128])
def test_num_features_match_jax(head_dim):
    assert default_num_features(head_dim) == jax_fm.default_num_features(head_dim)
    assert mxu_num_features(head_dim) == jax_fm.mxu_num_features(head_dim)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["positive", "relu"])
def test_phi_matches_jax(kind, dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 2, 17, 16)) * 0.5).astype(np.float32)
    omega = rng.normal(size=(2, 16, 44)).astype(np.float32)
    tx, jx = _pair(x, dtype)
    t_fn, j_fn = {"positive": (phi_positive, jax_fm.phi_positive),
                  "relu": (phi_relu, jax_fm.phi_relu)}[kind]
    got = t_fn(tx, torch.from_numpy(omega))
    want = j_fn(jx, jnp.asarray(omega))
    assert got.dtype == DTYPES[dtype][0] and got.shape == (2, 2, 17, 44)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_phi_positive_stabiliser_is_per_row():
    """Shifting one row's projections leaves the other rows' features as
    they were: the max subtracted is per row, not global."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 1, 4, 8)).astype(np.float32))
    omega = torch.from_numpy(rng.normal(size=(1, 8, 16)).astype(np.float32))
    base = phi_positive(x, omega)
    x2 = x.clone()
    x2[0, 0, 0] *= 3.0
    moved = phi_positive(x2, omega)
    torch.testing.assert_close(moved[0, 0, 1:], base[0, 0, 1:])
    assert moved.max() <= 1.0 / np.sqrt(16) + 1e-7  # exp(<= 0) / sqrt(m)


@pytest.mark.parametrize("n", [1, 5, 17, 197])
def test_toeplitz_from_coeffs_matches_jax(n):
    rng = np.random.default_rng(n)
    c = rng.normal(size=(3, 2 * n - 1)).astype(np.float32)
    got = toeplitz_from_coeffs(torch.from_numpy(c), n)
    want = jax_ft.toeplitz_from_coeffs(jnp.asarray(c), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # n inferred from the coefficient length
    np.testing.assert_array_equal(
        toeplitz_from_coeffs(torch.from_numpy(c)).numpy(), got.numpy())


def test_toeplitz_from_coeffs_rejects_even_length():
    with pytest.raises(ValueError):
        toeplitz_from_coeffs(torch.zeros(2, 4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_attention_matches_jax(dtype):
    rng = np.random.default_rng(2)
    qp, kp, v, _ = _kerple_inputs(rng, 2, 2, 50, 44, 16)
    args_t, args_j = zip(*(_pair(a, dtype) for a in (qp, kp, v)))
    got = linear_attention(*args_t)
    want = jax_core.linear_attention(*args_j)
    assert got.dtype == DTYPES[dtype][0]
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [17, 197])
def test_kerple_dense_matches_jax(n, dtype):
    rng = np.random.default_rng(n)
    qp, kp, v, coeffs = _kerple_inputs(rng, 2, 2, n, 44, 16)
    args_t, args_j = zip(*(_pair(a, dtype) for a in (qp, kp, v)))
    got = kerple_linear_attention(*args_t, torch.from_numpy(coeffs),
                                  method="dense")
    want = jax_core._kerple_dense(*args_j, jnp.asarray(coeffs))
    assert got.dtype == DTYPES[dtype][0]
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_kerple_methods_on_cpu():
    """On CPU tensors 'pallas' (and 'auto') take the kernel's plain version,
    the same formula as 'dense'; 'fft' computes it by FFT (fp32 FFT
    roundoff, rtol 1e-5)."""
    rng = np.random.default_rng(3)
    qp, kp, v, coeffs = (torch.from_numpy(a) for a in
                         _kerple_inputs(rng, 1, 2, 17, 8, 4))
    dense = kerple_linear_attention(qp, kp, v, coeffs, method="dense")
    for method in ("pallas", "auto"):
        torch.testing.assert_close(
            kerple_linear_attention(qp, kp, v, coeffs, method=method), dense)
    torch.testing.assert_close(kerple_linear_attention(qp, kp, v, coeffs, method="fft"),
                               dense, rtol=1e-5, atol=1e-5 * dense.abs().max().item())
    with pytest.raises(ValueError):
        kerple_linear_attention(qp, kp, v, coeffs, method="nope")


@pytest.mark.parametrize("head_dim,m", [(16, 44), (16, 16), (64, 266)])
def test_orthogonal_features_shape_and_orthogonality(head_dim, m):
    """The RNGs differ from JAX's, so the draw is checked by its structure:
    each head_dim-wide column block is sqrt(d) times orthonormal columns."""
    g = torch.Generator().manual_seed(0)
    omega = orthogonal_gaussian_features(g, 3, head_dim, m)
    assert omega.shape == (3, head_dim, m)
    for h in range(3):
        for start in range(0, m, head_dim):
            blk = omega[h, :, start:start + head_dim].double() / np.sqrt(head_dim)
            eye = torch.eye(blk.shape[1], dtype=torch.float64)
            torch.testing.assert_close(blk.T @ blk, eye, atol=1e-5, rtol=0)
    again = orthogonal_gaussian_features(torch.Generator().manual_seed(0),
                                         3, head_dim, m)
    torch.testing.assert_close(again, omega, rtol=0, atol=0)


def test_gaussian_features_shape_and_seed():
    a = gaussian_features(torch.Generator().manual_seed(5), 2, 8, 20)
    b = gaussian_features(torch.Generator().manual_seed(5), 2, 8, 20)
    assert a.shape == (2, 8, 20)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 5, 17, 197])
def test_toeplitz_diag_sums_matches_jax(n):
    x = np.random.default_rng(n + 1).normal(size=(2, 3, n, n)).astype(np.float32)
    got = toeplitz_diag_sums(torch.from_numpy(x))
    want = jax_ft.toeplitz_diag_sums(jnp.asarray(x))
    assert got.shape == (2, 3, 2 * n - 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_linear_vjp_residual_matches_jax(dtype):
    """The explicit residual VJP, fed the same (den, out) residuals: the
    input-dtype rounding of gn, dA and A*T happens at the same places."""
    rng = np.random.default_rng(4)
    qp, kp, v, coeffs = _kerple_inputs(rng, 2, 2, 33, 20, 8)
    g = rng.normal(size=v.shape).astype(np.float32)
    t = jax_ft.toeplitz_from_coeffs(jnp.asarray(coeffs), 33)
    args_t, args_j = zip(*(_pair(a, dtype) for a in (qp, kp, v)))
    j_out, j_den = jax_core._kerple_dense_core_fwd_impl(*args_j, t)
    _, jg = _pair(g, dtype)
    want = jax_core.masked_linear_vjp_residual(*args_j, t, j_den, j_out, jg)
    t_out = torch.from_numpy(np.array(j_out.astype(jnp.float32))).to(DTYPES[dtype][0])
    got = masked_linear_vjp_residual(
        *args_t, torch.from_numpy(np.array(t)), torch.from_numpy(np.array(j_den)),
        t_out, _pair(g, dtype)[0])
    assert [x.dtype for x in got] == [DTYPES[dtype][0]] * 3 + [torch.float32]
    for name, a, b in zip(("dq'", "dk'", "dv", "dT"), got, want):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **TOL[dtype])
