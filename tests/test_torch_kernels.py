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
