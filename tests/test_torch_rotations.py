"""The port's rotations and rotation kernels against the JAX package, on the CPU.

The rotation kernels' plain versions (what the wrappers run on CPU
tensors) are held against the JAX package's Pallas `circulant_rotate` run
in interpret mode, forward and backward (its custom VJP: dx, dct, dst),
with keep_cls off and on, at the JAX kernel tests' shapes. The plain DFT
chain and the kernel arm are held against the JAX `apply_circulant_rotation`,
`apply_block_circulant_rotation` and `apply_circulant_string`, the circulant
coefficients' gradient against JAX autodiff, and RoPE, RoPE2D, the tables,
the grid positions and the hyperbolic features against their JAX
counterparts. Inputs come from numpy.

Tolerances: kernels rtol 1e-4, atol 1e-5 (the JAX kernel tests' own; fp32
DFT products in another summation order). fp32 rotations 1e-5 (summation
order). bf16: the chain rounds its spectra to bf16 where the JAX chain
does, but sums in another order, so the port's bf16 error against JAX fp32
must stay within 2x the JAX bf16 error. RoPE and the tables: bit for bit
where the arithmetic is the same, 1e-6 where the pairing differs (the JAX
package multiplies by a +-1 matrix).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_rpe_vit_tpu.ops import feature_maps as jax_fm
from efficient_rpe_vit_tpu.ops import rotations as jax_rot
from efficient_rpe_vit_tpu.ops.pallas.rotation_kernels import circulant_rotate as jax_kernel
from efficient_rpe_vit_torch.ops import feature_maps, rotations
from efficient_rpe_vit_torch.ops.kernels import _build
from efficient_rpe_vit_torch.ops.kernels import circulant_rotate as cr

torch.set_num_threads(2)

KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ERROR_FACTOR = 2.0
# the JAX kernel tests' shapes (B, H, N, D)
KERNEL_SHAPES = [(2, 3, 190, 16), (1, 2, 17, 16), (3, 1, 65, 64)]


def _rotation_inputs(seed, B, H, N, D):
    """x, cotangent [B, H, N, D] and ct, st [H, N, D//2 + 1], as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, N, D)).astype(np.float32)
    g = rng.normal(size=(B, H, N, D)).astype(np.float32)
    theta = (rng.normal(size=(H, N, D // 2 + 1)) * 0.3).astype(np.float32)
    return x, g, np.cos(theta), np.sin(theta)


def _circulant_inputs(seed, B, H, N, D, coord_dim=2, block=None, cls=True):
    """q, k, cotangents, positions (of the N - 1 patches after CLS, or of
    all N tokens without one) and coefficients."""
    rng = np.random.default_rng(seed)
    q, k, gq, gk = (rng.normal(size=(B, H, N, D)).astype(np.float32) for _ in range(4))
    shape = (H, coord_dim, D) if block is None else (H, coord_dim, D // block, block)
    coeffs = (rng.normal(size=shape) * 0.1).astype(np.float32)
    positions = np.asarray(jax_rot.grid_positions_2d(N - 1 if cls else N, coord_dim))
    return q, k, gq, gk, positions, coeffs


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ─── the kernels' plain versions against the interpret-mode Pallas kernel ─

@pytest.mark.parametrize("keep_cls", [False, True])
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_kernels_match_jax_kernel(shape, keep_cls):
    x, g, ct, st = _rotation_inputs(sum(shape), *shape)
    jx, jct, jst = (jnp.asarray(a) for a in (x, ct, st))
    want, vjp = jax.vjp(lambda a, b, c: jax_kernel(a, b, c, 64, True, keep_cls), jx, jct, jst)
    got = cr.circulant_rotate_fwd(*_t(x, ct, st), keep_cls)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    grads = cr.circulant_rotate_bwd(*_t(g, x, ct, st), keep_cls)
    for name, a, b in zip(("dx", "dct", "dst"), grads, vjp(jnp.asarray(g))):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **KERNEL_TOL, err_msg=name)
    if keep_cls:
        assert torch.equal(got[:, :, 0], torch.from_numpy(x[:, :, 0]))
        assert torch.equal(grads[0][:, :, 0], torch.from_numpy(g[:, :, 0]))
        assert not grads[1][:, 0].any() and not grads[2][:, 0].any()


def test_plain_kernels_bf16_round_only_the_result():
    """bf16 x: the plain versions compute in fp32 and round out and dx once;
    dct and dst stay fp32, as the kernels do."""
    x, g, ct, st = _t(*_rotation_inputs(1, 2, 2, 33, 16))
    xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
    out = cr.circulant_rotate_fwd(xb, ct, st, True)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, cr.circulant_rotate_fwd(xb.float(), ct, st, True)
                               .to(torch.bfloat16), rtol=0, atol=0)
    dx, dct, dst = cr.circulant_rotate_bwd(gb, xb, ct, st, True)
    want = cr.circulant_rotate_bwd(gb.float(), xb.float(), ct, st, True)
    assert dx.dtype == torch.bfloat16 and dct.dtype == dst.dtype == torch.float32
    torch.testing.assert_close(dx, want[0].to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(dct, want[1], rtol=0, atol=0)
    torch.testing.assert_close(dst, want[2], rtol=0, atol=0)


def test_wrappers_take_the_head_split_views():
    """x and g as transposed views (last dim contiguous) give what their
    contiguous copies give."""
    x, g, ct, st = _t(*_rotation_inputs(2, 2, 3, 20, 16))
    xv, gv = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (x, g))
    assert not xv.is_contiguous() and xv.stride(-1) == 1
    torch.testing.assert_close(cr.circulant_rotate_fwd(xv, ct, st),
                               cr.circulant_rotate_fwd(x, ct, st), rtol=0, atol=0)
    for a, b in zip(cr.circulant_rotate_bwd(gv, xv, ct, st), cr.circulant_rotate_bwd(g, x, ct, st)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("keep_cls", [False, True])
def test_autograd_function_runs_the_backward(keep_cls):
    """The differentiable op is the autograd Function on every device; its
    gradients equal autograd through the plain forward."""
    x, g, ct, st = _t(*_rotation_inputs(3, 2, 2, 30, 16))
    leaves = {}
    for name, fn in (("op", lambda *a: cr.circulant_rotate(*a, keep_cls=keep_cls)),
                     ("plain", lambda *a: cr.circulant_rotate_fwd_reference(*a, keep_cls))):
        xs, cts, sts = (t.clone().requires_grad_() for t in (x, ct, st))
        out = fn(xs, cts, sts)
        if name == "op":
            assert "CirculantRotate" in type(out.grad_fn).__name__
        out.backward(g)
        leaves[name] = (out.detach(), xs.grad, cts.grad, sts.grad)
    for a, b in zip(leaves["op"], leaves["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with torch.inference_mode():
        assert cr.circulant_rotate(x.requires_grad_(), ct, st).grad_fn is None


def _bad_inputs():
    """name -> (x, ct, st, g) a wrapper refuses."""
    x, g, ct, st = _t(*_rotation_inputs(4, 1, 2, 9, 8))
    return {
        "float16": (x.half(), ct, st, None),
        "float64": (x.double(), ct, st, None),
        "rank": (x[0], ct, st, None),
        "table_length": (x, ct[:, :-1], st, None),
        "table_width_padded_to_d": (x, torch.zeros(2, 9, 8), st, None),
        "table_float64": (x, ct.double(), st, None),
        "table_non_contiguous": (x, ct, st.transpose(0, 1).contiguous().transpose(0, 1), None),
        "last_dim_strided": (x.transpose(2, 3).contiguous().transpose(2, 3), ct, st, None),
        "two_devices": (x, ct.to("meta"), st, None),
        "meta_device": (*(t.to("meta") for t in (x, ct, st)), None),
        "g_shape": (x, ct, st, g[:, :, :-1]),
        "g_dtype": (x, ct, st, g.to(torch.bfloat16)),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrappers_reject_bad_inputs_without_launching(case):
    x, ct, st, g = _bad_inputs()[case]
    before = (cr.circulant_rotate_fwd.launches, cr.circulant_rotate_bwd.launches)
    if g is None:
        with pytest.raises((ValueError, TypeError)):
            cr.circulant_rotate_fwd(x, ct, st)
    with pytest.raises((ValueError, TypeError)):
        cr.circulant_rotate_bwd(x if g is None else g, x, ct, st)
    assert (cr.circulant_rotate_fwd.launches, cr.circulant_rotate_bwd.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_counts_do_not_move_on_cpu(dtype):
    before = (cr.circulant_rotate_fwd.launches, cr.circulant_rotate_bwd.launches)
    x, g, ct, st = _t(*_rotation_inputs(5, 2, 2, 9, 8))
    x = x.to(dtype).requires_grad_()
    cr.circulant_rotate(x, ct, st, keep_cls=True).backward(g.to(dtype))
    assert x.grad.dtype == dtype
    assert (cr.circulant_rotate_fwd.launches, cr.circulant_rotate_bwd.launches) == before


def test_kernel_source_is_in_the_package():
    """One CUDA source builds into its own library, with the staged kernels
    and the bf16 mma.sync kernels (on the shared fragment helpers) behind
    one rule that launch_info reports; the backward sums over the batch in
    a fixed order (no float atomics)."""
    src = _build.CSRC / f"{cr._SOURCE}.cu"
    assert src.is_file() and _build.library_path(cr._SOURCE).parent == _build.BUILD_DIR
    text = src.read_text()
    assert "atomicAdd" not in text and "circulant_rotate_groups" in text
    for name in ("rot_fwd_kernel", "rot_bwd_kernel", "rot_fwd_mma_kernel", "rot_bwd_mma_kernel",
                 "group_sum_kernel", "rot_mma_takes", "circulant_rotate_launch_info",
                 '#include "flash_attention_mma.cuh"'):
        assert name in text, name
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


@pytest.mark.parametrize("case", ["kernel", "dtype", "n", "strides"])
def test_launch_info_rejects_bad_arguments_before_the_library(case, monkeypatch):
    """launch_info checks its arguments before it asks the built library
    (which needs a GPU)."""
    def no_library():
        raise AssertionError("the library was asked")

    monkeypatch.setattr(cr, "_lib", no_library)
    args = {"kernel": "circulant_rotate_fwd", "n": 197, "d": 64, "dtype": torch.bfloat16,
            "strides": (12 * 197 * 64, 197 * 64, 64)}
    args.update({"kernel": {"kernel": "circulant_rotate"}, "dtype": {"dtype": torch.float16},
                 "n": {"n": 0}, "strides": {"strides": (64,)}}[case])
    with pytest.raises((ValueError, TypeError)):
        cr.launch_info(**args)


# ─── tables, positions, DFT constants ───────────────────────────────────

@pytest.mark.parametrize("D", [8, 16, 64, 7])
def test_rdft_matrices_match_jax(D):
    for a, b in zip(rotations._rdft_matrices(D), jax_rot._rdft_matrices(D)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("coord_dim", [1, 2, 3])
@pytest.mark.parametrize("n", [0, 16, 196])
def test_grid_positions_match_jax(n, coord_dim):
    got = rotations.grid_positions_2d(n, coord_dim)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), jax_rot.grid_positions_2d(n, coord_dim))
    with pytest.raises(ValueError):
        rotations.grid_positions_2d(15)


@pytest.mark.parametrize("block", [None, 4])
def test_circulant_theta_and_eigenvalues_match_jax(block):
    _, _, _, _, pos, coeffs = _circulant_inputs(6, 1, 3, 17, 16, block=block)
    size = 16 if block is None else block
    got = rotations._circulant_theta(torch.from_numpy(pos), torch.from_numpy(coeffs), size)
    want = jax_rot._circulant_theta(pos, jnp.asarray(coeffs), size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    lam = rotations.circulant_eigenvalues(torch.from_numpy(coeffs))
    np.testing.assert_allclose(lam.numpy(), np.asarray(jax_rot.circulant_eigenvalues(
        jnp.asarray(coeffs))), rtol=1e-5, atol=1e-5)
    assert lam.real.abs().max() == 0


@pytest.mark.parametrize("theta", [10000.0, 500.0])
def test_rope_tables_match_jax(theta):
    for a, b in zip(rotations.rope_tables(50, 16, theta), jax_rot.rope_tables(50, 16, theta)):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(rotations.rope_2d_tables(49, 16), jax_rot.rope_2d_tables(49, 16)):
        np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError):
        rotations.rope_2d_tables(49, 18)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rope", "rope_2d"])
def test_rope_matches_jax(kind, dtype):
    q, k, _, _, _, _ = _circulant_inputs(7, 2, 3, 17, 16)
    tables = {"rope": (rotations.rope_tables(20, 16), jax_rot.rope_tables(20, 16)),
              "rope_2d": (rotations.rope_2d_tables(16, 16), jax_rot.rope_2d_tables(16, 16))}
    port_fn = {"rope": rotations.apply_rope, "rope_2d": rotations.apply_rope_2d}[kind]
    jax_fn = {"rope": jax_rot.apply_rope, "rope_2d": jax_rot.apply_rope_2d}[kind]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax_fn(jnp.asarray(q, jdt), jnp.asarray(k, jdt), *tables[kind][1])
    got = port_fn(*(torch.from_numpy(a).to(tdt) for a in (q, k)), *tables[kind][0])
    for a, b in zip(got, want):
        assert a.dtype == tdt
        b = np.asarray(b.astype(jnp.float32))
        # fp32 pairing in another order: 1e-6; bf16 results may round one
        # ulp apart from it
        tol = 1e-6 if dtype == "float32" else 2 ** -7
        np.testing.assert_allclose(a.float().numpy(), b, rtol=tol, atol=tol)
    if kind == "rope_2d":  # CLS untouched, bit for bit
        assert torch.equal(got[0][:, :, 0], torch.from_numpy(q[:, :, 0]).to(tdt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phi_hyperbolic_matches_jax(dtype):
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(2, 3, 17, 16)) * 0.5).astype(np.float32)
    omega = rng.normal(size=(3, 16, 40)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jax_fm.phi_hyperbolic(jnp.asarray(x, jdt), jnp.asarray(omega))
                      .astype(jnp.float32))
    got = feature_maps.phi_hyperbolic(torch.from_numpy(x).to(tdt), torch.from_numpy(omega))
    assert got.shape == (2, 3, 17, 80) and got.dtype == tdt
    tol = dict(rtol=1e-5, atol=1e-7) if dtype == "float32" else dict(rtol=2e-2, atol=1e-4)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


# ─── the rotations against the JAX chain ────────────────────────────────

ROTATIONS = {
    # name -> (block size or None, method)
    "circulant_rotation_pallas": (None, "pallas"),
    "circulant_rotation_chain": (None, "chain"),
    "circulant_string_pallas": (None, "pallas"),
    "circulant_string_chain": (None, "chain"),
    "block_circulant_rotation": (4, "chain"),
}


def _port_rotation(name, q, k, pos, coeffs, method):
    if name.startswith("circulant_rotation"):
        return (rotations.apply_circulant_rotation(q, pos, coeffs, method=method),)
    if name.startswith("circulant_string"):
        return rotations.apply_circulant_string(q, k, pos, coeffs, method=method)
    return (rotations.apply_block_circulant_rotation(q, pos, coeffs),)


def _jax_rotation(name, q, k, pos, coeffs):
    if name.startswith("circulant_rotation"):
        return (jax_rot.apply_circulant_rotation(q, pos, coeffs),)
    if name.startswith("circulant_string"):
        return jax_rot.apply_circulant_string(q, k, pos, coeffs)
    return (jax_rot.apply_block_circulant_rotation(q, pos, coeffs),)


def _rotation_case(name):
    block, method = ROTATIONS[name]
    cls = name.startswith("circulant_string")  # CLS + 4x4 patches, else 4x4
    q, k, gq, gk, pos, coeffs = _circulant_inputs(9, 2, 3, 16 + cls, 16, block=block, cls=cls)
    return method, q, k, gq, gk, pos, coeffs


@pytest.mark.parametrize("name", sorted(ROTATIONS))
def test_rotations_match_jax_fp32(name):
    method, q, k, _, _, pos, coeffs = _rotation_case(name)
    want = _jax_rotation(name, jnp.asarray(q), jnp.asarray(k), pos, jnp.asarray(coeffs))
    got = _port_rotation(name, *_t(q, k, pos, coeffs), method)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FP32_TOL)
    if name.startswith("circulant_string"):
        assert torch.equal(got[0][:, :, 0], torch.from_numpy(q[:, :, 0]))


@pytest.mark.parametrize("name", sorted(ROTATIONS))
def test_rotations_match_jax_bf16(name):
    method, q, k, _, _, pos, coeffs = _rotation_case(name)
    ref = _jax_rotation(name, jnp.asarray(q), jnp.asarray(k), pos, jnp.asarray(coeffs))
    jb = _jax_rotation(name, jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), pos,
                       jnp.asarray(coeffs))
    got = _port_rotation(name, *(t.to(torch.bfloat16) for t in _t(q, k)),
                         *_t(pos, coeffs), method)
    for a, b, r in zip(got, jb, ref):
        assert a.dtype == torch.bfloat16
        r = np.asarray(r)
        jax_err = np.abs(np.asarray(b.astype(jnp.float32)) - r).max()
        port_err = np.abs(a.float().numpy() - r).max()
        assert 0 < jax_err < 0.5
        assert port_err <= BF16_ERROR_FACTOR * jax_err, (port_err, jax_err)


@pytest.mark.parametrize("name", sorted(ROTATIONS))
def test_rotation_gradients_match_jax(name):
    """Gradients of <rotated, cotangent> for q, k and the circulant
    coefficients (through the angle tables into autograd) against JAX
    autodiff of its chain."""
    method, q, k, gq, gk, pos, coeffs = _rotation_case(name)
    cots = (gq, gk)

    def jax_loss(q, k, c):
        outs = _jax_rotation(name, q, k, pos, c)
        return sum(jnp.vdot(o, jnp.asarray(g)) for o, g in zip(outs, cots))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, coeffs)))
    tq, tk, tc = (t.requires_grad_() for t in _t(q, k, coeffs))
    outs = _port_rotation(name, tq, tk, torch.from_numpy(pos), tc, method)
    sum((o * torch.from_numpy(g)).sum() for o, g in zip(outs, cots)).backward()
    got = (tq.grad, tk.grad if tk.grad is not None else torch.zeros_like(tk), tc.grad)
    for label, a, b in zip(("q", "k", "coeffs"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5 * np.abs(b).max(),
                                   err_msg=label)


@pytest.mark.parametrize("method", ["pallas", "chain"])
def test_constants_cached_under_inference_mode_serve_autograd(method):
    """A model that serves (inference mode) and then trains: the DFT
    constants first built while serving must be usable by autograd."""
    for cache in (rotations._sin_dft_t, cr.rdft_matrices, cr._kernel_matrices):
        cache.cache_clear()
    q, k, gq, _, pos, coeffs = _t(*_circulant_inputs(11, 1, 2, 17, 16))
    with torch.inference_mode():
        rotations.apply_circulant_string(q, k, pos, coeffs, method=method)
    coeffs.requires_grad_()
    out, _ = rotations.apply_circulant_string(q, k, pos, coeffs, method=method)
    (out * gq).sum().backward()
    assert torch.isfinite(coeffs.grad).all() and coeffs.grad.abs().max() > 0


def test_rotation_methods():
    """'auto' takes the arm `_resolve` names from the caller's
    `prefer_kernel`: the kernel when the rotated q and k feed a kernel, the
    chain otherwise, bit for bit."""
    q, k, _, _, pos, coeffs = _t(*_circulant_inputs(10, 1, 2, 17, 16))
    for prefer, named in ((True, "pallas"), (False, "chain")):
        auto = rotations.apply_circulant_string(q, k, pos, coeffs, prefer_kernel=prefer)
        want = rotations.apply_circulant_string(q, k, pos, coeffs, method=named)
        for a, b in zip(auto, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown rotation method"):
        rotations.apply_circulant_string(q, k, pos, coeffs, method="fft")
    # a lone CLS token is returned as it is
    one = q[:, :, :1]
    assert rotations.apply_circulant_string(one, one, pos[:0], coeffs)[0] is one
