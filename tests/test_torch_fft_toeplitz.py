"""The port's Toeplitz products and KERPLE's `fft` arm against the JAX
package, on the CPU.

`toeplitz_matmul_fft` / `_dense` / `naive_toeplitz_matmul` and their
gradients against the JAX functions; `kerple_linear_attention(method="fft")`
against the JAX `_kerple_fft`, with its head-dim blocking and the block
shrink under `KERPLE_FFT_BLOCK_BUDGET` (patched small in both packages, at
test time, so that a test-sized shape triggers it); `KerpleRPE.apply_rpe_fft`
against the JAX module with the flax weights copied; and a small
`performer_favor_most_general` on the fft arm against the JAX model, logits
and gradients.

Tolerances: fp32 rtol 1e-5 with atol 1e-5 times the tensor's largest value
for the ops (both sides take fp32 / complex64 FFTs, summed in another
order); the models' fp32 rtol/atol 1e-4 of tests/test_torch_models.py (a
few layers). bf16: the port's error against the JAX fp32 result within
BF16_ERROR_FACTOR of the JAX bf16 op's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_rpe_vit_tpu.configs import mnist_config as jax_mnist_config
from efficient_rpe_vit_tpu.models import create_model as jax_create_model
from efficient_rpe_vit_tpu.models.rpe import KerpleRPE as JaxKerpleRPE
from efficient_rpe_vit_tpu.ops import attention_core as jax_core
from efficient_rpe_vit_tpu.ops import fft_toeplitz as jax_ft
from efficient_rpe_vit_tpu.train.training import cross_entropy_loss as jax_ce
from efficient_rpe_vit_torch.configs import mnist_config
from efficient_rpe_vit_torch.models import create_model
from efficient_rpe_vit_torch.models.rpe import KerpleRPE
from efficient_rpe_vit_torch.ops import attention_core, fft_toeplitz as ft
from efficient_rpe_vit_torch.ops.attention_core import kerple_linear_attention
from efficient_rpe_vit_torch.train import cross_entropy_loss
from efficient_rpe_vit_torch.utils import flax_to_state_dict, load_flax_variables

torch.set_num_threads(2)

TOL = 1e-5
MODEL_TOL = 1e-4
BF16_ERROR_FACTOR = 2.0
SMALL = dict(dim=64, heads=2, depth=2, mlp_dim=128, dropout=0.0)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30))


def _kerple_inputs(seed, B, H, N, F, D):
    rng = np.random.default_rng(seed)
    qp = np.abs(rng.normal(size=(B, H, N, F))).astype(np.float32) * 0.1
    kp = np.abs(rng.normal(size=(B, H, N, F))).astype(np.float32) * 0.1
    v = rng.normal(size=(B, H, N, D)).astype(np.float32)
    coeffs = np.exp(rng.normal(size=(H, 2 * N - 1)) * 0.02).astype(np.float32)
    return qp, kp, v, coeffs


# ─── Toeplitz products ──────────────────────────────────────────────────

PRODUCTS = {"fft": (ft.toeplitz_matmul_fft, jax_ft.toeplitz_matmul_fft),
            "dense": (ft.toeplitz_matmul_dense, jax_ft.toeplitz_matmul_dense),
            "naive": (ft.naive_toeplitz_matmul, jax_ft.naive_toeplitz_matmul)}


@pytest.mark.parametrize("kind", list(PRODUCTS))
@pytest.mark.parametrize("n", [1, 2, 17, 197, 300])
def test_toeplitz_products_and_gradients_match_jax(n, kind):
    """T @ x with c [3, 2n-1] broadcast over x [2, 3, n, 4], and the
    gradients of sum(w * T @ x) over (c, x)."""
    port_fn, jax_fn = PRODUCTS[kind]
    rng = np.random.default_rng(n)
    c = rng.normal(size=(3, 2 * n - 1)).astype(np.float32)
    x = rng.normal(size=(2, 3, n, 4)).astype(np.float32)
    w = rng.normal(size=(2, 3, n, 4)).astype(np.float32)
    ct, xt = (torch.from_numpy(a).requires_grad_() for a in (c, x))
    y = port_fn(ct, xt)
    (y * torch.from_numpy(w)).sum().backward()
    want = jax_fn(jnp.asarray(c), jnp.asarray(x))
    jgc, jgx = jax.grad(lambda c_, x_: jnp.sum(jnp.asarray(w) * jax_fn(c_, x_)),
                        argnums=(0, 1))(jnp.asarray(c), jnp.asarray(x))
    assert y.shape == want.shape and y.dtype == torch.float32
    _close(y.detach(), want)
    _close(ct.grad, jgc)
    _close(xt.grad, jgx)


@pytest.mark.parametrize("method", ["fft", "dense", "auto"])
def test_toeplitz_matmul_vector_and_dispatch(method):
    rng = np.random.default_rng(5)
    c = rng.normal(size=(2 * 40 - 1,)).astype(np.float32)
    x = rng.normal(size=(40,)).astype(np.float32)
    got = ft.toeplitz_matmul(torch.from_numpy(c), torch.from_numpy(x), method=method)
    assert got.shape == (40,)
    _close(got, jax_ft.naive_toeplitz_matmul(jnp.asarray(c), jnp.asarray(x)))
    _close(ft.naive_toeplitz_matmul(torch.from_numpy(c), torch.from_numpy(x)), got)


def test_toeplitz_matmul_rejects_bad_arguments():
    c, x = torch.ones(5), torch.ones(4, 2)
    with pytest.raises(ValueError):
        ft.toeplitz_matmul(c, x)
    with pytest.raises(ValueError):
        ft.toeplitz_matmul_fft(c, x)
    with pytest.raises(ValueError):
        ft.toeplitz_matmul(torch.ones(7), x, method="nope")


def test_toeplitz_fft_bf16_within_the_jax_bf16_error():
    rng = np.random.default_rng(6)
    c = np.exp(rng.normal(size=(2, 2 * 197 - 1)) * 0.1).astype(np.float32)
    x = rng.normal(size=(2, 2, 197, 16)).astype(np.float32)
    ref = np.asarray(jax_ft.toeplitz_matmul_fft(jnp.asarray(c), jnp.asarray(x)))
    j16 = jax_ft.toeplitz_matmul_fft(jnp.asarray(c), jnp.asarray(x).astype(jnp.bfloat16))
    got = ft.toeplitz_matmul_fft(torch.from_numpy(c), torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and j16.dtype == jnp.bfloat16
    jax_err = np.abs(np.asarray(j16.astype(jnp.float32)) - ref).max()
    port_err = np.abs(got.float().numpy() - ref).max()
    assert 0 < jax_err and port_err <= BF16_ERROR_FACTOR * jax_err, (port_err, jax_err)


# ─── KERPLE's fft arm ───────────────────────────────────────────────────

@pytest.mark.parametrize("fft_block", [1, 4, 16])
@pytest.mark.parametrize("n", [17, 197])
def test_kerple_fft_matches_jax_at_every_block(n, fft_block):
    qp, kp, v, coeffs = _kerple_inputs(n + fft_block, 2, 2, n, 12, 16)
    got = kerple_linear_attention(*(torch.from_numpy(a) for a in (qp, kp, v, coeffs)),
                                  method="fft", fft_block=fft_block)
    want = jax_core._kerple_fft(*(jnp.asarray(a) for a in (qp, kp, v, coeffs)), fft_block)
    _close(got, want)
    # blocking the head dim changes nothing but the batching of the FFTs
    whole = kerple_linear_attention(*(torch.from_numpy(a) for a in (qp, kp, v, coeffs)),
                                    method="fft", fft_block=16)
    _close(got, whole)
    # and the fft arm computes the dense arm's function
    _close(got, kerple_linear_attention(*(torch.from_numpy(a) for a in (qp, kp, v, coeffs)),
                                        method="dense"))


@pytest.mark.parametrize("D,blocks", [(12, 3), (7, 7), (16, 4)])
def test_kerple_fft_block_shrink_matches_jax(monkeypatch, D, blocks):
    """A budget of 5 lanes' bytes caps the block at 5 columns: fft_block=16
    shrinks to the largest divisor of D not above 5 (4, 1 and 4 here), so
    D2 plus D / block D1 products, in both packages."""
    B, H, N, F = 1, 2, 17, 8
    budget = 5 * B * H * N * F * 4
    monkeypatch.setattr(attention_core, "KERPLE_FFT_BLOCK_BUDGET", budget)
    monkeypatch.setattr(jax_core, "KERPLE_FFT_BLOCK_BUDGET", budget)
    calls = []
    real = attention_core.toeplitz_matmul_fft

    def spy(c, x):
        calls.append(x.shape[-1])
        return real(c, x)

    monkeypatch.setattr(attention_core, "toeplitz_matmul_fft", spy)
    qp, kp, v, coeffs = _kerple_inputs(D, B, H, N, F, D)
    got = kerple_linear_attention(*(torch.from_numpy(a) for a in (qp, kp, v, coeffs)),
                                  method="fft")
    want = jax_core.kerple_linear_attention(*(jnp.asarray(a) for a in (qp, kp, v, coeffs)),
                                            method="fft")
    _close(got, want)
    assert len(calls) == 1 + blocks
    assert calls[1:] == [F * D // blocks] * blocks


def test_kerple_fft_bf16_within_the_jax_bf16_error():
    qp, kp, v, coeffs = _kerple_inputs(8, 2, 2, 197, 44, 16)
    ref = np.asarray(jax_core._kerple_fft(*(jnp.asarray(a) for a in (qp, kp, v, coeffs)), 16))
    j16 = jax_core._kerple_fft(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (qp, kp, v)),
                               jnp.asarray(coeffs), 16)
    got = kerple_linear_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (qp, kp, v)),
                                  torch.from_numpy(coeffs), method="fft")
    assert got.dtype == torch.bfloat16
    jax_err = np.abs(np.asarray(j16.astype(jnp.float32)) - ref).max()
    port_err = np.abs(got.float().numpy() - ref).max()
    assert 0 < jax_err and port_err <= BF16_ERROR_FACTOR * jax_err, (port_err, jax_err)


# ─── KerpleRPE.apply_rpe_fft ────────────────────────────────────────────

@pytest.mark.parametrize("with_v", [False, True], ids=["D2", "D1"])
def test_apply_rpe_fft_matches_jax(with_v):
    B, H, N, F, D = 2, 3, 17, 6, 4
    qp, kp, v, _ = _kerple_inputs(9, B, H, N, F, D)
    jrpe = JaxKerpleRPE(num_patches=N, dim=H * D, heads=H)
    args = (jnp.asarray(kp),) + ((jnp.asarray(v),) if with_v else ())
    variables = jrpe.init(jax.random.PRNGKey(0), *args, method=JaxKerpleRPE.apply_rpe_fft)
    want = jrpe.apply(variables, *args, method=JaxKerpleRPE.apply_rpe_fft)
    rpe = KerpleRPE(N, H * D, H)
    with torch.no_grad():
        rpe.rel_pos_bias.copy_(torch.tensor(np.asarray(variables["params"]["rel_pos_bias"])))
    got = rpe.apply_rpe_fft(torch.from_numpy(kp), torch.from_numpy(v) if with_v else None)
    assert got.shape == ((B, H, N, F, D) if with_v else (B, H, N, F)) == want.shape
    _close(got.detach(), want)


# ─── a model on the fft arm ─────────────────────────────────────────────

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("patch", [7, 4], ids=["N17", "N50"])
def test_fft_model_logits_and_gradients_match_jax(patch):
    name, overrides = "performer_favor_most_general", dict(SMALL, patch_size=patch)
    jcfg = jax_mnist_config(**overrides)
    jmodel = jax_create_model(name, jcfg, rpe_config={"method": "fft"})
    m = jcfg.model
    variables = _np_tree(jmodel.init({"params": jax.random.PRNGKey(0)},
                                     jnp.zeros((1, m.image_size, m.image_size, m.in_channels))))
    tmodel = create_model(name, mnist_config(**overrides), rpe_config={"method": "fft"},
                          device="cpu")
    load_flax_variables(tmodel, variables["params"], variables.get("constants"),
                        variables.get("state"))
    rng = np.random.default_rng(patch)
    x = rng.normal(size=(3, m.image_size, m.image_size, m.in_channels)).astype(np.float32)
    y = rng.integers(0, m.num_classes, size=3).astype(np.int32)

    def jax_loss(params):
        logits = jmodel.apply({"params": params, "constants": variables["constants"]},
                              jnp.asarray(x), deterministic=True)
        return jax_ce(logits, jnp.asarray(y)), logits

    (_, want_logits), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(variables["params"])
    want = {k: v.numpy() for k, v in flax_to_state_dict(_np_tree(jgrads)).items()}
    tmodel.train()
    logits = tmodel(torch.from_numpy(x), torch.Generator())
    cross_entropy_loss(logits, torch.from_numpy(y).long()).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    got = {n: p.grad.numpy() for n, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    for n, g in got.items():
        np.testing.assert_allclose(g, want[n], rtol=MODEL_TOL,
                                   atol=MODEL_TOL * np.abs(want[n]).max(), err_msg=n)
