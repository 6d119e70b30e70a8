"""The port's fused-phi KERPLE attention (phi computed inside the forward
kernel) against the JAX package's, on the CPU.

On CPU tensors the wrapper runs the kernel's plain version; here it is held
against the JAX package's `kerple_attention_fused_phi` and its
`_fused_phi_fwd_impl` run in interpret mode, as tests/test_pallas_kernels.py
runs them, and the models with attention_config={"fused_phi": True} against
the JAX models with the same flag (whose fused op runs in interpret mode off
the TPU). The CUDA kernel itself is compared with the same plain version on
the GPU by chip_smoke.py. Inputs come from numpy.

Tolerances: fp32 outputs and den rtol/atol 1e-4 (summation order only);
gradients rtol 1e-4 plus atol 1e-4 times the tensor's largest gradient.
bf16: both sides round phi, the weights and the output to bf16 from fp32
sums taken in another order, so the port is held against the JAX fp32 op
and its error must stay within BF16_ERROR_FACTOR times the JAX bf16 op's
own error against the same fp32 result. Three-step trajectories: losses at
rtol 1e-5, parameters within PARAM_REL_TOL of how far JAX moved them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_rpe_vit_tpu.configs import mnist_config as jax_mnist_config
from efficient_rpe_vit_tpu.models import create_model as jax_create_model
from efficient_rpe_vit_tpu.ops.pallas import kerple_attention_fused_phi as jax_fused
from efficient_rpe_vit_tpu.ops.pallas.masked_linear_coeffs import (
    _fused_phi_fwd_impl as jax_fused_fwd_impl,
    _phi_tile as jax_phi_tile,
)
from efficient_rpe_vit_tpu.train import training as jax_training
from efficient_rpe_vit_torch.configs import mnist_config
from efficient_rpe_vit_torch.models import create_model
from efficient_rpe_vit_torch.ops.kernels import masked_linear_coeffs as mlc
from efficient_rpe_vit_torch.train import (
    create_train_state,
    cross_entropy_loss,
    make_train_step,
)
from efficient_rpe_vit_torch.utils import flax_to_state_dict, load_flax_variables

torch.set_num_threads(2)

KINDS = ["favor_plus", "relu"]
FIXTURE = (2, 2, 197, 16, 44)  # (B, H, N, D, F), the JAX package's kernel tests
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-4
BF16_ERROR_FACTOR = 2.0
PARAM_REL_TOL = 2e-3
SMALL = dict(dim=64, heads=2, depth=2, mlp_dim=128, dropout=0.0, patch_size=7)
FUSED = {"fused_phi": True}


def _inputs(seed, B, H, N, D, F):
    """L2-normalised q, k (the KERPLE contract), v, Omega and coefficients."""
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(B, H, N, D)).astype(np.float32) for _ in range(2))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rng.normal(size=(B, H, N, D)).astype(np.float32)
    omega = rng.normal(size=(H, D, F)).astype(np.float32)
    coeffs = np.exp(rng.normal(size=(H, 2 * N - 1)) * 0.02).astype(np.float32)
    return q, k, v, omega, coeffs


def _cotangent(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _assert_grads_close(got, want, names):
    for name, a, b in zip(names, got, want):
        b = np.asarray(b, dtype=np.float32)
        np.testing.assert_allclose(np.asarray(a, dtype=np.float32), b, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_SCALE * np.abs(b).max(), err_msg=name)


def _port_op_grads(arrays, g, kind, dtype=torch.float32):
    """(out, (dq, dk, dv, domega, dcoeffs)) of the port's op, fp32 numpy."""
    ts = [torch.from_numpy(a) for a in arrays]
    ts = [t.to(dtype) if i < 3 else t for i, t in enumerate(ts)]
    ts = [t.requires_grad_() for t in ts]
    out = mlc.kerple_attention_fused_phi(*ts, kind)
    out.backward(torch.from_numpy(g).to(dtype))
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in ts]


@functools.cache
def _jax_op_grads_cached(seed, kind, dtype):
    """The JAX op's output and gradients for the fixture inputs of `seed`
    (shared by the fp32 and bf16 tests: interpret mode is slow)."""
    arrays = _inputs(seed, *FIXTURE)
    return _jax_op_grads(arrays, _cotangent(seed + 1, FIXTURE[:4]), kind, dtype)


def _jax_op_grads(arrays, g, kind, dtype=jnp.float32):
    args = [jnp.asarray(a) for a in arrays]
    args = [a.astype(dtype) if i < 3 else a for i, a in enumerate(args)]
    out, vjp = jax.vjp(lambda *a: jax_fused(*a, kind, 128, 128, True), *args)
    grads = vjp(jnp.asarray(g).astype(out.dtype))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(x.astype(jnp.float32)) for x in grads])


# ─── the op and its plain version ───────────────────────────────────────

@pytest.mark.parametrize("kind", KINDS)
def test_op_forward_and_gradients_match_jax_fp32(kind):
    out, grads = _port_op_grads(_inputs(0, *FIXTURE), _cotangent(1, FIXTURE[:4]), kind)
    j_out, j_grads = _jax_op_grads_cached(0, kind, jnp.float32)
    np.testing.assert_allclose(out, j_out, **FP32_TOL)
    _assert_grads_close(grads, j_grads, ["dq", "dk", "dv", "domega", "dcoeffs"])


@pytest.mark.parametrize("kind", KINDS)
def test_op_bf16_within_twice_jax_bf16_error(kind):
    """bf16 q, k, v (Omega and coeffs fp32): forward and gradients of q, k,
    v, Omega and coeffs against the JAX fp32 op."""
    ref_out, ref_grads = _jax_op_grads_cached(0, kind, jnp.float32)
    j_out, j_grads = _jax_op_grads_cached(0, kind, jnp.bfloat16)
    out, grads = _port_op_grads(_inputs(0, *FIXTURE), _cotangent(1, FIXTURE[:4]), kind,
                                torch.bfloat16)
    for name, got, jax16, ref in zip(["out", "dq", "dk", "dv", "domega", "dcoeffs"],
                                     [out] + grads, [j_out] + j_grads, [ref_out] + ref_grads):
        jax_err = np.abs(jax16 - ref).max()
        port_err = np.abs(got - ref).max()
        # ReLU features' gradients are rough in bf16 (a rounded u flips the
        # sign of some relu(u)): JAX's own dq error reaches ~17% of max|dq|
        assert 0 < jax_err < 0.5 * np.abs(ref).max(), (name, jax_err)
        assert port_err <= BF16_ERROR_FACTOR * jax_err, (name, port_err, jax_err)


@pytest.mark.parametrize("shape", [FIXTURE, (3, 2, 17, 16, 44)], ids=["N197", "N17"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_matches_jax_fused_kernel(kind, shape):
    """The wrapper on CPU tensors (the plain version) against the JAX
    fused-phi Pallas kernel in interpret mode, out and den."""
    arrays = _inputs(4, *shape)
    out, den = mlc.kerple_attention_fused_phi_fwd(*(torch.from_numpy(a) for a in arrays), kind)
    j_out, j_den = jax_fused_fwd_impl(*(jnp.asarray(a) for a in arrays), feature_kind=kind,
                                      block_q=128, block_kv=128, interpret=True)
    assert out.dtype == torch.float32 and den.shape == shape[:3]
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **FP32_TOL)
    np.testing.assert_allclose(den.numpy(), np.asarray(j_den), **FP32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_feature_map_follows_the_kernel_tile_rules(kind, dtype):
    """fused_phi_reference against the JAX kernel's own `_phi_tile` (Omega
    rounded to x's dtype, fp32 norm, max over real lanes, 1/sqrt(F))."""
    q, _, _, omega, _ = _inputs(5, 1, 2, 33, 16, 44)
    got = mlc.fused_phi_reference(torch.from_numpy(q).to(getattr(torch, dtype)),
                                  torch.from_numpy(omega), kind)
    assert got.dtype == getattr(torch, dtype)
    for h in range(2):
        want = jax_phi_tile(jnp.asarray(q[0, h]).astype(dtype), jnp.asarray(omega[h]),
                            kind, 44, 44)
        want = np.asarray(want.astype(dtype).astype(jnp.float32))
        np.testing.assert_allclose(got[0, h].float().numpy(), want, rtol=1e-5, atol=1e-7)


def test_wrapper_checks_its_inputs_and_counts_no_cpu_launch():
    q, k, v, omega, c = (torch.from_numpy(a) for a in _inputs(6, 1, 2, 9, 8, 12))
    before = mlc.kerple_attention_fused_phi_fwd.launches
    out, den = mlc.kerple_attention_fused_phi_fwd(q, k, v, omega, c)
    assert out.shape == (1, 2, 9, 8) and den.shape == (1, 2, 9)
    assert mlc.kerple_attention_fused_phi_fwd.launches == before
    bad = {
        "kind": ((q, k, v, omega, c), "favor_hyper"),
        "k_shape": ((q, k[:, :, :-1], v, omega, c), "relu"),
        "omega_heads": ((q, k, v, omega[:1], c), "relu"),
        "omega_dtype": ((q, k, v, omega.double(), c), "relu"),
        "coeffs_length": ((q, k, v, omega, c[:, :-2]), "relu"),
        "mixed_dtype": ((q, k, v.to(torch.bfloat16), omega, c), "relu"),
        "float16": ((q.half(), k.half(), v.half(), omega, c), "relu"),
        "non_contiguous": ((q.transpose(2, 3).contiguous().transpose(2, 3), k, v, omega, c),
                           "relu"),
        "two_devices": ((q, k, v, omega.to("meta"), c), "relu"),
    }
    for name, (args, kind) in bad.items():
        with pytest.raises((ValueError, TypeError)):
            mlc.kerple_attention_fused_phi_fwd(*args, kind)


def test_omega_gradient_only_when_asked():
    """The model's Omega is a buffer: no gradient is formed for it, and the
    other gradients do not change."""
    q, k, v, omega, c = (torch.from_numpy(a) for a in _inputs(7, 1, 2, 17, 16, 44))
    g = torch.from_numpy(_cotangent(8, (1, 2, 17, 16)))
    grads = {}
    for need_omega in (True, False):
        ts = [t.clone().requires_grad_(i != 3 or need_omega)
              for i, t in enumerate((q, k, v, omega, c))]
        mlc.kerple_attention_fused_phi(*ts).backward(g)
        grads[need_omega] = [t.grad for t in ts]
    assert grads[False][3] is None and grads[True][3] is not None
    for a, b in zip(grads[True][:3] + grads[True][4:], grads[False][:3] + grads[False][4:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kernel_source_is_in_the_package():
    from efficient_rpe_vit_torch.ops.kernels import _build

    assert (_build.CSRC / f"{mlc._FUSED_SOURCE}.cu").is_file()
    assert (_build.CSRC / "kerple_common.cuh").is_file()
    assert _build.library_path(mlc._FUSED_SOURCE).parent == _build.BUILD_DIR


# ─── models with fused_phi ──────────────────────────────────────────────

def _pair(name, overrides, dtype="float32"):
    """(jax model with fused phi, its variables as numpy trees, port model
    with fused phi and the same variables)."""
    jcfg = jax_mnist_config(**overrides, compute_dtype=dtype)
    jmodel = jax_create_model(name, jcfg, attention_config=FUSED)
    m = jcfg.model
    sample = jnp.zeros((1, m.image_size, m.image_size, m.in_channels))
    # the flag adds no variable: initialise through the dense path, which
    # skips tracing the interpret-mode kernel
    init_model = jax_create_model(name, jcfg, rpe_config={"method": "dense"})
    variables = jax.tree_util.tree_map(
        np.asarray, init_model.init({"params": jax.random.PRNGKey(0)}, sample))
    tmodel = create_model(name, mnist_config(**overrides, compute_dtype=dtype),
                          attention_config=FUSED, device="cpu")
    load_flax_variables(tmodel, variables["params"], variables.get("constants"))
    return jmodel, variables, tmodel


def _batch(cfg, batch, seed):
    m = cfg.model
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, m.image_size, m.image_size, m.in_channels)).astype(np.float32)
    return x, rng.integers(0, m.num_classes, size=batch).astype(np.int32)


@pytest.mark.parametrize("name", ["performer_favor_most_general", "performer_relu_most_general"])
def test_model_logits_and_gradients_match_jax(name):
    jmodel, variables, tmodel = _pair(name, SMALL)
    assert all(b.attention.fused_phi for b in tmodel.transformer_blocks)
    x, y = _batch(jax_mnist_config(**SMALL), 3, seed=0)

    def loss(params):
        logits = jmodel.apply({"params": params, "constants": variables["constants"]},
                              jnp.asarray(x), deterministic=True)
        return jax_training.cross_entropy_loss(logits, jnp.asarray(y)), logits

    (_, want), j_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **FP32_TOL)
    j_grads = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, j_grads))
    tmodel.train()
    cross_entropy_loss(tmodel(torch.from_numpy(x), torch.Generator()),
                       torch.from_numpy(y).long()).backward()
    named = dict(tmodel.named_parameters())
    assert set(named) == set(j_grads)
    _assert_grads_close([named[n].grad.numpy() for n in sorted(named)],
                        [j_grads[n].numpy() for n in sorted(named)], sorted(named))


def test_three_train_steps_match_jax():
    name = "performer_favor_most_general"
    jmodel, variables, tmodel = _pair(name, SMALL)
    jcfg = jax_mnist_config(**SMALL)
    sample = jnp.zeros((1, jcfg.model.image_size, jcfg.model.image_size,
                        jcfg.model.in_channels))
    jstate = jax_training.create_train_state(jmodel, jcfg, jax.random.PRNGKey(0), sample,
                                             steps_per_epoch=2)
    jstep = jax_training.make_train_step(jmodel)
    state = create_train_state(tmodel, mnist_config(**SMALL), steps_per_epoch=2)
    step = make_train_step(tmodel, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        x, y = _batch(jcfg, 4, seed=10 + i)
        jstate, jloss, jcorrect = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                                        jax.random.PRNGKey(i))
        state, loss, correct = step(state, torch.from_numpy(x), torch.from_numpy(y), gen)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        assert correct.item() == int(jcorrect)
    start = flax_to_state_dict(variables["params"])
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))
    for n, p in tmodel.named_parameters():
        moved = np.linalg.norm(want[n].numpy() - start[n].numpy())
        diff = np.linalg.norm(p.detach().numpy() - want[n].numpy())
        assert moved > 0 and diff <= PARAM_REL_TOL * moved, (n, diff, moved)


def test_model_bf16_within_twice_jax_bf16_error():
    name = "performer_favor_most_general"
    jmodel32, variables, _ = _pair(name, SMALL)
    jmodel16, _, tmodel16 = _pair(name, SMALL, dtype="bfloat16")
    x, _ = _batch(jax_mnist_config(**SMALL), 8, seed=1)
    v = {"params": variables["params"], "constants": variables["constants"]}
    ref, logits16 = (np.asarray(jax.jit(lambda v, x: m.apply(v, x, deterministic=True))(
        v, jnp.asarray(x)).astype(jnp.float32)) for m in (jmodel32, jmodel16))
    jax_err = np.abs(logits16 - ref).max()
    load_flax_variables(tmodel16, variables["params"], variables["constants"])
    with torch.inference_mode():
        port_err = np.abs(tmodel16(torch.from_numpy(x)).numpy() - ref).max()
    assert 0 < jax_err < 0.5
    assert port_err <= BF16_ERROR_FACTOR * jax_err, (port_err, jax_err)


def test_favor_hyper_with_fused_phi_raises():
    """As in the JAX package, the fused kernel computes FAVOR+ and ReLU
    features only; without KERPLE the flag changes nothing."""
    cfg = mnist_config(**SMALL)
    model = create_model("favor_hyper_most_general", cfg, attention_config=FUSED,
                         device="cpu")
    with pytest.raises(NotImplementedError, match="fused_phi"):
        model(torch.zeros(1, 28, 28, 1))
    plain = create_model("favor_hyper", cfg, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    flagged = create_model("favor_hyper", cfg, attention_config=FUSED, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(_batch(jax_mnist_config(**SMALL), 2, seed=3)[0])
    with torch.inference_mode():
        torch.testing.assert_close(flagged(x), plain(x), rtol=0, atol=0)
