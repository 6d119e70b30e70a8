"""The port's soft-MoE MLP and per-block remat against the JAX package's, on
the CPU.

`MoeMlp` is held to the JAX `MoeMlp` with the flax parameters carried
across (`moe_mlp_state_dict` / `load_flax_variables`): fp32 output and
input / parameter gradients at rtol / atol 1e-4 (summation order only);
bf16 within BF16_ERROR_FACTOR of the JAX bf16 module's own error against
the fp32 result (both round activations to bf16, at slightly different
places). The MoE model built as JAX tests/test_moe.py builds it trains two
steps in both packages at dropout 0 (the frameworks' RNGs differ): losses
at rtol 1e-5. Parameter counts equal JAX's exactly.

Remat (`ViT(remat=True)`): logits and gradients against the plain model at
dropout 0 with JAX tests/test_models.py's remat tolerances; with dropout
live the recompute takes back the forward's draws, so the gradients are
bitwise those of the plain model, the generator ends where the plain one
does, and a feature-redraw counter advances once per step.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_rpe_vit_tpu.configs import mnist_config as jax_mnist_config
from efficient_rpe_vit_tpu.models import create_model as jax_create_model
from efficient_rpe_vit_tpu.models.factory import count_parameters as jax_count_parameters
from efficient_rpe_vit_tpu.models.layers import MoeMlp as JaxMoeMlp
from efficient_rpe_vit_tpu.train import training as jax_training
from efficient_rpe_vit_torch.configs import mnist_config
from efficient_rpe_vit_torch.models import MoeMlp, count_parameters, create_model
from efficient_rpe_vit_torch.models import attention as port_attention
from efficient_rpe_vit_torch.models.dense import torch_dtype
from efficient_rpe_vit_torch.train import create_train_state, make_multi_step, make_train_step
from efficient_rpe_vit_torch.utils import load_flax_variables, moe_mlp_state_dict

torch.set_num_threads(2)

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ERROR_FACTOR = 2.0
MOE = {"mlp_type": "moe", "num_experts": 4}
SMALL = dict(dim=32, heads=2, depth=2, mlp_dim=64)
# the reference variants: every MODEL_VARIANTS name but the aliases and
# the rejected softmax + KERPLE
VARIANTS = ["baseline", "baseline_circulant", "baseline_rope", "performer_favor",
            "performer_favor_most_general", "performer_favor_circulant",
            "performer_favor_rope", "performer_relu", "performer_relu_most_general",
            "performer_relu_circulant", "performer_relu_rope"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ─── MoeMlp against the JAX module ──────────────────────────────────────

def _moe_pair(dtype="float32", B=2, N=9, C=32, M=48, E=4):
    jmod = JaxMoeMlp(dim=C, mlp_dim=M, num_experts=E, dropout=0.0, dtype=dtype)
    x = np.random.default_rng(0).normal(size=(B, N, C)).astype(np.float32)
    params = _np_tree(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    tmod = MoeMlp(C, M, num_experts=E, compute_dtype=torch_dtype(dtype))
    tmod.load_state_dict(moe_mlp_state_dict(params), strict=True)
    return jmod, params, tmod, x


def _jax_moe(jmod, params, x, cot):
    def f(p, xx):
        out = jmod.apply({"params": p}, xx)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, out), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    return (np.asarray(out.astype(jnp.float32)), np.asarray(gx),
            {k: v.numpy() for k, v in moe_mlp_state_dict(_np_tree(gp)).items()})


def _port_moe(tmod, x, cot):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tmod(xt)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in tmod.named_parameters()}
    return out.detach().float().numpy(), xt.grad.numpy(), grads


def test_moe_mlp_matches_jax_fp32():
    jmod, params, tmod, x = _moe_pair()
    cot = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    want_out, want_gx, want_gp = _jax_moe(jmod, params, x, cot)
    out, gx, gp = _port_moe(tmod, x, cot)
    np.testing.assert_allclose(out, want_out, **FP32_TOL)
    np.testing.assert_allclose(gx, want_gx, **FP32_TOL)
    assert set(gp) == set(want_gp) == {"router.weight", "router.bias", "w1", "b1", "w2", "b2"}
    for name, g in gp.items():
        np.testing.assert_allclose(g, want_gp[name], err_msg=name, **FP32_TOL)


def test_moe_mlp_matches_jax_bf16():
    jmod32, params, _, x = _moe_pair()
    jmod16, _, tmod16, _ = _moe_pair("bfloat16")
    tmod16.load_state_dict(moe_mlp_state_dict(params))
    cot = np.zeros(x.shape, np.float32)
    ref = _jax_moe(jmod32, params, x, cot)[0]
    jax_err = np.abs(_jax_moe(jmod16, params, x, cot)[0] - ref).max()
    port_err = np.abs(_port_moe(tmod16, x, cot)[0] - ref).max()
    assert 0 < port_err <= BF16_ERROR_FACTOR * jax_err, (port_err, jax_err)


def test_moe_init_follows_flax_fan_rule():
    """Expert kernels [E, C, M] / [E, M, C]: uniform within sqrt(6 / (E (C +
    M))), flax's xavier_uniform with E as a receptive field; biases zero."""
    E, C, M = 4, 32, 48
    limit = math.sqrt(6.0 / (E * (C + M)))
    jmod, params, _, _ = _moe_pair(C=C, M=M, E=E)
    model = create_model("performer_favor", mnist_config(**SMALL), mlp_config=MOE,
                         mlp_dim=M, device="cpu")
    mlp = model.transformer_blocks[0].mlp
    assert mlp.init_limit == pytest.approx(limit, rel=1e-12)
    for w in (mlp.w1.detach().numpy(), mlp.w2.detach().numpy(), params["w1"], params["w2"]):
        assert np.abs(w).max() <= limit
        assert np.abs(w).max() > 0.95 * limit
        assert np.var(w) == pytest.approx(limit ** 2 / 3, rel=0.1)
    assert not mlp.b1.any() and not mlp.b2.any()


def test_moe_model_builds_and_differs_from_dense():
    cfg = mnist_config(dropout=0.0)
    moe = create_model("performer_favor", cfg, mlp_config=MOE, device="cpu")
    dense = create_model("performer_favor", cfg, device="cpu")
    sd = moe.state_dict()
    assert sd["transformer_blocks.0.mlp.w1"].shape == (4, 32, 64)
    assert "transformer_blocks.0.mlp.router.weight" in sd
    assert "transformer_blocks.0.mlp.0.weight" in dense.state_dict()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 28, 28, 1)).astype(np.float32))
    with torch.inference_mode():
        out = moe(x)
    assert out.shape == (4, 10) and bool(torch.isfinite(out).all())


def test_expert_parallel_arguments_raise():
    for kwargs in ({"expert_mesh": object()}, {"expert_axis": "expert"}):
        with pytest.raises(NotImplementedError, match="Queue A #7"):
            create_model("performer_favor", mnist_config(), device="cpu",
                         mlp_config=dict(MOE, **kwargs))


@pytest.mark.parametrize("name", ["performer_favor", "performer_favor_most_general"])
def test_moe_model_trains_two_steps_as_jax(name):
    """The MoE model of JAX tests/test_moe.py (mnist_config, 4 experts) at
    dropout 0, its flax variables carried into the port: two adam steps
    with the same losses and corrects."""
    jcfg = jax_mnist_config(dropout=0.0)
    jmodel = jax_create_model(name, jcfg, mlp_config=MOE, rpe_config={"method": "dense"})
    sample = jnp.zeros((2, 28, 28, 1))
    variables = _np_tree(jmodel.init({"params": jax.random.PRNGKey(0)}, sample))
    tmodel = create_model(name, mnist_config(dropout=0.0), mlp_config=MOE, device="cpu")
    load_flax_variables(tmodel, variables["params"], variables.get("constants"))
    jstate = jax_training.create_train_state(jmodel, jcfg, jax.random.PRNGKey(0), sample,
                                             steps_per_epoch=10)
    jstep = jax_training.make_train_step(jmodel, donate=False)
    state = create_train_state(tmodel, mnist_config(dropout=0.0), steps_per_epoch=10)
    step = make_train_step(tmodel, device="cpu")
    rng = np.random.default_rng(7)
    for i in range(2):
        x = rng.normal(size=(16, 28, 28, 1)).astype(np.float32)
        y = (np.arange(16) % 10).astype(np.int32)
        jstate, jloss, jcorrect = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                                        jax.random.PRNGKey(i))
        state, loss, correct = step(state, torch.from_numpy(x), torch.from_numpy(y),
                                    torch.Generator())
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        assert correct.item() == int(jcorrect)
    router = tmodel.transformer_blocks[0].mlp.router.weight
    assert router.grad is not None and bool(router.grad.abs().max() > 0)


@pytest.mark.parametrize("name,mlp", [(n, None) for n in VARIANTS]
                         + [("performer_favor_most_general", MOE), ("baseline", MOE)])
def test_count_parameters_matches_jax(name, mlp):
    """Parameters only: Omega and the redraw counters (flax constants and
    state) are not counted, whether the port counts a model or its state
    dict."""
    jmodel = jax_create_model(name, jax_mnist_config(), mlp_config=mlp)
    variables = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 28, 28, 1)))
    want = jax_count_parameters(variables["params"])
    attn = ({"feature_redraw_interval": 3} if name.startswith("performer") else None)
    model = create_model(name, mnist_config(), mlp_config=mlp, attention_config=attn,
                         device="cpu")
    assert count_parameters(model) == want
    assert count_parameters(model.state_dict()) == want


# ─── remat ──────────────────────────────────────────────────────────────

def _images(batch=4, seed=2):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(batch, 28, 28, 1)).astype(np.float32))


def _twins(name, dropout, mlp=None, attention_config=None, **overrides):
    """(plain, remat) models with the same weights."""
    cfg = mnist_config(dropout=dropout, **overrides)
    return [create_model(name, cfg, mlp_config=mlp, attention_config=attention_config,
                         remat=remat, device="cpu", generator=torch.Generator().manual_seed(1))
            for remat in (False, True)]


@pytest.mark.parametrize("where", ["argument", "config"])
def test_remat_from_the_argument_or_the_config(where):
    """`create_model(remat=True)` or a config whose flat dict has remat=True
    (as in the JAX factory) builds the remat model; the default does not."""
    cfg = mnist_config(**SMALL)
    if where == "config":
        model = create_model("performer_favor", dict(cfg.to_dict(), remat=True), device="cpu")
    else:
        model = create_model("performer_favor", cfg, remat=True, device="cpu")
    assert model.remat and not create_model("performer_favor", cfg, device="cpu").remat


def _train_forward_backward(model, x, seed=0):
    """Train-mode logits and parameter gradients of sum(logits^2), the
    generator's state after them, and how often each block's attention ran."""
    calls = []
    hooks = [b.attention.register_forward_hook(lambda *a: calls.append(1))
             for b in model.transformer_blocks]
    model.train()
    g = torch.Generator().manual_seed(seed)
    out = model(x, g)
    out.square().sum().backward()
    for h in hooks:
        h.remove()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return out.detach(), grads, g.get_state(), len(calls)


@pytest.mark.parametrize("name,mlp", [("performer_favor_most_general", None),
                                      ("performer_favor_most_general", MOE),
                                      ("baseline_circulant", None)])
def test_remat_matches_plain_at_dropout_0(name, mlp):
    """JAX tests/test_models.py::test_remat_matches_plain's tolerances:
    logits rtol / atol 1e-6, gradients rtol 1e-4 / atol 1e-5. The recompute
    runs each block's attention a second time."""
    plain, remat = _twins(name, 0.0, mlp)
    x = _images()
    out, grads, _, calls = _train_forward_backward(plain, x)
    out_r, grads_r, _, calls_r = _train_forward_backward(remat, x)
    depth = len(plain.transformer_blocks)
    assert (calls, calls_r) == (depth, 2 * depth)
    np.testing.assert_allclose(out_r.numpy(), out.numpy(), rtol=1e-6, atol=1e-6)
    for n, g in grads.items():
        np.testing.assert_allclose(grads_r[n].numpy(), g.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("name,mlp", [("performer_favor_most_general", None),
                                      ("performer_relu_most_general", MOE),
                                      ("baseline_rope", None),
                                      ("baseline_circulant", MOE)])
def test_remat_gradients_bitwise_at_dropout(name, mlp):
    """Dropout 0.1 (output, MLP and, for softmax, the probabilities' seed):
    the recompute takes back the forward's draws, so logits, gradients and
    the generator's final state are bitwise those of the plain model."""
    plain, remat = _twins(name, 0.1, mlp)
    x = _images()
    out, grads, state, _ = _train_forward_backward(plain, x)
    out_r, grads_r, state_r, _ = _train_forward_backward(remat, x)
    assert torch.equal(out_r, out)
    assert torch.equal(state_r, state)
    for n, g in grads.items():
        assert torch.equal(grads_r[n], g), n


def test_remat_with_the_phi_checkpoint_inside(monkeypatch):
    """The attention's own phi checkpoint nested in the block's: still
    bitwise the plain gradients at dropout 0.1."""
    monkeypatch.setattr(port_attention, "PHI_CHECKPOINT_BYTES", 0)
    plain, remat = _twins("performer_favor_most_general", 0.1)
    x = _images()
    _, grads, _, _ = _train_forward_backward(plain, x)
    _, grads_r, _, _ = _train_forward_backward(remat, x)
    for n, g in grads.items():
        assert torch.equal(grads_r[n], g), n


def test_remat_redraw_counts_once_per_step():
    """Feature redraw every 2 calls under remat: the recompute neither
    redraws Omega nor counts, so after 3 train steps each counter reads 3
    and Omega equals the plain model's after every step."""
    attn = {"feature_redraw_interval": 2}
    plain, remat = _twins("performer_favor", 0.1, attention_config=attn)
    cfg = mnist_config(dropout=0.1)
    states = [create_train_state(m, cfg) for m in (plain, remat)]
    steps = [make_train_step(m, device="cpu") for m in (plain, remat)]
    gens = [torch.Generator().manual_seed(4) for _ in range(2)]
    y = torch.arange(4) % 10
    for i in range(3):
        x = _images(seed=10 + i)
        losses = [step(s, x, y, g)[1] for step, s, g in zip(steps, states, gens)]
        assert torch.equal(losses[0], losses[1])
        for a, b in zip(plain.transformer_blocks, remat.transformer_blocks):
            assert int(b.attention.redraw_counter) == int(a.attention.redraw_counter) == i + 1
            assert torch.equal(b.attention.omega, a.attention.omega)
    for (n, p), q in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(p, q), n


def test_remat_in_multi_step_cpu_loop():
    """make_multi_step's CPU loop over a remat MoE model: bitwise the plain
    model's K steps (losses, corrects, parameters) at dropout 0.1."""
    plain, remat = _twins("performer_favor_most_general", 0.1, MOE)
    cfg = mnist_config(dropout=0.1)
    rng = np.random.default_rng(5)
    xs = torch.from_numpy(rng.normal(size=(3, 4, 28, 28, 1)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, size=(3, 4)))
    outs = []
    for model in (plain, remat):
        state = create_train_state(model, cfg)
        outs.append(make_multi_step(model, device="cpu")(
            state, xs, ys, torch.Generator().manual_seed(6))[1:])
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    for (n, p), q in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(p, q), n


def test_remat_is_bypassed_in_eval_and_inference():
    """Eval mode (even with gradients on) and inference mode run each block
    once, with the plain model's logits."""
    plain, remat = _twins("performer_favor_most_general", 0.1)
    x = _images()
    for model in (plain, remat):
        model.eval()
    calls = []
    for b in remat.transformer_blocks:
        b.attention.register_forward_hook(lambda *a: calls.append(1))
    out = remat(x)
    out.sum().backward()
    assert len(calls) == len(remat.transformer_blocks)
    with torch.inference_mode():
        assert torch.equal(remat(x), plain(x))
