"""The port's RoPE, RoPE2D, Circulant-STRING and hyperbolic-feature models
against the JAX package, on the CPU.

Every variant is built small (dim 64, 2 heads, depth 2, 28x28 images at
patch 7, N=17), initialised by flax and carried into the port with
`load_flax_variables`. The JAX model runs its CPU paths: the XLA DFT chain
for the circulant rotation, dense KERPLE. The port runs each circulant
model on both rotation arms: 'pallas' (the rotation kernels' plain version
on CPU tensors) and 'chain'. Images come from numpy.

Tolerances, as tests/test_torch_models.py and test_torch_softmax.py: fp32
logits rtol/atol 1e-4, fp32 gradients rtol 1e-4 with atol 1e-4 of the
tensor's largest value (summation order through a few layers); bf16 within
2x of the JAX bf16 model's own error against JAX fp32; three-step losses
rtol 1e-5, parameters within 2e-3 of how far they moved.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_rpe_vit_tpu.configs import mnist_config as jax_mnist_config
from efficient_rpe_vit_tpu.models import create_model as jax_create_model
from efficient_rpe_vit_tpu.train import training as jax_training
from efficient_rpe_vit_tpu.utils.import_torch import state_dict_to_params
from efficient_rpe_vit_torch.configs import mnist_config
from efficient_rpe_vit_torch.models import (
    MODEL_VARIANTS,
    CirculantStringRPE,
    FavorHyperAttention,
    KerpleRPE,
    RoPE,
    RoPE2D,
    create_model,
)
from efficient_rpe_vit_torch.train import (
    create_train_state,
    cross_entropy_loss,
    make_train_step,
)
from efficient_rpe_vit_torch.utils import flax_to_state_dict, load_flax_variables

torch.set_num_threads(2)

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-4
BF16_ERROR_FACTOR = 2.0
PARAM_REL_TOL = 2e-3
SMALL = dict(dim=64, heads=2, depth=2, mlp_dim=128, dropout=0.0, patch_size=7)
BLOCK = {"block_size": 16, "enable_block_circulant": True}

# case -> (variant name, port rpe_config, JAX rpe_config)
CASES = {
    "baseline": ("baseline", None, None),
    "baseline_rope": ("baseline_rope", None, None),
    "softmax_rope_2d": ("softmax_rope_2d", None, None),
    "performer_favor": ("performer_favor", None, None),
    "performer_favor_most_general": ("performer_favor_most_general", None, {"method": "dense"}),
    "performer_favor_rope": ("performer_favor_rope", None, None),
    "favor_plus_rope_2d": ("favor_plus_rope_2d", None, None),
    "performer_relu": ("performer_relu", None, None),
    "performer_relu_most_general": ("performer_relu_most_general", None, {"method": "dense"}),
    "performer_relu_rope": ("performer_relu_rope", None, None),
    "favor_hyper": ("favor_hyper", None, None),
    "baseline_circulant_block": ("baseline_circulant", BLOCK, BLOCK),
}
for _name in ("baseline_circulant", "performer_favor_circulant", "performer_relu_circulant",
              "favor_hyper_circulant"):
    for _arm in ("pallas", "chain"):
        CASES[f"{_name}-{_arm}"] = (_name, {"method": _arm}, None)


def _images(batch, seed):
    m = jax_mnist_config(**SMALL).model
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, m.image_size, m.image_size, m.in_channels)).astype(np.float32)
    y = rng.integers(0, m.num_classes, size=batch).astype(np.int32)
    return x, y


@functools.lru_cache(maxsize=None)
def _jax_model(name, jax_rpe, dtype="float32"):
    """(JAX model, its variables as numpy), initialised from key 0."""
    jcfg = jax_mnist_config(**SMALL, compute_dtype=dtype)
    jmodel = jax_create_model(name, jcfg, rpe_config=dict(jax_rpe) if jax_rpe else None)
    variables = jmodel.init({"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 28, 28, 1)))
    return jmodel, jax.tree_util.tree_map(np.asarray, dict(variables))


def _frozen(cfg):
    return tuple(sorted(cfg.items())) if cfg else None


@functools.lru_cache(maxsize=None)
def _jax_logits_and_grads(name, jax_rpe):
    """fp32 JAX logits and parameter gradients (flattened to the port's
    state-dict names) on a fixed batch."""
    jmodel, variables = _jax_model(name, jax_rpe)
    x, y = _images(3, seed=0)
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss(params):
        logits = jmodel.apply({"params": params, **rest}, jnp.asarray(x), deterministic=True)
        return jax_training.cross_entropy_loss(logits, jnp.asarray(y)), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    grads = {n: t.numpy() for n, t in
             flax_to_state_dict(jax.tree_util.tree_map(np.asarray, grads)).items()}
    return np.asarray(logits), grads


def _port_model(case, dtype="float32"):
    name, port_rpe, jax_rpe = CASES[case]
    _, variables = _jax_model(name, _frozen(jax_rpe))
    model = create_model(name, mnist_config(**SMALL, compute_dtype=dtype),
                         rpe_config=port_rpe, device="cpu")
    return load_flax_variables(model, variables["params"], variables.get("constants"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_jax_fp32(case):
    name, _, jax_rpe = CASES[case]
    want, _ = _jax_logits_and_grads(name, _frozen(jax_rpe))
    x, _ = _images(3, seed=0)
    with torch.inference_mode():
        got = _port_model(case)(torch.from_numpy(x))
    assert got.shape == (3, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FP32_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax_fp32(case):
    name, _, jax_rpe = CASES[case]
    _, want = _jax_logits_and_grads(name, _frozen(jax_rpe))
    model = _port_model(case).train()
    x, y = _images(3, seed=0)
    loss = cross_entropy_loss(model(torch.from_numpy(x), torch.Generator()),
                              torch.from_numpy(y).long())
    loss.backward()
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    if "circulant" in name:
        assert any("circulant_coeffs" in n for n in got)
    for n, g in got.items():
        np.testing.assert_allclose(g, want[n], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_SCALE * np.abs(want[n]).max(), err_msg=n)


@pytest.mark.parametrize("case", ["baseline_circulant-pallas", "baseline_circulant-chain",
                                  "performer_favor_circulant-pallas", "baseline_rope",
                                  "favor_plus_rope_2d"])
def test_logits_match_jax_bf16(case):
    name, _, jax_rpe = CASES[case]
    ref, _ = _jax_logits_and_grads(name, _frozen(jax_rpe))
    jmodel16, _ = _jax_model(name, _frozen(jax_rpe), "bfloat16")
    _, variables = _jax_model(name, _frozen(jax_rpe))
    x, _ = _images(3, seed=0)
    jax16 = np.asarray(jmodel16.apply(variables, jnp.asarray(x), deterministic=True))
    with torch.inference_mode():
        port16 = _port_model(case, "bfloat16")(torch.from_numpy(x)).numpy()
    jax_err, port_err = np.abs(jax16 - ref).max(), np.abs(port16 - ref).max()
    assert 0 < jax_err < 0.5
    assert port_err <= BF16_ERROR_FACTOR * jax_err, (port_err, jax_err)


def test_baseline_circulant_three_train_steps_match_jax():
    name = "baseline_circulant"
    jmodel, variables = _jax_model(name, None)
    jstate = jax_training.create_train_state(jmodel, jax_mnist_config(**SMALL),
                                             jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)),
                                             steps_per_epoch=2)
    jstep = jax_training.make_train_step(jmodel)
    model = _port_model("baseline_circulant-pallas")
    state = create_train_state(model, mnist_config(**SMALL), steps_per_epoch=2)
    step = make_train_step(model, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        x, y = _images(4, seed=10 + i)
        jstate, jloss, jcorrect = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                                        jax.random.PRNGKey(i))
        state, loss, correct = step(state, torch.from_numpy(x), torch.from_numpy(y), gen)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        assert correct.item() == int(jcorrect)
    start = flax_to_state_dict(variables["params"])
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))
    for n, p in model.named_parameters():
        moved = np.linalg.norm(want[n].numpy() - start[n].numpy())
        diff = np.linalg.norm(p.detach().numpy() - want[n].numpy())
        assert moved > 0 and diff <= PARAM_REL_TOL * moved, (n, diff, moved)


@pytest.mark.parametrize("case", ["baseline_circulant-pallas", "baseline_circulant_block",
                                  "favor_hyper_circulant-chain"])
def test_circulant_coeffs_round_trip_through_jax_importer(case):
    """The port's state dict, fed to the JAX package's importer, gives back
    the flax variables it was loaded from, circulant_coeffs included."""
    name, _, jax_rpe = CASES[case]
    _, variables = _jax_model(name, _frozen(jax_rpe))
    sd = _port_model(case).state_dict()
    assert sd["transformer_blocks.1.rpe.circulant_coeffs"].shape == \
        variables["params"]["block_1"]["rpe"]["circulant_coeffs"].shape
    back, back_consts = state_dict_to_params(sd, variables["params"], variables.get("constants"))
    for tree, orig in ((back, variables["params"]), (back_consts, variables.get("constants"))):
        want = dict(jax.tree_util.tree_leaves_with_path(orig))
        flat = jax.tree_util.tree_leaves_with_path(tree)
        assert len(flat) == len(want)
        for path, leaf in flat:
            np.testing.assert_array_equal(np.asarray(leaf), want[path], err_msg=str(path))


# ─── the factory and the modules ────────────────────────────────────────

ALL_NAMES = sorted(set(MODEL_VARIANTS) - {"baseline_most_general"}) + [
    "favor_plus_rope_2d", "softmax_rope_2d", "favor_hyper", "favor_hyper_circulant",
    "favor_hyper_most_general", "favor_plus_rotary", "relu_circulant", "softmax_rope_axial",
    "favor_hyper_rope"]


@pytest.mark.parametrize("name", ALL_NAMES)
def test_every_variant_builds_and_runs(name):
    """The 11 reference variants, the aliases and the custom names build on
    the CPU and give finite logits; their RPE and attention modules are the
    ones the name says."""
    model = create_model(name, mnist_config(**SMALL), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    block = model.transformer_blocks[0]
    rpe = name.rsplit("_", 1)[-1]
    kinds = {"circulant": CirculantStringRPE, "rope": RoPE, "rotary": RoPE, "2d": RoPE2D,
             "axial": RoPE2D, "general": KerpleRPE}
    if rpe in kinds:
        assert isinstance(block.rpe, kinds[rpe])
    assert isinstance(block.attention, FavorHyperAttention) == name.startswith("favor_hyper")
    with torch.inference_mode():
        logits = model(torch.from_numpy(_images(2, seed=1)[0]))
    assert logits.shape == (2, 10) and torch.isfinite(logits).all()


def test_circulant_options():
    cfg = mnist_config(**SMALL)
    model = create_model("baseline_circulant", cfg, device="cpu", rpe_config=BLOCK)
    rpe = model.transformer_blocks[0].rpe
    assert rpe.blocked and rpe.circulant_coeffs.shape == (2, 2, 2, 16)
    with pytest.warns(UserWarning, match="enable_block_circulant"):
        bare = create_model("baseline_circulant", cfg, device="cpu",
                            rpe_config={"block_size": 16})
    assert bare.transformer_blocks[0].rpe.circulant_coeffs.shape == (2, 2, 32)
    with pytest.raises(ValueError, match="divisible"):
        create_model("baseline_circulant", cfg, device="cpu", rpe_config={"block_size": 5})
    with pytest.raises(ValueError, match="unknown rotation method"):
        create_model("baseline_circulant", cfg, device="cpu", rpe_config={"method": "fft"})
    coeffs = model.transformer_blocks[0].rpe.circulant_coeffs
    assert 0.005 < coeffs.std().item() < 0.02  # N(0, 0.01)
    default = create_model("performer_favor_circulant", cfg, device="cpu")
    assert default.transformer_blocks[0].rpe.method == "auto"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eig = default.transformer_blocks[0].rpe.get_eigenvalues()
    assert eig.shape == (2, 2, 32) and eig.real.abs().max() == 0


def test_rotation_tables_live_outside_the_state_dict():
    """RoPE tables and circulant positions are buffers that follow the model
    to its device but are not weights."""
    for name in ("baseline_rope", "softmax_rope_2d", "baseline_circulant"):
        model = create_model(name, mnist_config(**SMALL), device="cpu")
        assert not any(k.endswith(("cos", "sin", "positions")) for k in model.state_dict())
        assert any(b.numel() for b in model.transformer_blocks[0].rpe.buffers())
