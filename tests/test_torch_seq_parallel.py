"""The port's context parallelism against the JAX package, on the CPU.

gloo worlds of 2, 4 and 8 ranks (`tests/torch_parallel_worker.py`):

  * the three sequence-parallel cores at N = 17, which neither P = 2 nor
    P = 4 divides (the padding path), against the JAX package's
    single-device cores (`linear_attention`, `kerple_linear_attention`
    dense, `softmax_attention`): outputs to rtol 2e-5 / atol 2e-6 (JAX
    tests/test_parallel.py:391-406 for its own padded ops) and the
    gradients of sum(out * cot) for every input, coefficients included,
    to rtol 1e-4 / atol 1e-5 (summation order only);
  * models built with `seq_mesh` (`baseline`: ring softmax,
    `performer_favor`: summed linear attention,
    `performer_favor_most_general`: ring KERPLE) carrying the flax
    variables: logits against the JAX single-device model to rtol 1e-5
    and parameter gradients to rtol 5e-4 (atol 1e-5), as JAX's own
    tests/test_parallel.py:310-351 holds its CP models;
  * the DP x CP and DP x TP x CP sharded steps against the JAX package's
    on the same meshes, as tests/test_torch_parallel.py holds the others.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from efficient_rpe_vit_tpu.configs import mnist_config as jax_mnist_config
from efficient_rpe_vit_tpu.models import create_model as jax_create_model
from efficient_rpe_vit_tpu.ops import kerple_linear_attention, linear_attention
from efficient_rpe_vit_tpu.ops.attention_core import softmax_attention
from efficient_rpe_vit_torch.utils.import_flax import flax_to_state_dict

import torch_parallel_worker as worker
from torch_parallel_jax import (
    DEPTH,
    LOSS_ATOL,
    PARAM_ATOL,
    batch,
    jax_step,
    np_tree,
    ok,
)

N = 17
OP_TOL = dict(rtol=2e-5, atol=2e-6)
OP_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
CP_MODELS = ["baseline", "performer_favor", "performer_favor_most_general"]
STEPS = [
    ("dp_cp", 4, "data=2,seq=2", (2, 2), ("data", "seq")),
    ("dp_tp_cp", 8, "data=2,model=2,seq=2", (2, 2, 2), ("data", "model", "seq")),
]
OPS = {"linear": ("qp", "kp", "v"), "kerple": ("qp", "kp", "v", "coeffs"),
       "softmax": ("q", "k", "v")}


def _op_inputs():
    rng = np.random.default_rng(3)
    B, H, F, D = 2, 2, 12, 16
    f32 = np.float32
    return {"qp": (np.abs(rng.normal(size=(B, H, N, F))) * 0.2).astype(f32),
            "kp": (np.abs(rng.normal(size=(B, H, N, F))) * 0.2).astype(f32),
            "v": rng.normal(size=(B, H, N, D)).astype(f32),
            "coeffs": np.exp(rng.normal(size=(H, 2 * N - 1)) * 0.05).astype(f32),
            "q": (rng.normal(size=(B, H, N, D)) * 2.0).astype(f32),
            "k": (rng.normal(size=(B, H, N, D)) * 2.0).astype(f32),
            "cot": rng.normal(size=(B, H, N, D)).astype(f32)}


def _jax_ops(inputs):
    fns = {"linear": linear_attention,
           "kerple": lambda qp, kp, v, c: kerple_linear_attention(qp, kp, v, c, method="dense"),
           "softmax": lambda q, k, v: softmax_attention(q, k, v, q.shape[-1] ** -0.5)}
    out = {}
    for name, args in OPS.items():
        vals, vjp = jax.vjp(fns[name], *(jnp.asarray(inputs[a]) for a in args))
        grads = vjp(jnp.asarray(inputs["cot"]))
        out[name] = {"out": np.asarray(vals),
                     **{f"d{a}": np.asarray(g) for a, g in zip(args, grads)}}
    return out


def _jax_model(name, x, cot):
    """Single-device JAX logits and gradients of sum(logits * cot), with
    the flax variables they came from."""
    cfg = jax_mnist_config(dropout=0.0, depth=DEPTH)
    model = jax_create_model(name, cfg, rpe_config=(
        {"method": "dense"} if "most_general" in name else None))
    variables = model.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))

    def f(params):
        logits = model.apply({**variables, "params": params}, jnp.asarray(x))
        return jnp.sum(logits * cot), logits

    (_, logits), grads = jax.value_and_grad(f, has_aux=True)(variables["params"])
    flax = (np_tree(variables["params"]), np_tree(variables.get("constants")))
    return flax, np.asarray(logits), {n: t.numpy() for n, t in
                                      flax_to_state_dict(np_tree(grads)).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = _op_inputs()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 28, 28, 1)).astype(np.float32)
    cot = rng.normal(size=(4, 10)).astype(np.float32)
    want = {"ops": _jax_ops(inputs)}
    ops = {k: v for k, v in inputs.items()}
    cases = {2: [("ops", "seq_ops", dict(inputs=ops))], 4: [("ops", "seq_ops", dict(inputs=ops))]}
    for name in CP_MODELS:
        variables, logits, grads = _jax_model(name, x, cot)
        want[name] = (logits, grads)
        cases[2].append((name, "forward_grads", dict(spec="seq=2", name=name, x=x, cot=cot,
                                                     variables=variables, depth=DEPTH)))
    xb, yb = batch()
    for case, world, spec, shape, names in STEPS:
        variables, *want[case] = jax_step(shape, names, "performer_favor_most_general",
                                          seq=True)
        cases.setdefault(world, []).append(
            (case, "step", dict(spec=spec, name="performer_favor_most_general", x=xb, y=yb,
                                variables=variables, depth=DEPTH)))
    port = {}
    for world, todo in sorted(cases.items()):
        port[world] = worker.run_world(world, todo, tmp_path_factory.mktemp(f"seq{world}"))
    return want, port


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("op", list(OPS))
def test_seq_parallel_op_matches_jax(runs, op, p):
    want, port = runs
    for rank, result in enumerate(port[p]["ops"]):
        got = ok(result)[op]
        np.testing.assert_allclose(got["out"], want["ops"][op]["out"], **OP_TOL,
                                   err_msg=f"{op} out, rank {rank}")
        for a in OPS[op]:
            np.testing.assert_allclose(got[f"d{a}"], want["ops"][op][f"d{a}"], **OP_GRAD_TOL,
                                       err_msg=f"{op} d{a}, rank {rank}")


@pytest.mark.parametrize("name", CP_MODELS)
def test_context_parallel_model_matches_jax(runs, name):
    want, port = runs
    logits, grads = want[name]
    for result in port[2][name]:
        got = ok(result)
        np.testing.assert_allclose(got["logits"], logits, **LOGIT_TOL)
        assert set(got["grads"]) == set(grads)
        for n, g in grads.items():
            np.testing.assert_allclose(got["grads"][n], g, **GRAD_TOL, err_msg=n)


@pytest.mark.parametrize("case", [c[0] for c in STEPS])
def test_context_parallel_step_matches_jax(runs, case):
    want, port = runs
    world = next(c[1] for c in STEPS if c[0] == case)
    loss, correct, after = want[case]
    ranks = [ok(r) for r in port[world][case]]
    for r in ranks:
        assert abs(r["loss"][0] - loss) < LOSS_ATOL, (r["loss"], loss)
        assert r["correct"][0] == correct
    for name, w in after.items():
        np.testing.assert_allclose(ranks[0]["params"][name], w, atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)
