"""The port's serving artifacts against the JAX package's, and the CLIs that
make and serve them (`experiments.export`, `predict --artifact`,
`serve_bench`), on the CPU.

JAX parity: one flax init of the flagship (`performer_favor_most_general`,
dim 128, 2 heads, mlp 256, depth 2: wide enough that the weights, not the
program, fill an fp32 artifact, as in the JAX package's own size tests),
carried into the port with `load_flax_variables`, is exported by both
packages with weights_dtype None, "bfloat16" and "int8": logits within
1e-4 (atol and rtol; the JAX CPU path and the port's plain versions sum in
other orders), the int8 values and scales equal to `_quantize_int8_params`'s
leaves exactly, and the reduced artifacts smaller than fp32 by the JAX
tests' factors (bf16 < 0.75x, int8 < 0.6x).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_rpe_vit_tpu.configs import mnist_config as jax_mnist_config
from efficient_rpe_vit_tpu.models import create_model as jax_create_model
from efficient_rpe_vit_tpu.serve import export as jax_export
from efficient_rpe_vit_torch.configs import mnist_config
from efficient_rpe_vit_torch.experiments import export as port_export
from efficient_rpe_vit_torch.experiments import predict as port_predict
from efficient_rpe_vit_torch.experiments import serve_bench
from efficient_rpe_vit_torch.models import create_model
from efficient_rpe_vit_torch.serve import load_exported, save_exported
from efficient_rpe_vit_torch.serve.export import ServedForward
from efficient_rpe_vit_torch.train import create_train_state, make_train_step, save_checkpoint
from efficient_rpe_vit_torch.utils import flax_to_state_dict, load_flax_variables

torch.set_num_threads(2)

NAME = "performer_favor_most_general"
WIDE = dict(dim=128, heads=2, mlp_dim=256, depth=2, dropout=0.0)
JAX_TOL = dict(atol=1e-4, rtol=1e-4)
# the JAX package's size tests (tests/test_serve.py)
SIZE_FACTOR = {"bfloat16": 0.75, "int8": 0.6}
# the keys of a JAX serve_bench row (experiments/serve_bench.py); a
# calibrated chain clipped by the clock adds `clipped_chains`
ROW_KEYS = {"case", "batch", "p50_ms", "mean_ms", "us_per_sample", "images_per_sec",
            "chain_length", "fetch_rt_ms"}


def _images(batch, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, 28, 28, 1)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _flagship():
    """(JAX model, its variables as numpy, the port model on them)."""
    jmodel = jax_create_model(NAME, jax_mnist_config(**WIDE))
    variables = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 28, 28, 1)),
                            deterministic=True)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    port = create_model(NAME, mnist_config(**WIDE), device="cpu")
    load_flax_variables(port, variables["params"], variables.get("constants"))
    return jmodel, variables, port


@functools.lru_cache(maxsize=None)
def _artifacts(tmp_dir, weights_dtype):
    """Both packages' artifacts of the flagship: ((JAX fn, meta, bytes),
    (port fn, meta, bytes))."""
    import os

    jmodel, variables, port = _flagship()
    jpath, ppath = f"{tmp_dir}/jax_{weights_dtype}.hlo", f"{tmp_dir}/port_{weights_dtype}.pt2"
    jax_export.save_exported(jpath, jmodel, variables, image_size=28, in_channels=1,
                             weights_dtype=weights_dtype)
    save_exported(ppath, port, image_size=28, in_channels=1, weights_dtype=weights_dtype,
                  device="cpu")
    return ((*jax_export.load_exported(jpath), os.path.getsize(jpath)),
            (*load_exported(ppath, device="cpu"), os.path.getsize(ppath)))


@pytest.fixture(scope="module")
def artifact_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("artifacts"))


@pytest.mark.parametrize("weights_dtype", [None, "bfloat16", "int8"])
def test_artifacts_equal_the_jax_artifacts(artifact_dir, weights_dtype):
    (jfn, jmeta, _), (pfn, pmeta, _) = _artifacts(artifact_dir, weights_dtype)
    x = _images(5)
    want = np.asarray(jfn(jnp.asarray(x)))
    got = pfn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **JAX_TOL)
    assert pmeta["weights_dtype"] == jmeta["weights_dtype"]
    assert pmeta.get("quantization") == jmeta.get("quantization")
    assert set(pmeta) - {"device"} == set(jmeta) - {"platforms"}
    assert pmeta["out_avals"] == jmeta["out_avals"]


def test_reduced_artifacts_are_smaller_by_the_jax_factors(artifact_dir):
    fp32 = _artifacts(artifact_dir, None)[1][2]
    for weights_dtype, factor in SIZE_FACTOR.items():
        assert _artifacts(artifact_dir, weights_dtype)[1][2] < factor * fp32, weights_dtype


def test_int8_values_and_scales_equal_the_jax_leaves():
    _, variables, port = _flagship()
    quantized = jax_export._quantize_int8_params(variables["params"])
    is_q = lambda leaf: isinstance(leaf, jax_export._QuantLeaf)  # noqa: E731

    def mapped(pick):
        tree = jax.tree_util.tree_map(lambda leaf: pick(leaf) if is_q(leaf) else leaf,
                                      quantized, is_leaf=is_q)
        return flax_to_state_dict(tree)

    values = mapped(lambda leaf: np.asarray(leaf.q))
    scales = mapped(lambda leaf: np.asarray(leaf.scale))
    marked = mapped(lambda leaf: np.ones(leaf.q.shape, np.float32))
    jax_names = {n for n, t in marked.items()
                 if n in dict(port.named_parameters()) and t.dim() >= 2 and bool((t == 1).all())}
    served = ServedForward(port, "int8")
    port_names = {n for n, (kind, _) in served.kinds.items() if kind == "int8"}
    assert port_names == jax_names
    assert "attention.omega" not in " ".join(port_names)  # constants stay fp32
    for name in port_names:
        q, scale = served.stored(name)
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        assert torch.equal(q.float(), values[name]), name
        assert torch.equal(scale, scales[name]), name


# ─── the CLIs ───────────────────────────────────────────────────────────

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A port checkpoint of a depth-1 flagship trained 3 steps with an EMA
    (decay 0.9), so its shadow differs from its parameters."""
    out = tmp_path_factory.mktemp("checkpoint")
    cfg = mnist_config(depth=1, dropout=0.0)
    model = create_model(NAME, cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, ema_decay=0.9)
    step = make_train_step(model, device="cpu")
    g = torch.Generator().manual_seed(1)
    for _ in range(3):
        x = torch.randn(8, 28, 28, 1, generator=g)
        state, _, _ = step(state, x, torch.arange(8) % 10, g)
    path = str(out / "ck.pt")
    save_checkpoint(path, state, epoch=0, metadata={"model_name": NAME, "dataset": "mnist",
                                                     "ema_decay": 0.9, "depth": 1})
    return path, state


@pytest.mark.parametrize("weights_dtype", [None, "bfloat16", "int8"])
def test_export_cli_validates(tmp_path, checkpoint, weights_dtype):
    ckpt, _ = checkpoint
    out = str(tmp_path / "model.pt2")
    port_export.main(["--checkpoint", ckpt, "--out", out, "--validate", "--cpu",
                      *(["--weights-dtype", weights_dtype] if weights_dtype else [])])
    fn, meta = load_exported(out, device="cpu")
    assert meta["weights_dtype"] == (weights_dtype or "unchanged")
    assert meta["metadata"]["model_name"] == NAME and meta["metadata"]["from_checkpoint"]
    assert fn(torch.zeros(3, 28, 28, 1)).shape == (3, 10)


def test_export_cli_serves_the_ema_shadow(tmp_path, checkpoint):
    ckpt, state = checkpoint
    out = str(tmp_path / "model.pt2")
    port_export.main(["--checkpoint", ckpt, "--out", out, "--cpu"])
    fn, _ = load_exported(out, device="cpu")
    x = torch.from_numpy(_images(4))
    shadow, live = state.eval_view(), state.model
    shadow.eval()
    live.eval()
    with torch.inference_mode():
        got, want, params = fn(x), shadow(x), live(x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert (got - params).abs().max() > 1e-4


def test_predict_from_the_artifact(tmp_path, checkpoint):
    ckpt, _ = checkpoint
    art = str(tmp_path / "model.pt2")
    port_export.main(["--checkpoint", ckpt, "--out", art, "--cpu"])
    digits = np.random.default_rng(0).integers(0, 255, (6, 28, 28)).astype(np.uint8)
    np.save(tmp_path / "digits.npy", digits)
    out = str(tmp_path / "preds.json")
    preds = port_predict.main(["--artifact", art, "--input", str(tmp_path / "digits.npy"),
                               "--output", out, "--cpu"])
    assert preds.shape == (6,)
    assert json.loads(open(out).read())["predictions"] == preds.tolist()
    want = port_predict.main(["--checkpoint", ckpt, "--input", str(tmp_path / "digits.npy"),
                              "--cpu"])
    np.testing.assert_array_equal(preds, want)
    result = port_predict.main(["--artifact", art, "--cpu"])  # the test split
    assert result["samples"] > 0 and 0.0 <= result["accuracy"] <= 100.0
    with pytest.raises(SystemExit, match="exactly one"):
        port_predict.main(["--cpu"])


def test_serve_bench_writes_the_jax_row_keys(tmp_path, checkpoint):
    ckpt, _ = checkpoint
    out = tmp_path / "serve_bench.json"
    result = serve_bench.main(["--checkpoint", ckpt, "--cpu", "--quick", "--batches", "1", "3",
                               "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    rows = result["rows"]
    assert [(r["case"], r["batch"]) for r in rows] == [
        (case, b) for case, _ in serve_bench.CASES for b in (1, 3)]
    for row in rows:
        keys = set(row) - {"clipped_chains"}
        want = ROW_KEYS | ({"artifact_bytes"} if row["case"] != "live_model" else set())
        assert keys == want, row
    assert result["model"] == NAME and result["backend"] == "cpu"
    with pytest.raises(SystemExit, match="--checkpoint"):
        serve_bench.main(["--cpu", "--quick"])
