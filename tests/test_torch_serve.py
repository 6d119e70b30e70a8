"""The port's serving artifacts on the CPU (`efficient_rpe_vit_torch.serve`).

Every variant exports with a symbolic batch and its artifact equals the
live model at batches 1, 2 and 5; the exported graph holds one custom-op
node per call of each forward kernel the model runs (#1 KERPLE, #3 fused
phi, #6 flash, #8 rotation) and no plain attention einsum where a kernel
runs; the four ops pass `torch.library.opcheck`; `load_exported` keeps the
device rule and serves in a process that imports no model code.

Models are small (mnist_config widths at depth 2: dim 32, 2 heads, N=17,
D=16), weights from a seeded generator, images from numpy. Tolerance: the
artifact runs the same plain versions on the same weights as the live
model, fp32 logits atol/rtol 1e-5.
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from efficient_rpe_vit_torch.configs import mnist_config
from efficient_rpe_vit_torch.models import create_model
from efficient_rpe_vit_torch.ops.kernels import circulant_rotate as cr
from efficient_rpe_vit_torch.ops.kernels import flash_attention as fa
from efficient_rpe_vit_torch.ops.kernels import masked_linear_coeffs as mlc
from efficient_rpe_vit_torch.serve import export_forward, load_exported, save_exported

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(depth=2, dropout=0.0)
DEPTH = SMALL["depth"]
OPS = {"flash": "efficient_rpe_vit.flash_attention_fwd.default",
       "kerple": "efficient_rpe_vit.masked_linear_attention_coeffs_fwd.default",
       "fused": "efficient_rpe_vit.kerple_attention_fused_phi_fwd.default",
       "rotate": "efficient_rpe_vit.circulant_rotate_fwd.default"}
# case -> (variant, create_model kwargs, {op: nodes per block})
CASES = {
    "baseline": ("baseline", {}, {"flash": 1}),
    "baseline_rope": ("baseline_rope", {}, {"flash": 1}),
    "baseline_circulant": ("baseline_circulant", {}, {"flash": 1, "rotate": 2}),
    "performer_favor": ("performer_favor", {}, {}),
    "performer_favor_rope": ("performer_favor_rope", {}, {}),
    "performer_favor_most_general": ("performer_favor_most_general", {}, {"kerple": 1}),
    "performer_favor_circulant": ("performer_favor_circulant", {}, {"rotate": 2}),
    "performer_relu": ("performer_relu", {}, {}),
    "performer_relu_rope": ("performer_relu_rope", {}, {}),
    "performer_relu_most_general": ("performer_relu_most_general", {}, {"kerple": 1}),
    "performer_relu_circulant": ("performer_relu_circulant", {}, {"rotate": 2}),
    "fused_phi": ("performer_favor_most_general", {"attention_config": {"fused_phi": True}},
                  {"fused": 1}),
    "favor_hyper_circulant": ("favor_hyper_circulant", {}, {"rotate": 2}),
    "favor_plus_rope_2d": ("favor_plus_rope_2d", {}, {}),
    "block_circulant": ("baseline_circulant",
                        {"rpe_config": {"block_size": 8, "enable_block_circulant": True}},
                        {"flash": 1}),
    "moe": ("performer_favor_most_general", {"mlp_config": {"mlp_type": "moe", "num_experts": 4}},
            {"kerple": 1}),
}


def _images(batch, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(batch, 28, 28, 1)).astype(np.float32))


def _model(case):
    name, kwargs, _ = CASES[case]
    return create_model(name, mnist_config(**SMALL), device="cpu",
                        generator=torch.Generator().manual_seed(0), **kwargs)


@functools.lru_cache(maxsize=None)
def _exported(case):
    model = _model(case)
    return model, export_forward(model, image_size=28, in_channels=1, device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_symbolic_batch_equals_the_live_model(case):
    model, exported = _exported(case)
    served = exported.module()
    for batch in (1, 2, 5):
        x = _images(batch, seed=batch)
        with torch.inference_mode():
            want = model(x)
            got = served(x)
        assert got.shape == (batch, 10)
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_exported_graph_holds_the_kernel_ops(case):
    _, exported = _exported(case)
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    per_block = CASES[case][2]
    for op, target in OPS.items():
        assert targets.count(target) == DEPTH * per_block.get(op, 0), (op, targets.count(target))
    if set(per_block) & {"flash", "kerple", "fused"} and case != "moe":
        # an attention kernel carries the attention: no plain attention
        # product is left (linear attention without KERPLE has no kernel)
        assert "aten.einsum.default" not in targets


def test_exported_flagship_runs_the_kerple_op_once_per_block():
    _, exported = _exported("performer_favor_most_general")
    nodes = [n for n in exported.graph.nodes if str(n.target) == OPS["kerple"]]
    assert len(nodes) == DEPTH
    for node in nodes:
        # the batch stays symbolic at the op
        assert isinstance(node.args[0].meta["val"].shape[0], torch.SymInt)


def _opcheck_cases():
    g = torch.Generator().manual_seed(0)
    r = functools.partial(torch.randn, generator=g)
    unit = lambda t: t / t.norm(dim=-1, keepdim=True)  # noqa: E731
    qp, kp = r(2, 2, 5, 6).abs(), r(2, 2, 5, 6).abs()
    v, c = r(2, 2, 5, 4), torch.exp(r(2, 9) * 0.1)
    mask = (torch.rand(2, 1, 5, 5, generator=g) > 0.3) | torch.eye(5, dtype=torch.bool)
    theta = r(2, 5, 5)
    return {
        "masked_linear_attention_coeffs_fwd": (
            mlc._fwd_op, (qp, kp, v, c)),
        "kerple_attention_fused_phi_fwd": (
            mlc._fused_fwd_op, (unit(r(2, 2, 5, 4)), unit(r(2, 2, 5, 4)), v, r(2, 4, 6), c,
                                "favor_plus")),
        "flash_attention_fwd": (
            fa._fwd_op, (r(2, 2, 5, 4), r(2, 2, 5, 4), v, mask,
                         torch.tensor([7], dtype=torch.int32), 0.5, 0.1)),
        "flash_attention_fwd_no_mask": (
            fa._fwd_op, (r(2, 2, 5, 4), r(2, 2, 5, 4), v, None, None, 0.5, 0.0)),
        "circulant_rotate_fwd": (
            cr._fwd_op, (r(2, 2, 5, 8), theta.cos().contiguous(), theta.sin().contiguous(),
                         True)),
    }


@pytest.mark.parametrize("case", sorted(_opcheck_cases()))
def test_custom_ops_pass_opcheck(case):
    op, args = _opcheck_cases()[case]
    result = torch.library.opcheck(op, args)
    assert all(v == "SUCCESS" for v in result.values()), result


def test_sidecar_has_the_jax_sidecars_keys(tmp_path):
    path = str(tmp_path / "model.pt2")
    save_exported(path, _model("baseline"), image_size=28, in_channels=1, device="cpu",
                  metadata={"model_name": "baseline", "dataset": "mnist"})
    meta = json.loads(Path(path + ".meta.json").read_text())
    # the JAX sidecar's keys, the exporting device in place of `platforms`
    assert set(meta) == {"format", "device", "weights_dtype", "input_shape", "out_avals",
                         "metadata"}
    assert meta["format"] == "torch.export"
    assert meta["device"] == "cpu" and meta["weights_dtype"] == "unchanged"
    assert meta["input_shape"] == ["b", 28, 28, 1]
    assert meta["out_avals"] == [{"shape": ["b", "10"], "dtype": "float32"}]
    assert meta["metadata"] == {"model_name": "baseline", "dataset": "mnist"}


def test_load_exported_keeps_the_device_rule(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the load without a GPU")
    model = _model("performer_favor_most_general")
    path = save_exported(str(tmp_path / "model.pt2"), model, image_size=28, in_channels=1,
                         device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_forward(model, image_size=28, in_channels=1)
    fn, meta = load_exported(path, device="cpu")
    x = _images(3)
    with torch.inference_mode():
        torch.testing.assert_close(fn(x), model(x), **TOL)
    assert meta["device"] == "cpu"


def test_artifact_serves_without_the_model_modules(tmp_path):
    model = _model("baseline_circulant")
    path = save_exported(str(tmp_path / "model.pt2"), model, image_size=28, in_channels=1,
                         device="cpu")
    x = _images(4)
    np.save(tmp_path / "x.npy", x.numpy())
    script = (
        "import sys, numpy as np, torch\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from efficient_rpe_vit_torch.serve import load_exported\n"
        f"fn, meta = load_exported({path!r}, device='cpu')\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, "
        f"fn(torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r}))).numpy())\n"
        "loaded = sorted(m for m in sys.modules if m.startswith('efficient_rpe_vit_torch.'))\n"
        "print(' '.join(loaded))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, check=True).stdout.split()
    assert not [m for m in out if m.split(".")[1] in ("models", "configs", "train")], out
    assert "efficient_rpe_vit_torch.serve" in out
    with torch.inference_mode():
        want = model(x)
    torch.testing.assert_close(torch.from_numpy(np.load(tmp_path / "y.npy")), want, **TOL)


def test_export_leaves_the_model_in_its_mode():
    model = _model("performer_favor")
    model.train()
    export_forward(model, image_size=28, in_channels=1, device="cpu")
    assert model.training
    with pytest.raises(ValueError, match="weights_dtype"):
        export_forward(model, image_size=28, in_channels=1, device="cpu", weights_dtype="fp8")
