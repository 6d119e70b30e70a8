"""The port's checkpoint importer (`experiments/import_checkpoint.py`'s
counterpart) on the CPU.

A reference-format file is written with `torch.save` from a port model
(the port's modules carry the reference's parameter names), as the
reference's `save_checkpoint` dict ({model_state_dict, epoch, metrics})
and as a bare state_dict. Imported, then loaded into a fresh model, its
logits are bit for bit the source model's; `predict --checkpoint` serves
it with the source model's predictions; the same file through the JAX
importer gives JAX logits within the JAX importer test's tolerance (atol
5e-5, rtol 1e-3) of the port's. A wrong shape is refused.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_rpe_vit_torch.configs import get_dataset_config
from efficient_rpe_vit_torch.experiments import import_checkpoint, predict
from efficient_rpe_vit_torch.models import create_model
from efficient_rpe_vit_torch.train import create_train_state, load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["performer_favor_most_general", "baseline"]


def _source(name):
    return create_model(name, get_dataset_config("mnist"), device="cpu",
                        generator=torch.Generator().manual_seed(11))


def _x():
    return np.random.default_rng(0).normal(size=(4, 28, 28, 1)).astype(np.float32)


def _logits(model, x):
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(x))


def _write(tmp_path, model, form):
    path = str(tmp_path / f"ref_{form}.pt")
    sd = model.state_dict()
    torch.save({"model_state_dict": sd, "epoch": 5, "metrics": {"test_accuracy": 93.0}}
               if form == "dict" else sd, path)
    return path


@pytest.mark.parametrize("form", ["dict", "bare"])
@pytest.mark.parametrize("name", NAMES)
def test_imported_logits_are_the_source_models(tmp_path, name, form):
    source = _source(name)
    ref = _write(tmp_path, source, form)
    out = str(tmp_path / "imported.pt")
    import_checkpoint.main(["--torch-checkpoint", ref, "--model", name, "--dataset", "mnist",
                            "--output", out, "--cpu"])
    meta = json.load(open(out + ".meta.json"))
    assert meta["metadata"] == {"model_name": name, "dataset": "mnist", "imported_from": ref}
    assert meta["epoch"] == (5 if form == "dict" else 0)
    assert meta["metrics"] == ({"test_accuracy": 93.0} if form == "dict" else {})
    cfg = get_dataset_config("mnist")
    fresh = create_model(name, cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    state, _ = load_checkpoint(out, create_train_state(fresh, cfg))
    x = _x()
    assert torch.equal(_logits(state.model, x), _logits(source, x))


def test_predict_serves_the_imported_checkpoint(tmp_path):
    name = NAMES[0]
    source = _source(name)
    out = str(tmp_path / "imported.pt")
    import_checkpoint.main(["--torch-checkpoint", _write(tmp_path, source, "dict"),
                            "--model", name, "--output", out, "--cpu"])
    x = _x()
    np.save(tmp_path / "x.npy", x)
    preds = predict.main(["--checkpoint", out, "--input", str(tmp_path / "x.npy"), "--cpu"])
    data = get_dataset_config("mnist").data
    normalised = predict._normalise(x, np.asarray(data.mean, np.float32),
                                    np.asarray(data.std, np.float32))
    assert preds.tolist() == _logits(source, normalised).argmax(-1).tolist()


@pytest.mark.parametrize("name", NAMES)
def test_jax_importer_agrees(tmp_path, name):
    """The same file through the JAX `experiments/import_checkpoint.py`:
    the JAX model's logits from its checkpoint match the port's."""
    sys.path.insert(0, REPO)
    from experiments.import_checkpoint import main as jax_import

    from efficient_rpe_vit_tpu.configs import mnist_config as jax_mnist_config
    from efficient_rpe_vit_tpu.models import create_model as jax_create_model
    from efficient_rpe_vit_tpu.train import create_train_state as jax_state
    from efficient_rpe_vit_tpu.train import load_checkpoint as jax_load

    source = _source(name)
    ref = _write(tmp_path, source, "dict")
    out = str(tmp_path / "imported.msgpack")
    jax_import(["--torch-checkpoint", ref, "--model", name, "--dataset", "mnist",
                "--output", out])
    cfg = jax_mnist_config()
    model = jax_create_model(name, cfg)
    state = jax_state(model, cfg, jax.random.PRNGKey(1), jnp.zeros((2, 28, 28, 1)))
    state, meta = jax_load(out, state)
    assert meta["epoch"] == 5
    x = _x()
    variables = {"params": state.params}
    if state.constants is not None:
        variables["constants"] = state.constants
    ours = np.asarray(model.apply(variables, jnp.asarray(x), deterministic=True))
    np.testing.assert_allclose(_logits(source, x).numpy(), ours, atol=5e-5, rtol=1e-3)


def test_shape_mismatch_is_refused(tmp_path):
    sd = _source("baseline").state_dict()
    sd["patch_embedding.weight"] = torch.zeros(99, 49)
    path = str(tmp_path / "bad.pt")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="shape mismatch for patch_embedding.weight"):
        import_checkpoint.main(["--torch-checkpoint", path, "--model", "baseline",
                                "--output", str(tmp_path / "out.pt"), "--cpu"])
