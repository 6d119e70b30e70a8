"""The port's data modules against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed or tiny files written to tmp_path.
Parsers, the synthetic fallback, the re-split and epoch orders are held
bit for bit (both packages run the same numpy code). Normalisation is held
at 1e-6 and the bilinear rotation at 1e-5 (the JAX function applies an
interpolation matrix, the port gathers the four corners: the same terms
summed in another order). The CIFAR crop and flip are held bit for bit at
the offsets and flips the JAX function draws from its key. Augmentation
draws themselves differ between the two RNGs and are not compared.
"""

import gzip
import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_rpe_vit_tpu.data import datasets as jax_datasets
from efficient_rpe_vit_tpu.data import io as jax_io
from efficient_rpe_vit_tpu.data import pipeline as jax_pipeline
from efficient_rpe_vit_torch.configs import mnist_config
from efficient_rpe_vit_torch.data import (
    DeviceDataset,
    compute_dataset_stats,
    get_dataloaders,
    get_sample_batch,
    load_dataset,
    normalize_images,
    read_cifar10_batches,
    read_idx_images,
    read_idx_labels,
)
from efficient_rpe_vit_torch.data import datasets as port_datasets
from efficient_rpe_vit_torch.data import pipeline as port_pipeline

MEAN, STD = (0.1307,), (0.3081,)


def _write_idx(path, array, magic, gz=False):
    header = np.asarray([magic, *array.shape], ">i4").tobytes()
    opener = gzip.open if gz else open
    with opener(str(path) + (".gz" if gz else ""), "wb") as f:
        f.write(header + array.astype(np.uint8).tobytes())


def _write_mnist(raw, rng, splits=("train", "t10k"), n=30, gz=False):
    raw.mkdir(parents=True, exist_ok=True)
    for prefix in splits:
        _write_idx(raw / f"{prefix}-images-idx3-ubyte",
                   rng.integers(0, 256, (n, 28, 28)), 2051, gz)
        _write_idx(raw / f"{prefix}-labels-idx1-ubyte", rng.integers(0, 10, n), 2049, gz)


def _write_cifar(d, rng, names, n=6):
    d.mkdir(parents=True, exist_ok=True)
    for name in names:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, f)


def _same_split_dicts(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


# ─── parsers ────────────────────────────────────────────────────────────

@pytest.mark.parametrize("gz", [False, True])
def test_idx_parsers_match_jax(tmp_path, gz):
    rng = np.random.default_rng(0)
    _write_mnist(tmp_path, rng, splits=("train",), n=7, gz=gz)
    images = tmp_path / "train-images-idx3-ubyte"
    labels = tmp_path / "train-labels-idx1-ubyte"
    for port, ref, path in ((read_idx_images, jax_io.read_idx_images, images),
                            (read_idx_labels, jax_io.read_idx_labels, labels)):
        got, want = port(str(path)), ref(str(path))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert read_idx_images(str(images)).shape == (7, 28, 28)
    # an image file under the labels' magic number is refused
    _write_idx(tmp_path / "bad", np.zeros((2, 28, 28)), 2049, gz)
    with pytest.raises(ValueError, match="magic"):
        read_idx_images(str(tmp_path / "bad"))
    with pytest.raises(FileNotFoundError):
        read_idx_labels(str(tmp_path / "missing"))


def test_cifar_parser_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    _write_cifar(tmp_path, rng, ["data_batch_1", "data_batch_2"])
    names = ["data_batch_1", "data_batch_2"]
    got = read_cifar10_batches(str(tmp_path), names)
    want = jax_io.read_cifar10_batches(str(tmp_path), names)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (12, 32, 32, 3)
    assert read_cifar10_batches(str(tmp_path), ["test_batch"]) is None


# ─── loaders ────────────────────────────────────────────────────────────

def test_synthetic_matches_jax_bitwise():
    for args in ((40, 10, 28, 1), (12, 5, 32, 3, 10, 7)):
        got = port_datasets._synthetic(*args)
        assert got["synthetic"] is True
        _same_split_dicts(got, jax_datasets._synthetic(*args))


@pytest.mark.parametrize("splits", [("train", "t10k"), ("t10k",)])
def test_load_mnist_from_data_dir_matches_jax(tmp_path, splits):
    """Both splits, or only the test split, deterministically re-split
    80/20 with a warning."""
    _write_mnist(tmp_path / "MNIST" / "raw", np.random.default_rng(2), splits, n=25)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = load_dataset("mnist", data_dir=str(tmp_path))
        want = jax_datasets.load_dataset("mnist", data_dir=str(tmp_path))
    _same_split_dicts(got, want)
    assert got["synthetic"] is False and got["train_images"].shape[1:] == (28, 28, 1)
    if len(splits) == 1:
        with pytest.warns(UserWarning, match="re-splitting"):
            load_dataset("mnist", data_dir=str(tmp_path))


@pytest.mark.parametrize("names", [["test_batch"], [f"data_batch_{i}" for i in range(1, 6)]
                                   + ["test_batch"]])
def test_load_cifar10_from_data_dir_matches_jax(tmp_path, names):
    _write_cifar(tmp_path / "cifar-10-batches-py", np.random.default_rng(3), names)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = load_dataset("cifar10", data_dir=str(tmp_path))
        want = jax_datasets.load_dataset("cifar10", data_dir=str(tmp_path))
    _same_split_dicts(got, want)


def test_synthetic_fallback_is_flagged_and_explicit_dirs_refuse_it(tmp_path, monkeypatch):
    monkeypatch.setattr(port_datasets, "_SEARCH_DIRS", [str(tmp_path / "nowhere")])
    with pytest.warns(UserWarning, match="synthetic"):
        data = load_dataset("cifar10")
    assert data["synthetic"] is True and data["train_images"].shape[1:] == (32, 32, 3)
    with pytest.raises(FileNotFoundError):
        load_dataset("mnist", data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        load_dataset("mnist", allow_synthetic=False)
    with pytest.raises(ValueError, match="Unknown dataset"):
        load_dataset("imagenet")


def test_dataloaders_carry_the_synthetic_flag(monkeypatch):
    monkeypatch.setattr(port_datasets, "_SEARCH_DIRS", [])
    monkeypatch.setattr(jax_datasets, "_SEARCH_DIRS", [])
    cfg = mnist_config()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        train, test = get_dataloaders(cfg, device="cpu")
        images, labels = get_sample_batch(cfg, batch_size=5, device="cpu")
        stats = compute_dataset_stats("mnist")
        want = jax_datasets.compute_dataset_stats("mnist")
    assert train.synthetic and test.synthetic
    assert train.batch_size == cfg.train.batch_size and train.drop_last and not test.drop_last
    assert images.shape == (5, 28, 28, 1) and images.dtype == torch.float32
    assert labels.dtype == torch.int32
    assert stats == want


# ─── the device dataset ─────────────────────────────────────────────────

def _pair_datasets(n, bs, **kw):
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (n, 8, 8, 1), dtype=np.uint8)
    labels = rng.integers(0, 10, n)
    return (DeviceDataset(imgs, labels, MEAN, STD, bs, device="cpu", **kw),
            jax_pipeline.DeviceDataset(imgs, labels, MEAN, STD, bs, **kw))


@pytest.mark.parametrize("kw", [dict(shuffle=True, drop_last=True, seed=1),
                                dict(shuffle=False, drop_last=False),
                                dict(shuffle=True, drop_last=False, seed=7)])
def test_device_dataset_batches_match_jax(kw):
    """Epoch orders (numpy's default_rng(seed)), lengths, remainders and the
    normalised batches equal the JAX dataset's, two epochs running."""
    port, ref = _pair_datasets(100, 32, **kw)
    assert len(port) == len(ref) == (3 if kw["drop_last"] else 4)
    for _ in range(2):
        got, want = list(port), list(ref)
        assert [x.shape[0] for x, _ in got] == [x.shape[0] for x, _ in want]
        for (x, y), (jx, jy) in zip(got, want):
            assert x.dtype == torch.float32 and y.dtype == torch.int32
            np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(port.epoch_order(), ref.epoch_order())


def test_device_dataset_keeps_remainder_and_runs_on_the_gpu_by_default():
    imgs = np.zeros((10, 4, 4, 1), np.uint8)
    ds = DeviceDataset(imgs, np.zeros(10, np.int64), (0.0,), (1.0,), batch_size=4,
                       device="cpu")
    assert [x.shape[0] for x, _ in ds] == [4, 4, 2] and len(ds) == 3
    assert ds.num_samples == 10 and ds.images.dtype == torch.uint8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeviceDataset(imgs, np.zeros(10), (0.0,), (1.0,), batch_size=4)


# ─── preprocessing and augmentation ─────────────────────────────────────

def test_normalize_matches_jax():
    x = np.random.default_rng(5).integers(0, 256, (3, 6, 6, 3), dtype=np.uint8)
    mean, std = (0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616)
    got = normalize_images(torch.from_numpy(x), mean, std)
    want = jax_pipeline.normalize_images(jnp.asarray(x), mean, std)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_rotate_bilinear_matches_jax_at_fixed_angles():
    rng = np.random.default_rng(6)
    x = rng.uniform(size=(5, 28, 28, 2)).astype(np.float32)
    angles = np.deg2rad([-10.0, -3.3, 0.0, 7.1, 45.0]).astype(np.float32)
    got = port_pipeline._rotate_bilinear(torch.from_numpy(x), torch.from_numpy(angles))
    want = jax.vmap(jax_pipeline._rotate_bilinear)(jnp.asarray(x), jnp.asarray(angles))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_augment_mnist_is_the_jax_rotation_at_its_angles():
    """augment_mnist's draw gives angles in [-10, 10] degrees; at the angles
    JAX draws from its key, the port's rotation is JAX's augment_mnist."""
    key = jax.random.PRNGKey(3)
    x = np.random.default_rng(7).uniform(size=(4, 28, 28, 1)).astype(np.float32)
    want = jax_pipeline.augment_mnist(jnp.asarray(x), key)
    angles = jax.random.uniform(key, (4,), minval=-10.0, maxval=10.0) * (jnp.pi / 180.0)
    got = port_pipeline._rotate_bilinear(torch.from_numpy(x),
                                         torch.from_numpy(np.array(angles)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    out = port_pipeline.augment_mnist(torch.from_numpy(x), torch.Generator().manual_seed(0))
    assert out.shape == x.shape and float((out - torch.from_numpy(x)).abs().max()) > 1e-4


def test_cifar_crop_and_flip_match_jax_bitwise():
    key = jax.random.PRNGKey(11)
    B = 8
    x = np.random.default_rng(8).uniform(size=(B, 32, 32, 3)).astype(np.float32)
    want = jax_pipeline.augment_cifar(jnp.asarray(x), key)
    kc, kf = jax.random.split(key)
    offsets = np.array(jax.random.randint(kc, (B, 2), 0, 9))
    flip = np.array(jax.random.bernoulli(kf, 0.5, (B,)))
    assert flip.any() and not flip.all()
    got = port_pipeline._crop_flip(torch.from_numpy(x), torch.from_numpy(offsets),
                                   torch.from_numpy(flip))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    out = port_pipeline.augment_cifar(torch.from_numpy(x), torch.Generator().manual_seed(0))
    assert out.shape == x.shape


@pytest.mark.parametrize("augment", ["mnist", "cifar"])
def test_augment_fills_are_black_not_mean(augment):
    """Augmentation runs on raw [0, 1] pixels before normalisation, so the
    rotation's corners and the crop's padding are black, as torchvision's."""
    c = 1 if augment == "mnist" else 3
    size = 28 if augment == "mnist" else 32
    imgs = torch.full((16, size, size, c), 255, dtype=torch.uint8)
    mean = torch.full((c,), 0.1307)
    std = torch.full((c,), 0.3081)
    x, _ = port_pipeline._gather_batch(imgs, torch.zeros(16, dtype=torch.int32),
                                       torch.arange(16), mean, std, augment,
                                       torch.Generator().manual_seed(3))
    black = (0.0 - 0.1307) / 0.3081
    assert float(x.min()) < black * 0.5
    with pytest.raises(ValueError, match="augment"):
        port_pipeline._gather_batch(imgs, torch.zeros(16, dtype=torch.int32),
                                    torch.arange(2), mean, std, "imagenet", None)
