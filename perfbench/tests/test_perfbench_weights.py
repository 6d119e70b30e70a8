"""Inputs from the seed: the same seed gives the same inputs, on any whole
number up to past 2**31 and beyond."""

import math

import numpy as np
import pytest
import torch

from perfbench import spec
from perfbench.reference.vit import parameter_spec
from perfbench.weights import chunks, make_images, make_weights, sub_seed
from conftest import tiny

SEEDS = [0, 7, 2 ** 31 + 5, 2 ** 40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_perfbench_same_seed_same_inputs(seed):
    cell = tiny(spec.load_cell("kerple-b16-train-n4097"))
    leaves = parameter_spec(cell.config, cell.mix)
    a = make_weights(leaves, seed, "cpu")
    b = make_weights(leaves, seed, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    c = make_weights(leaves, seed + 1, "cpu")
    assert not torch.equal(a["pos_embedding"], c["pos_embedding"])
    i1, l1 = make_images(6, 8, 3, 10, seed, "cpu")
    i2, l2 = make_images(6, 8, 3, 10, seed, "cpu")
    assert torch.equal(i1, i2) and torch.equal(l1, l2) and i1.dtype == torch.uint8
    o1, o2 = chunks(24, 4, 3, seed), chunks(24, 4, 3, seed)
    for _ in range(5):
        x, y = next(o1), next(o2)
        assert x.shape == (3, 4) and np.array_equal(x, y)
    assert 0 <= sub_seed(seed, "weights") < 2 ** 63


def test_perfbench_epoch_rows_all_differ():
    order = chunks(24, 4, 3, 11)
    first, second = next(order), next(order)
    rows = np.concatenate([first.ravel(), second.ravel()])
    assert len(set(rows.tolist())) == 24


def test_perfbench_omega_is_orthogonal_and_kerple_decays():
    cell = tiny(spec.load_cell("kerple-b16-train-n4097"))
    w = make_weights(parameter_spec(cell.config, cell.mix), 3, "cpu")
    omega = w["transformer_blocks.0.attention.omega"]  # [H, D, M], D = 16, M = 12
    d = omega.shape[1]
    gram = omega[0].t() @ omega[0]
    assert torch.allclose(gram, d * torch.eye(omega.shape[2]), atol=1e-4)
    b = w["transformer_blocks.1.rpe.rel_pos_bias"]
    n = (b.shape[1] + 1) // 2
    assert (b[:, n - 1] > b[:, 0] - 0.2).all()


def test_perfbench_xavier_2d_leaves_as_before():
    """A [out, in] leaf is its slice of the one normal draw times
    sqrt(2 / (out + in)), the same float as before conv leaves were taken."""
    leaves = [("a", (6, 10), "xavier"), ("b", (4,), "small"), ("c", (3, 6), "xavier")]
    w = make_weights(leaves, 5, "cpu")
    z = torch.randn(60 + 4 + 18, generator=torch.Generator().manual_seed(sub_seed(5, "weights")))
    assert torch.equal(w["a"], z[:60].view(6, 10) * math.sqrt(2.0 / (6 + 10)))
    assert torch.equal(w["c"], z[64:].view(3, 6) * math.sqrt(2.0 / (3 + 6)))


def test_perfbench_xavier_conv_leaf_has_torchs_std():
    """A [256, 256, 3, 3] conv kernel takes torch's fans (256 x 9 each way):
    its sample standard deviation is xavier_normal_'s within sampling error
    (589,824 draws: about 0.1%)."""
    w = make_weights([("conv", (256, 256, 3, 3), "xavier")], 11, "cpu")["conv"]
    torchs = torch.nn.init.xavier_normal_(torch.empty(256, 256, 3, 3),
                                          generator=torch.Generator().manual_seed(0))
    assert w.std().item() == pytest.approx(torchs.std().item(), rel=5e-3)
    assert w.std().item() == pytest.approx(math.sqrt(2.0 / (2 * 256 * 9)), rel=5e-3)
    with pytest.raises(ValueError, match="rank of 2"):
        make_weights([("v", (8,), "xavier")], 11, "cpu")
