"""The port's dataset explorer (`experiments/visualize_data.py`'s PNG
mode) against the JAX one on the CPU: on the synthetic MNIST and CIFAR-10
the two figures have the same suptitle, class-distribution bars, pixel
histogram and picked sample images; `main` writes the PNG; matplotlib is
imported only inside the function that draws."""

import ast
import inspect

import matplotlib
import numpy as np
import pytest

from efficient_rpe_vit_torch.experiments import visualize_data
from torch_experiment_cli import flag_defaults, jax_experiment

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

JAX = jax_experiment("visualize_data")


def _contents(fig):
    """(suptitle, [sample images], bar heights, histogram counts, the two
    panels' titles) of an explorer figure."""
    images, panels = [], []
    for ax in fig.axes:
        if ax.images:
            images.append(np.asarray(ax.images[0].get_array()))
        else:
            panels.append(ax)
    bars, hist = panels
    return (fig._suptitle.get_text(), images, [p.get_height() for p in bars.patches],
            [p.get_height() for p in hist.patches], bars.get_title(), hist.get_title())


@pytest.mark.parametrize("name", ["mnist", "cifar10"])
def test_figure_equals_jax(name):
    port_fig, port_data = visualize_data.build_figure(name)
    jax_fig, jax_data = JAX.build_figure(name)
    try:
        assert port_data["synthetic"] is True and jax_data["synthetic"] is True
        got, want = _contents(port_fig), _contents(jax_fig)
        assert got[0] == want[0] and "(synthetic fallback)" in got[0]
        assert len(got[1]) == len(want[1]) == 80
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)
        assert got[2:] == want[2:]
    finally:
        plt.close(port_fig)
        plt.close(jax_fig)


def test_main_writes_the_png(tmp_path):
    out = tmp_path / "mnist_test.png"
    assert visualize_data.main(["mnist", "--split", "test", "--out", str(out)]) == str(out)
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    plt.close("all")
    assert flag_defaults(visualize_data.main, ["mnist"]) == flag_defaults(JAX.main)


def test_matplotlib_is_imported_only_where_it_draws():
    tree = ast.parse(inspect.getsource(visualize_data))
    top = [node for node in tree.body if isinstance(node, (ast.Import, ast.ImportFrom))]
    assert not any("matplotlib" in ast.unparse(node) for node in top)
