"""Regression: `torch.export` before any live call of a Circulant-STRING
model must not leave fake tensors in the rotation's DFT caches.

The angle tables' sine DFT (`ops/rotations.py::_sin_dft_t`) and the real
DFT matrices of the chain arm and the kernels (`ops/kernels/
circulant_rotate.py::rdft_matrices`, `_kernel_matrices`) are cached per
(size, device). Built for the first time inside an export trace, they were
cached as the trace's fake tensors: every later live call returned a fake
tensor and a second export failed on a fake constant. They are now built
as real tensors outside any tracing mode and lifted into the program as
constants. fp32 logits atol/rtol 1e-5 (the same plain versions on the same
weights).
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

from efficient_rpe_vit_torch.configs import mnist_config
from efficient_rpe_vit_torch.models import create_model
from efficient_rpe_vit_torch.ops import rotations
from efficient_rpe_vit_torch.ops.kernels import circulant_rotate as cr

torch.set_num_threads(2)


@pytest.mark.parametrize("method", ["pallas", "chain"])
def test_export_before_a_live_call_keeps_the_dft_caches_real(method):
    for cache in (rotations._sin_dft_t, cr.rdft_matrices, cr._kernel_matrices):
        cache.cache_clear()
    model = create_model("performer_relu_circulant", mnist_config(depth=2, dropout=0.0),
                         device="cpu", generator=torch.Generator().manual_seed(0),
                         rpe_config={"method": method})
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 28, 28, 1))
                         .astype(np.float32))
    dynamic = ({0: torch.export.Dim("b", min=1)},)
    with torch.no_grad():
        exported = torch.export.export(model, (x,), dynamic_shapes=dynamic, strict=False)
    cached = [rotations._sin_dft_t(16, torch.device("cpu")),
              *cr.rdft_matrices(16, torch.device("cpu"))]
    assert not any(isinstance(t, FakeTensor) for t in cached)
    with torch.no_grad():
        live = model(x)
        assert type(live) is torch.Tensor
        torch.testing.assert_close(exported.module()(x), live, atol=1e-5, rtol=1e-5)
        again = torch.export.export(model, (x,), dynamic_shapes=dynamic, strict=False)
        torch.testing.assert_close(again.module()(x), live, atol=1e-5, rtol=1e-5)
