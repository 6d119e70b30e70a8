"""The port's GPipe train step against the JAX package's
`make_pipeline_train_step`, on the CPU.

The JAX step runs on the conftest's 8 simulated devices, the port's on
gloo ranks (`tests/torch_parallel_worker.py`), from the same flax
variables (the flagship at mnist_config widths, depth 2, dropout 0) and the
same global batch of 8: data=2,pipe=2 at M = 4 (each data rank runs two
rows of every microbatch), the same with grad_accum=2 (two chunks, each a
whole GPipe forward and backward, one update), and data=2,pipe=2,model=2
at M = 2 (the stages Megatron-split). The loss to 1e-5, the correct count
exactly and every parameter after the step to atol 1e-5, the JAX package's
own DP-vs-single-device tolerance (tests/test_parallel.py:108), as
tests/test_torch_parallel.py holds the other sharded steps.
"""

import numpy as np
import pytest

import torch_parallel_worker as worker
from torch_parallel_jax import LOSS_ATOL, PARAM_ATOL, jax_pipeline_step, ok

NAME = "performer_favor_most_general"
DEPTH = 2
# (case, world size, port mesh, JAX mesh shape, JAX axis names, microbatches, grad_accum)
STEPS = [
    ("dp_pp", 4, "data=2,pipe=2", (2, 2), ("data", "pipe"), 4, 1),
    ("dp_pp_accum", 4, "data=2,pipe=2", (2, 2), ("data", "pipe"), 4, 2),
    ("dp_pp_tp", 8, "data=2,pipe=2,model=2", (2, 2, 2), ("data", "pipe", "model"), None, 1),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_out, cases = {}, {}
    for case, world, spec, shape, names, m, accum in STEPS:
        variables, x, y, *jax_out[case] = jax_pipeline_step(shape, names, NAME, DEPTH, m, accum)
        cases.setdefault(world, []).append((case, "pipe_step", dict(
            spec=spec, name=NAME, x=x[None], y=y[None], variables=variables, depth=DEPTH,
            microbatches=m, accum=accum)))
    port = {}
    for world, todo in sorted(cases.items()):
        port.update(worker.run_world(world, todo, tmp_path_factory.mktemp(f"world{world}")))
    return jax_out, port


@pytest.mark.parametrize("case", [c[0] for c in STEPS])
def test_pipeline_step_matches_jax(runs, case):
    jax_out, port = runs
    loss, correct, after = jax_out[case]
    ranks = [ok(r) for r in port[case]]
    for r in ranks:  # every rank returns the global batch's numbers
        assert abs(r["loss"][0] - loss) < LOSS_ATOL, (r["loss"], loss)
        assert r["correct"][0] == correct
    got = ranks[0]["params"]
    assert set(after) <= set(got)
    for name, want in after.items():
        np.testing.assert_allclose(got[name], want, atol=PARAM_ATOL, rtol=0, err_msg=name)
    for r in ranks[1:]:  # every rank assembles the same whole model
        for name in after:
            np.testing.assert_array_equal(r["params"][name], got[name], err_msg=name)


@pytest.mark.parametrize("case", [c[0] for c in STEPS])
def test_stages_hold_their_blocks_and_count_the_whole_model(runs, case):
    """A pipe rank holds its depth / 2 blocks and the replicated ends; the
    parameter count it reports is the whole model's."""
    from efficient_rpe_vit_torch.configs import mnist_config
    from efficient_rpe_vit_torch.models import count_parameters, create_model

    _, port = runs
    whole = count_parameters(create_model(NAME, mnist_config(depth=DEPTH), device="cpu"))
    for rank, r in enumerate(ok(r) for r in port[case]):
        stage = (rank // (2 if case.endswith("tp") else 1)) % 2  # row-major mesh
        blocks = {n.split(".")[1] for n in r["names"] if n.startswith("transformer_blocks.")}
        assert blocks == {str(stage)}, (rank, blocks)
        assert any(n.startswith("mlp_head.") for n in r["names"])
        assert "patch_embedding.weight" in r["names"]
        assert r["count"] == whole["total"]
