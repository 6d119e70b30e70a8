"""SAM's image encoder in the port (`models/sam.py`) and the flash op's
decomposed relative-position bias (`ops/kernels/flash_attention.py`,
`rel_pos`).

On the CPU: the op's plain path with the bias against autograd of the dense
formula, at a padded window's shape and a global grid's; the tiny encoder
against the benchmark's plain float32 reference (`perfbench/reference/
sam.py`, which imports nothing of the port) on the same seeded weights,
loaded by name; the full ViT-H's leaves and parameters on the meta device;
the device spans' markers in order on the CPU. Marked `card` (skipped
without one): the bias kernels against the dense fp32 formula at the
cell's two shapes, forward and backward, on the `mma.sync` kernels. On a
card machine (no JAX, so without the suite's conftest):

    python -m pytest tests/test_torch_sam.py -m card --noconftest -q
"""

import pytest
import torch

from efficient_rpe_vit_torch.models import create_model
from efficient_rpe_vit_torch.models.sam import SAM_VIT_H, SamImageEncoder, relative_one_hot
from efficient_rpe_vit_torch.ops.kernels import flash_attention as fa
from efficient_rpe_vit_torch.utils import tracing
from perfbench.reference import sam as reference
from perfbench.reference.precision import Products, float32_products
from perfbench.weights import make_weights

TINY = dict(dim=32, depth=4, heads=2, mlp_dim=64, patch_size=4, window_size=3,
            global_attn_indexes=(1, 3), out_chans=16)
TINY_CONFIG = dict(TINY, global_attn_indexes=list(TINY["global_attn_indexes"]),
                   in_channels=3, num_classes=10)
TINY_MIX = {"image_size": 32, "batch": 3}


def dense_attention(q, k, v, rel_h, rel_w, scale):
    """softmax(scale q k^T + rel_h[i, j // kw] + rel_w[i, j % kw]) v in
    float64, by plain autograd."""
    B, H, N, _ = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    s = (q @ k.transpose(-1, -2)) * scale
    s = (s.view(B, H, N, kh, kw) + rel_h[..., :, None] + rel_w[..., None, :]).view(B, H, N, N)
    return torch.softmax(s, dim=-1) @ v


def _operands(shape, dtype, device, generator):
    B, H, N, D, kh, kw = shape
    q, k, v = (torch.randn(B, H, N, D, generator=generator).to(device, dtype) for _ in range(3))
    rel_h = torch.randn(B, H, N, kh, generator=generator).to(device)
    rel_w = torch.randn(B, H, N, kw, generator=generator).to(device)
    return q, k, v, rel_h, rel_w


# (B, H, N, D, kh, kw): 3 x 3 windows of a grid padded from 8 to 9 (9 of them
# for 1 image), a global 8 x 8 grid, and a grid of unequal sides
CPU_SHAPES = [(9, 2, 9, 16, 3, 3), (2, 2, 64, 16, 8, 8), (2, 3, 12, 8, 3, 4)]


@pytest.mark.parametrize("shape", CPU_SHAPES, ids=["window", "global", "unequal"])
def test_flash_rel_pos_cpu_matches_dense_autograd(shape):
    """Float32 on the CPU differs from float64 autograd by rounding only:
    1e-5 absolute on outputs of order 1 and gradients of order 1 (the op
    sums at most 64 fp32 terms per entry)."""
    gen = torch.Generator().manual_seed(0)
    ops = [t.requires_grad_() for t in _operands(shape, torch.float32, "cpu", gen)]
    scale = shape[3] ** -0.5
    out = fa.flash_softmax_attention(*ops[:3], scale, rel_pos=tuple(ops[3:]))
    wide = [t.detach().double().requires_grad_() for t in ops]
    ref = dense_attention(*wide, scale)
    g = torch.randn(out.shape, generator=gen)
    grads = torch.autograd.grad(out, ops, g)
    ref_grads = torch.autograd.grad(ref, wide, g.double())
    torch.testing.assert_close(out.double(), ref, atol=1e-5, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv", "d rel_h", "d rel_w"), grads, ref_grads):
        torch.testing.assert_close(a.double(), b, atol=1e-5, rtol=0, msg=name)


def test_flash_rel_pos_backward_parts_agree():
    """The op's backward pieces: `flash_attention_bwd` returns the dq pass's
    bias gradients beside dq, dk, dv; a grid that does not hold N keys is
    refused."""
    gen = torch.Generator().manual_seed(1)
    q, k, v, rel_h, rel_w = _operands(CPU_SHAPES[0], torch.float32, "cpu", gen)
    scale = 0.25
    out, lse = fa.flash_attention_fwd(q, k, v, scale, rel_pos=(rel_h, rel_w))
    g = torch.randn(out.shape, generator=gen)
    dq, dk, dv, dh, dw = fa.flash_attention_bwd(q, k, v, out, lse, g, scale,
                                                rel_pos=(rel_h, rel_w))
    delta = fa.flash_delta(out, g)
    dq2, dh2, dw2 = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale,
                                              rel_pos=(rel_h, rel_w))
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale, rel_pos=(rel_h, rel_w))
    for a, b in zip((dq, dk, dv, dh, dw), (dq2, dk2, dv2, dh2, dw2)):
        assert torch.equal(a, b)
    # d rel is the sum of dS over each grid row / column: its total is dS's,
    # which is zero per query row (softmax's gradient)
    assert dh.sum(-1).abs().max() < 1e-5 and dw.sum(-1).abs().max() < 1e-5
    with pytest.raises(ValueError, match="does not hold"):
        fa.flash_attention_fwd(q, k, v, scale, rel_pos=(rel_h[..., :2].contiguous(), rel_w))


def test_relative_one_hot_picks_sams_offsets():
    side = 5
    table = torch.randn(2 * side - 1, 4)
    gathered = (relative_one_hot(side) @ table).view(side, side, 4)
    a = torch.arange(side)
    assert torch.equal(gathered, table[a[:, None] - a[None, :] + side - 1])


def _tiny_model():
    cfg = {"image_size": TINY_MIX["image_size"], "in_channels": 3, "num_classes": 10,
           "compute_dtype": "float32"}
    return create_model("sam_vit_h", cfg, device="cpu", **TINY)


def test_sam_tiny_matches_the_plain_reference():
    """The port's tiny encoder on the benchmark's seeded weights, loaded by
    name, against the plain float32 reference: logits to 1e-5 and every
    leaf's gradient to 1e-4 of its norm. Both run in float32 on the CPU;
    they differ in the order of their sums only (the port's flash op and
    one-hot table products, the reference's dense scores and indexed
    tables), which moves values by a few fp32 ulps."""
    torch.manual_seed(0)
    model = _tiny_model()
    spec = reference.parameter_spec(TINY_CONFIG, TINY_MIX)
    weights = make_weights(spec, 2 ** 31 + 5, "cpu")
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(weights) and not list(model.named_buffers())
    with torch.no_grad():
        for name, t in weights.items():
            named[name].copy_(t)
    x = torch.randn(TINY_MIX["batch"], 32, 32, 3, generator=torch.Generator().manual_seed(2))
    labels = torch.tensor([1, 4, 7])
    logits = model.train()(x)
    torch.nn.functional.cross_entropy(logits, labels).backward()
    w = {n: t.clone().requires_grad_() for n, t in weights.items()}
    with float32_products():
        ref = reference.forward(w, x, TINY_CONFIG, Products("fp32"))
        torch.nn.functional.cross_entropy(ref, labels).backward()
    torch.testing.assert_close(logits, ref, atol=1e-5, rtol=0)
    for name, p in named.items():
        scale = float(w[name].grad.norm())
        assert scale > 0, name
        gap = float((p.grad - w[name].grad).norm())
        assert gap <= 1e-4 * scale, (name, gap, scale)


def test_sam_vit_h_leaves_and_parameters():
    """build_sam_vit_h's encoder with the head: 459 leaves (3 + 32 x 14 + 6
    + 2), 637,283,048 parameters, SAM's names and shapes (on the meta
    device: nothing is allocated)."""
    with torch.device("meta"):
        model = SamImageEncoder(1024, 3, 1000, dtype="bfloat16", **SAM_VIT_H)
    named = dict(model.named_parameters())
    assert len(named) == 459 and not list(model.named_buffers())
    assert sum(p.numel() for p in named.values()) == 637_283_048
    assert named["patch_embed.proj.weight"].shape == (1280, 3, 16, 16)
    assert named["pos_embed"].shape == (1, 64, 64, 1280)
    assert named["blocks.0.attn.rel_pos_h"].shape == (27, 80)
    assert named["blocks.7.attn.rel_pos_w"].shape == (127, 80)
    assert named["neck.2.weight"].shape == (256, 256, 3, 3)
    assert named["head.weight"].shape == (1000, 256)
    assert [i for i, b in enumerate(model.blocks) if b.window == 0] == [7, 15, 23, 31]
    spec = reference.parameter_spec(dict(SAM_VIT_H, in_channels=3, num_classes=1000),
                                    {"image_size": 1024, "batch": 4})
    assert {n: tuple(s) for n, s, _ in spec} == {n: tuple(p.shape) for n, p in named.items()}


def test_sam_spans_mark_in_order():
    """Each windowed block marks the window copies around the bias rows and
    the windowed op, each global block the bias rows and the global op; the
    backward marks them again in reverse, through the identity functions."""
    model = _tiny_model().train()
    x = torch.randn(1, 32, 32, 3)
    tracing.clear()
    tracing.enable(True)
    try:
        model(x).sum().backward()
    finally:
        tracing.enable(False)

    def span(name):
        return [f"rpe_mark_begin_{name}", f"rpe_mark_end_{name}"]

    def forward_block(windowed):
        attn = "attn_window" if windowed else "attn_global"
        inner = span("relpos") + span(attn)
        return span("window") + inner + span("window") if windowed else inner

    def backward_block(windowed):
        attn = "attn_window_bwd" if windowed else "attn_global_bwd"
        inner = span(attn) + span("relpos_bwd")
        return span("window_bwd") + inner + span("window_bwd") if windowed else inner

    windowed = [i not in TINY["global_attn_indexes"] for i in range(TINY["depth"])]
    expected = sum((forward_block(w) for w in windowed), [])
    expected += sum((backward_block(w) for w in reversed(windowed)), [])
    assert tracing.marks() == expected
    tracing.clear()


# ─── on the card ──────────────────────────────────────────────────────────

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the bias kernels are CUDA C++ and have no CPU build")
    return torch.device("cuda", 0)


# (B, H, N, D, kh, kw): the cell's windowed call (4 images x 25 windows) and
# its global call
CARD_SHAPES = [(100, 16, 196, 80, 14, 14), (4, 16, 4096, 80, 64, 64)]


@pytest.mark.card
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=["window", "global"])
def test_flash_rel_pos_kernels_match_dense_fp32(card, shape):
    """The bf16 kernels against the dense formula in float32 from the same
    bf16 inputs, each gradient within 2% of its norm and the output within
    1% (bf16 P and dS as the products take them, ~2^-9 relative each); the
    launches run the mma.sync kernels, and a second backward is bitwise
    the first (no atomics)."""
    B, H, N, D, kh, kw = shape
    gen = torch.Generator().manual_seed(3)
    q, k, v, rel_h, rel_w = _operands(shape, torch.bfloat16, card, gen)
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert fa.launch_info(kernel, N, D, torch.bfloat16, (kh, kw))["kernel"] == "mma.sync"
    scale = D ** -0.5
    leaves = [t.requires_grad_() for t in (q, k, v, rel_h, rel_w)]
    fwd = fa.flash_attention_fwd.launches
    out = fa.flash_softmax_attention(*leaves[:3], scale, rel_pos=tuple(leaves[3:]))
    g = torch.randn(out.shape, generator=gen).to(card, torch.bfloat16)
    grads = torch.autograd.grad(out, leaves, g)
    again = torch.autograd.grad(fa.flash_softmax_attention(*leaves[:3], scale,
                                                           rel_pos=tuple(leaves[3:])), leaves, g)
    assert fa.flash_attention_fwd.launches == fwd + 2
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    for lo in range(0, B, 25):  # the dense scores of 25 rows of B at a time
        part = [t.detach()[lo:lo + 25].float().requires_grad_() for t in leaves]
        ref = dense_attention(*part, scale)
        ref_grads = torch.autograd.grad(ref, part, g[lo:lo + 25].float())
        rel = float((out[lo:lo + 25].float() - ref).norm() / ref.norm())
        assert rel < 1e-2, rel
        for name, a, b in zip(("dq", "dk", "dv", "d rel_h", "d rel_w"), grads, ref_grads):
            rel = float((a[lo:lo + 25].float() - b).norm() / b.norm())
            assert rel < 2e-2, (name, rel)
