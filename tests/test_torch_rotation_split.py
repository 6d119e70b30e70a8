"""The bf16 mma.sync rotation kernels' precision scheme, emulated on the CPU.

`rot_fwd_mma_kernel` and `rot_bwd_mma_kernel` (csrc/circulant_rotate.cu)
compute the DFT products on bf16 tensor cores and keep fp32 accuracy by
splitting every fp32 operand c into hi = bf16(c) and lo = bf16(c - hi):

- the spectrum columns are interleaved, column 2k = re_k and 2k+1 = im_k,
  with the Nyquist re_h in im_0's slot (im_0 and im_h vanish), so the D
  columns of fm (and rows of bm) hold all K = D/2 + 1 frequencies;
- x and g are bf16, hence exact: a spectrum is x fm_lo + x fm_hi;
- the rotated fp32 spectrum s is split too: y = s_lo bm_hi + s_hi bm_lo +
  s_hi bm_hi;
- the backward rotates g's unscaled spectrum back and takes it through the
  same inverse; the angle gradients are summed over the batch and scaled
  by w / D once.

This module writes that arithmetic out in PyTorch (fp32 products of the
bf16-valued parts, as the tensor cores take them) and holds it against the
kernels' plain versions and the JAX package's Pallas `circulant_rotate`
(interpret mode) at chip_smoke.py's ROT_TOL["float32"] (the results before
the bf16 rounding) and ROT_ANGLE_TOL (dct, dst): what the card's kernels
must meet (chip_smoke.py phase 3d holds them at ROT_TOL["bfloat16"] after
rounding). Inputs come from numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ROT_ANGLE_TOL, ROT_TOL
from efficient_rpe_vit_tpu.ops.pallas.rotation_kernels import circulant_rotate as jax_kernel
from efficient_rpe_vit_torch.ops.kernels import circulant_rotate as cr

torch.set_num_threads(2)

# (B, H, N, D): the serving, training and long-N paths' shapes at reduced
# batch, and the JAX kernel tests' D = 16
SHAPES = [(2, 12, 197, 64), (3, 12, 197, 64), (1, 12, 4097, 64), (2, 3, 190, 16)]


def _max_rel(got, want) -> float:
    """max |got - want| / max |want|, as chip_smoke.py measures it."""
    got, want = (t.float() if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))
                 for t in (got, want))
    return ((got - want).abs().max() / want.abs().max()).item()


def _split(t):
    """(hi, lo) with hi = bf16(t), lo = bf16(t - hi), as fp32 tensors."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _interleaved_order(D):
    """For each interleaved column p, its column in the staged fm order
    [re_0 .. re_{h-1}, im_0 .. im_{h-1}, re_h, im_h]: p = 0 re_0, p = 1 re_h,
    p = 2k re_k, p = 2k + 1 im_k."""
    h = D // 2
    return [0, D] + [k if p % 2 == 0 else h + k for p in range(2, D) for k in (p // 2,)]


def _constants(D, passes=2):
    """The interleaved fm [D, D] and bm [D, D], each as its bf16 parts: (hi,
    lo), or (hi,) for one bf16 pass."""
    fm, bm = cr._kernel_matrices(D, torch.device("cpu"))
    order = _interleaved_order(D)
    fm_i, bm_i = fm[:, order], bm[order]
    if passes == 1:
        return (fm_i.to(torch.bfloat16).float(),), (bm_i.to(torch.bfloat16).float(),)
    return _split(fm_i), _split(bm_i)


def _pair_angles(ct, st, D):
    """c, s, c1 [H, N, D/2] for the interleaved pairs: pair 0 is (re_0, re_h),
    rotated by (ct_0, 0) and ct_h; pair k by (ct_k, st_k)."""
    h = D // 2
    c, s = ct[..., :h].clone(), st[..., :h].clone()
    s[..., 0] = 0
    c1 = c.clone()
    c1[..., 0] = ct[..., h]
    return c, s, c1


def _spectrum(x32, fmp):
    return sum(x32 @ m for m in reversed(fmp))  # lo first, then hi


def _inverse(spec, bmp, passes=2):
    if passes == 1:
        return spec.to(torch.bfloat16).float() @ bmp[0]
    s_hi, s_lo = _split(spec)
    return s_lo @ bmp[0] + s_hi @ bmp[1] + s_hi @ bmp[0]


def _pairs(spec):
    return spec[..., 0::2], spec[..., 1::2]


def _interleave(re, im):
    return torch.stack([re, im], dim=-1).flatten(-2)


def emulate_fwd(x, ct, st, keep_cls, passes=2):
    """The forward mma kernel's arithmetic in fp32 (before the bf16 rounding)."""
    D = x.shape[-1]
    fmp, bmp = _constants(D, passes)
    c, s, c1 = _pair_angles(ct, st, D)
    x32 = x.float()
    re, im = _pairs(_spectrum(x32, fmp))
    y = _inverse(_interleave(c * re - s * im, s * re + c1 * im), bmp, passes)
    if keep_cls:
        y[:, :, 0] = x32[:, :, 0]
    return y


def emulate_bwd(g, x, ct, st, keep_cls, passes=2):
    """The backward mma kernel's arithmetic in fp32: (dx before its bf16
    rounding, dct, dst)."""
    D = x.shape[-1]
    h = D // 2
    fmp, bmp = _constants(D, passes)
    c, s, c1 = _pair_angles(ct, st, D)
    g32 = g.float()
    gs = _spectrum(g32, fmp)
    if keep_cls:
        gs[:, :, 0] = 0
    gre, gim = _pairs(gs)
    xre, xim = _pairs(_spectrum(x.float(), fmp))
    acc_c = gre * xre + gim * xim
    acc_s = gim * xre - gre * xim
    # pair 0 holds (re_0, re_h) in both spectra: its sums are dct_0 and dct_h
    acc_c[..., 0] = (gre * xre)[..., 0]
    acc_s[..., 0] = (gim * xim)[..., 0]
    acc_c, acc_s = acc_c.sum(0), acc_s.sum(0)
    dct = torch.zeros_like(ct)
    dst = torch.zeros_like(st)
    dct[..., 1:h], dst[..., 1:h] = acc_c[..., 1:] * (2 / D), acc_s[..., 1:] * (2 / D)
    dct[..., 0], dct[..., h] = acc_c[..., 0] / D, acc_s[..., 0] / D
    dx = _inverse(_interleave(c * gre + s * gim, c1 * gim - s * gre), bmp, passes)
    if keep_cls:
        dx[:, :, 0] = g32[:, :, 0]
    return dx, dct, dst


def _inputs(shape):
    """x, g bf16 [B, H, N, D] and ct, st fp32 [H, N, K], from numpy."""
    B, H, N, D = shape
    rng = np.random.default_rng(sum(shape))
    x, g = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    theta = (rng.normal(size=(H, N, D // 2 + 1)) * 0.3).astype(np.float32)
    return x, g, torch.from_numpy(np.cos(theta)), torch.from_numpy(np.sin(theta))


@pytest.mark.parametrize("D", [16, 32, 48, 64])
def test_interleaved_columns_hold_the_whole_spectrum(D):
    """The interleaved fm gives the staged spectrum's columns in pairs
    (re_k, im_k), re_h in im_0's slot; the two dropped columns, im_0 and
    im_h, are zero (im_h up to sin's fp32 rounding at multiples of pi)."""
    fm, _ = cr._kernel_matrices(D, torch.device("cpu"))
    order = _interleaved_order(D)
    assert sorted(order) == sorted(set(range(D + 2)) - {D // 2, D + 1})
    assert not fm[:, D // 2].any() and fm[:, D + 1].abs().max() < 1e-4
    x = torch.from_numpy(np.random.default_rng(D).normal(size=(5, D)).astype(np.float32))
    torch.testing.assert_close(x @ fm[:, order], (x @ fm)[:, order], rtol=0, atol=0)


@pytest.mark.parametrize("keep_cls", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_products_keep_fp32_accuracy(shape, keep_cls):
    """The emulated mma kernels against the plain versions and the JAX
    kernel: out and dx to ROT_TOL["float32"] before rounding (and
    ROT_TOL["bfloat16"] after), dct and dst to ROT_ANGLE_TOL; the CLS row
    bit for bit with zero angle gradients."""
    x, g, ct, st = _inputs(shape)
    out = emulate_fwd(x, ct, st, keep_cls)
    dx, dct, dst = emulate_bwd(g, x, ct, st, keep_cls)
    plain = (cr.circulant_rotate_fwd_reference(x.float(), ct, st, keep_cls),
             *cr.circulant_rotate_bwd_reference(g.float(), x.float(), ct, st, keep_cls))
    jx, jct, jst = (jnp.asarray(t.float().numpy()) for t in (x, ct, st))
    block = 1024 if shape[2] > 1024 else 256
    j_out, vjp = jax.vjp(lambda a, b, c: jax_kernel(a, b, c, block, True, keep_cls), jx, jct, jst)
    jax_ref = (j_out, *vjp(jnp.asarray(g.float().numpy())))
    tols = (ROT_TOL["float32"],) * 2 + (ROT_ANGLE_TOL,) * 2
    for name, got, p, j, tol in zip(("out", "dx", "dct", "dst"), (out, dx, dct, dst), plain,
                                    jax_ref, tols):
        assert _max_rel(got, p) <= tol, (name, _max_rel(got, p))
        assert _max_rel(got, j) <= tol, (name, _max_rel(got, j))
    for name, got, p in (("out", out, plain[0]), ("dx", dx, plain[1])):
        rounded = _max_rel(got.to(torch.bfloat16), p.to(torch.bfloat16))
        assert rounded <= ROT_TOL["bfloat16"], (name, rounded)
    if keep_cls:
        assert torch.equal(out[:, :, 0], x[:, :, 0].float())
        assert torch.equal(dx[:, :, 0], g[:, :, 0].float())
        assert not dct[:, 0].any() and not dst[:, 0].any()


def test_one_bf16_pass_would_miss_the_angle_tolerance():
    """Why the products are split: with one bf16 pass over the constants
    and the rotated spectrum, dct and dst miss ROT_ANGLE_TOL."""
    x, g, ct, st = _inputs(SHAPES[0])
    _, dct, dst = emulate_bwd(g, x, ct, st, True, passes=1)
    _, want_c, want_s = cr.circulant_rotate_bwd_reference(g.float(), x.float(), ct, st, True)
    assert min(_max_rel(dct, want_c), _max_rel(dst, want_s)) > ROT_ANGLE_TOL
