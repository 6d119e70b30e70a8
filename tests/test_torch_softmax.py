"""The port's softmax attention (the softmax slice) against the JAX package, on the CPU.

The flash kernels' plain versions (what the wrappers run on CPU tensors)
are held against the JAX package's Pallas kernels run in interpret mode, as
tests/test_pallas_kernels.py runs them: `_flash_fwd_impl` (out, lse) and
`flash_attention_bwd` fused and two-pass, with no mask, [B,1,N,N] and
[B,H,N,N] masks (diagonal kept), dropout and mask plus dropout. The dropout
hash must equal JAX's `dropout_keep_dense` bit for bit. `softmax_attention`
is held against the JAX dense `softmax_attention`, and the `baseline` ViT
(weights copied from flax) against the JAX model: logits, attention maps,
gradients and three train steps. Inputs come from numpy.

Tolerances: kernels fp32 rtol/atol 1e-5 (summation order and the online
softmax's rescaling only); gradients atol 1e-5 times the tensor's largest
value. Models: as tests/test_torch_models.py and test_torch_train.py (fp32
logits and gradients rtol/atol 1e-4, gradients' atol scaled to the
tensor's max; bf16 within 2x of the JAX bf16 model's own error against JAX
fp32; three-step losses rtol 1e-5, parameters within 2e-3 of how far they
moved).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_rpe_vit_tpu.configs import mnist_config as jax_mnist_config
from efficient_rpe_vit_tpu.models import create_model as jax_create_model
from efficient_rpe_vit_tpu.ops import attention_core as jax_core
from efficient_rpe_vit_tpu.ops.pallas.attention_kernels import _flash_fwd_impl
from efficient_rpe_vit_tpu.ops.pallas.attention_kernels import (
    dropout_keep_dense as jax_keep_dense,
)
from efficient_rpe_vit_tpu.ops.pallas.flash_bwd import flash_attention_bwd as jax_flash_bwd
from efficient_rpe_vit_tpu.train import training as jax_training
from efficient_rpe_vit_tpu.utils.import_torch import state_dict_to_params
from efficient_rpe_vit_torch.configs import mnist_config
from efficient_rpe_vit_torch.models import SoftmaxAttention, create_model
from efficient_rpe_vit_torch.models.rpe import KerpleRPE
from efficient_rpe_vit_torch.ops import attention_core as torch_core
from efficient_rpe_vit_torch.ops import softmax_attention
from efficient_rpe_vit_torch.ops.kernels import _build
from efficient_rpe_vit_torch.ops.kernels import flash_attention as fa
from efficient_rpe_vit_torch.train import (
    create_train_state,
    cross_entropy_loss,
    make_eval_step,
    make_train_step,
)
from efficient_rpe_vit_torch.utils import flax_to_state_dict, load_flax_variables

torch.set_num_threads(2)

KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_ATOL_SCALE = 1e-5
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_GRAD_RTOL, MODEL_GRAD_ATOL_SCALE = 1e-4, 1e-4
BF16_ERROR_FACTOR = 2.0
PARAM_REL_TOL = 2e-3
SMALL = dict(dim=64, heads=2, depth=2, mlp_dim=128, dropout=0.0)
SEEDS = [0, 7, 12345, 2 ** 31 + 5]


def _jax_seed(seed):
    """A seed as the JAX kernels take it: int32, uint32 bit-cast."""
    return jax.lax.bitcast_convert_type(jnp.uint32(seed), jnp.int32)


def _qkvg(seed, B, H, N, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, N, D)).astype(np.float32) for _ in range(4)]


def _mask(seed, B, Hm, N):
    rng = np.random.default_rng(seed)
    return (rng.random((B, Hm, N, N)) > 0.3) | np.eye(N, dtype=bool)


# ─── the dropout hash ───────────────────────────────────────────────────

@pytest.mark.parametrize("n", [17, 197])
@pytest.mark.parametrize("seed", SEEDS)
def test_dropout_hash_matches_jax_bit_for_bit(seed, n):
    want = np.asarray(jax_keep_dense(_jax_seed(seed), 2, 3, n, n, 0.1))
    got = fa.dropout_keep_dense(seed, 2, 3, n, n, 0.1)
    assert got.dtype == torch.bool and got.shape == (2, 3, n, n)
    np.testing.assert_array_equal(got.numpy(), want)
    # the same bits from every seed form the kernels take
    for form in (torch.tensor(seed, dtype=torch.int64),
                 torch.tensor([seed], dtype=torch.uint32),
                 fa.seed_operand(seed, "cpu")):
        torch.testing.assert_close(fa.dropout_keep_dense(form, 2, 3, n, n, 0.1), got,
                                   rtol=0, atol=0)


def test_dropout_keep_rate_and_threshold():
    keep = fa.dropout_keep_dense(3, 2, 2, 128, 128, 0.25)
    assert abs(keep.float().mean().item() - 0.75) < 0.01
    assert fa.keep_threshold(0.0) == 2 ** 32 - 1 and fa.keep_threshold(0.5) == 2 ** 31
    assert not torch.equal(keep, fa.dropout_keep_dense(4, 2, 2, 128, 128, 0.25))


# ─── plain versions against the interpret-mode Pallas kernels ───────────

OPTIONS = {"plain": (None, 0.0), "mask_B1NN": (1, 0.0), "mask_BHNN": (2, 0.0),
           "dropout": (None, 0.1), "mask_dropout": (2, 0.1)}


@pytest.mark.parametrize("n", [17, 130, 197])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_plain_versions_match_jax_kernels(option, n):
    """Forward (out, lse) and backward (dq, dk, dv) at B=H=2, D=16, fp32,
    against the interpret-mode `_flash_kernel` and both `flash_attention_bwd`
    strategies."""
    mask_heads, rate = OPTIONS[option]
    B, H, D, scale, seed = 2, 2, 16, 0.25, 12345
    q, k, v, g = _qkvg(n, B, H, n, D)
    mask = None if mask_heads is None else _mask(n + 1, B, mask_heads, n)
    jm = None if mask is None else jnp.asarray(mask.astype(np.int32))
    jseed = _jax_seed(seed) if rate else None
    j_out, j_lse = _flash_fwd_impl(*(jnp.asarray(a) for a in (q, k, v)), jm, jseed,
                                   scale=scale, dropout_rate=rate, block_q=None,
                                   block_kv=None, interpret=True)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = fa.flash_attention_fwd(*t, scale, tm, rate, seed if rate else None)
    assert out.dtype == torch.float32 and lse.shape == (B, H, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **KERNEL_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **KERNEL_TOL)

    got = fa.flash_attention_bwd(*t, torch.from_numpy(np.array(j_out)),
                                 torch.from_numpy(np.array(j_lse)), torch.from_numpy(g),
                                 scale, tm, rate, seed if rate else None)
    for fused in (True, False):
        want = jax_flash_bwd(*(jnp.asarray(a) for a in (q, k, v)), j_out, j_lse,
                             jnp.asarray(g), scale=scale, interpret=True, mask=jm,
                             dropout_rate=rate, dropout_seed=jseed, fused=fused)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=KERNEL_TOL["rtol"],
                                       atol=GRAD_ATOL_SCALE * np.abs(b).max(),
                                       err_msg=f"{name} fused={fused}")


def test_plain_versions_bf16_round_where_the_kernels_round():
    """bf16 inputs: out and the gradients come back in bf16, close to the
    fp32 result at bf16 precision, and lse is fp32."""
    q, k, v, g = (torch.from_numpy(a) for a in _qkvg(1, 2, 2, 50, 16))
    out32, lse32 = fa.flash_attention_fwd(q, k, v, 0.25)
    bf = [t.to(torch.bfloat16) for t in (q, k, v, g)]
    out, lse = fa.flash_attention_fwd(*bf[:3], 0.25)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), out32, rtol=2e-2, atol=2e-2)
    grads = fa.flash_attention_bwd(*bf[:3], out, lse, bf[3], 0.25)
    want = fa.flash_attention_bwd(q, k, v, out32, lse32, g, 0.25)
    for a, b in zip(grads, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b, rtol=5e-2, atol=5e-2 * b.abs().max().item())


@pytest.mark.parametrize("option", ["plain", "mask_dropout"])
def test_backward_kernels_compose_to_the_backward(option):
    """The fused kernel's plain version and the dq + dkv split give the
    backward's result bit for bit, from the same delta."""
    mask_heads, rate = OPTIONS[option]
    q, k, v, g = (torch.from_numpy(a) for a in _qkvg(2, 2, 2, 70, 16))
    mask = None if mask_heads is None else torch.from_numpy(_mask(3, 2, mask_heads, 70))
    out, lse = fa.flash_attention_fwd(q, k, v, 0.25, mask, rate, 9)
    delta = fa.flash_delta(out, g)
    args = (q, k, v, g, lse, delta, 0.25, mask, rate, 9)
    whole = fa.flash_attention_bwd(q, k, v, out, lse, g, 0.25, mask, rate, 9)
    fused = fa.flash_attention_bwd_fused(*args)
    split = (fa.flash_attention_bwd_dq(*args), *fa.flash_attention_bwd_dkv(*args))
    for a, b, c in zip(whole, fused, split):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)


# ─── softmax_attention against the JAX dense path ───────────────────────

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("method", ["flash", "dense", "auto"])
def test_softmax_attention_matches_jax(method, masked):
    q, k, v, _ = _qkvg(4, 2, 3, 40, 16)
    mask = _mask(5, 2, 1, 40)[:, 0] if masked else None  # [B, N, N]
    want = jax_core.softmax_attention(*(jnp.asarray(a) for a in (q, k, v)), 0.25,
                                      mask=None if mask is None else jnp.asarray(mask))
    got = softmax_attention(*(torch.from_numpy(a) for a in (q, k, v)), 0.25,
                            mask=None if mask is None else torch.from_numpy(mask),
                            method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("method", ["dense", "auto"])
def test_softmax_attention_returns_the_probabilities(method):
    q, k, v, _ = _qkvg(6, 2, 2, 30, 8)
    mask = _mask(7, 2, 2, 30)
    j_out, j_attn = jax_core.softmax_attention(
        *(jnp.asarray(a) for a in (q, k, v)), 0.3, mask=jnp.asarray(mask),
        return_attention=True)
    out, attn = softmax_attention(*(torch.from_numpy(a) for a in (q, k, v)), 0.3,
                                  mask=torch.from_numpy(mask), return_attention=True,
                                  method=method)
    assert attn.shape == (2, 2, 30, 30) and attn.dtype == torch.float32
    # 'auto' with return_attention is the dense arm below the byte budget
    assert torch_core.softmax_arm(method, 2, 2, 30, return_attention=True) == "dense"
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **KERNEL_TOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(j_attn), **KERNEL_TOL)
    with pytest.raises(ValueError, match="dense"):
        softmax_attention(*(torch.from_numpy(a) for a in (q, k, v)), 0.3,
                          return_attention=True, method="flash")
    with pytest.raises(ValueError, match="unknown method"):
        softmax_attention(*(torch.from_numpy(a) for a in (q, k, v)), 0.3, method="ring")


@pytest.mark.parametrize("masked", [False, True])
def test_flash_and_dense_arms_drop_the_same_cells(masked):
    """With one seed both arms drop the cells of the counter hash: outputs
    and q, k, v gradients agree (the dense arm through autograd, the flash
    arm through the backward kernels' plain versions); the cotangent
    arrives non-contiguous, as through the head merge."""
    base = [torch.from_numpy(a) for a in _qkvg(8, 2, 3, 45, 16)[:3]]
    mask = torch.from_numpy(_mask(9, 2, 3, 45)) if masked else None
    g = torch.from_numpy(_qkvg(10, 2, 45, 3, 16)[0]).transpose(1, 2)
    seed = torch.tensor([-123456], dtype=torch.int32)
    results = {}
    for method in ("flash", "dense"):
        q, k, v = (t.clone().requires_grad_() for t in base)
        out = softmax_attention(q, k, v, 0.25, mask=mask, dropout_rate=0.2,
                                dropout_seed=seed, method=method)
        out.backward(g)
        results[method] = [out.detach(), q.grad, k.grad, v.grad]
    assert "FlashSoftmax" in type(fa.flash_softmax_attention(
        *(t.clone().requires_grad_() for t in base), 0.25).grad_fn).__name__
    for a, b in zip(results["flash"], results["dense"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item())
    # dropout is live: without it the output differs
    no_drop = softmax_attention(*base, 0.25, mask=mask, method="flash")
    assert not torch.allclose(no_drop, results["flash"][0])


def test_op_without_autograd_is_the_forward_alone():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkvg(11, 1, 2, 9, 8)[:3])
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            out = fa.flash_softmax_attention(q, k, v, 0.3)
        assert out.grad_fn is None and not out.requires_grad


# ─── the kernel wrappers ────────────────────────────────────────────────

def _good(dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in _qkvg(12, 1, 2, 9, 4)[:3]]


def _bad_fwd_inputs():
    """name -> (q, k, v, mask, rate, seed) the forward wrapper refuses."""
    q, k, v = _good()
    mask = torch.ones(1, 1, 9, 9, dtype=torch.bool)
    return {
        "k_shape": (q, k[:, :, :-1].contiguous(), v, None, 0.0, None),
        "mixed_dtype": (q, k, v.to(torch.bfloat16), None, 0.0, None),
        "float16": (*(t.half() for t in (q, k, v)), None, 0.0, None),
        "non_contiguous": (q, k, v.transpose(2, 3).contiguous().transpose(2, 3), None, 0.0,
                           None),
        "rank": (q[0], k[0], v[0], None, 0.0, None),
        "two_devices": (q, k, v.to("meta"), None, 0.0, None),
        "meta_device": (*(t.to("meta") for t in (q, k, v)), None, 0.0, None),
        "mask_heads": (q, k, v, torch.ones(1, 3, 9, 9), 0.0, None),
        "mask_batch": (q, k, v, torch.ones(2, 1, 9, 9), 0.0, None),
        "mask_length": (q, k, v, mask[..., :-1], 0.0, None),
        "mask_rank": (q, k, v, mask[0, 0], 0.0, None),
        "dropout_without_seed": (q, k, v, None, 0.1, None),
        "dropout_rate_one": (q, k, v, None, 1.0, 3),
        "seed_two_values": (q, k, v, None, 0.1, torch.tensor([1, 2])),
        "seed_float": (q, k, v, None, 0.1, torch.tensor(1.0)),
    }


@pytest.mark.parametrize("case", sorted(_bad_fwd_inputs()))
def test_wrappers_reject_bad_inputs(case):
    q, k, v, mask, rate, seed = _bad_fwd_inputs()[case]
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention_fwd(q, k, v, 0.5, mask, rate, seed)
    if q.dim() == 4 and q.device == k.device == v.device and q.device.type == "cpu" \
            and q.shape == k.shape == v.shape:
        # the backward wrappers refuse the same inputs
        g = torch.ones_like(q)
        rows = torch.zeros(q.shape[:3])
        for fn in (fa.flash_attention_bwd_fused, fa.flash_attention_bwd_dq,
                   fa.flash_attention_bwd_dkv):
            with pytest.raises((ValueError, TypeError)):
                fn(q, k, v, g, rows, rows, 0.5, mask, rate, seed)


def test_backward_wrappers_check_lse_and_delta():
    q, k, v = _good()
    g = torch.ones_like(q)
    ok = torch.zeros(1, 2, 9)
    for lse, delta in ((ok.double(), ok), (ok, ok[..., :-1]), (ok[None], ok)):
        for fn in (fa.flash_attention_bwd_fused, fa.flash_attention_bwd_dq,
                   fa.flash_attention_bwd_dkv):
            with pytest.raises(ValueError):
                fn(q, k, v, g, lse, delta, 0.5)
    out, lse = fa.flash_attention_fwd(q, k, v, 0.5)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, out[..., :-1], lse, g, 0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_counts_do_not_move_on_cpu(dtype):
    fns = (fa.flash_attention_fwd, fa.flash_attention_bwd_fused,
           fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [f.launches for f in fns]
    q, k, v = _good(dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, 0.5, None, 0.1, 4)
    assert out.dtype == dtype and lse.dtype == torch.float32
    for fused in (True, False, None):
        grads = fa.flash_attention_bwd(q, k, v, out, lse, torch.ones_like(out), 0.5,
                                       None, 0.1, 4, fused=fused)
        assert [t.dtype for t in grads] == [dtype] * 3
    assert [f.launches for f in fns] == before


def test_kernel_sources_are_in_the_package():
    """Both CUDA sources and their shared headers ship in the package; each
    source builds into its own library, named by a hash that covers the
    headers too; the backward sums in a fixed order (no float atomics); the
    bf16 forward, dq, dkv and fused pass are the mma.sync kernels of
    flash_attention_mma.cuh, which both sources include (the staged fused
    kernel beside them for fp32 and the shapes the mma.sync one does not
    take)."""
    for name in (fa._FWD_SOURCE, fa._BWD_SOURCE):
        assert (_build.CSRC / f"{name}.cu").is_file()
        assert _build.library_path(name).parent == _build.BUILD_DIR
    for header in ("flash_attention_common.cuh", "flash_attention_mma.cuh"):
        assert (_build.CSRC / header).is_file()
    assert _build.library_path(fa._FWD_SOURCE) != _build.library_path(fa._BWD_SOURCE)
    fwd = (_build.CSRC / f"{fa._FWD_SOURCE}.cu").read_text()
    bwd = (_build.CSRC / f"{fa._BWD_SOURCE}.cu").read_text()
    assert "atomicAdd" not in bwd and "flash_bwd_fused_fits" in bwd
    assert '#include "flash_attention_mma.cuh"' in fwd and "flash_fwd_mma_kernel" in fwd
    for kernel in ("flash_bwd_dq_mma_kernel", "flash_bwd_dkv_mma_kernel",
                   "flash_bwd_fused_mma_kernel", "flash_bwd_fused_kernel"):
        assert kernel in bwd
    assert '#include "flash_attention_mma.cuh"' in bwd
    assert "flash_fwd_launch_info" in fwd and "flash_bwd_launch_info" in bwd


@pytest.mark.parametrize("args, error", [
    (("flash_bwd", 197, 64, torch.bfloat16), ValueError),
    (("flash_fwd", 197, 64, torch.float16), TypeError),
    (("flash_bwd_dq", 0, 64, torch.bfloat16), ValueError),
    (("flash_bwd_dkv", 197, fa.MAX_D + 1, torch.float32), ValueError),
    (("flash_bwd_fused", 197, 0, torch.float32), ValueError),
])
def test_launch_info_refuses_bad_arguments(args, error):
    """launch_info checks its arguments before it asks the library (which
    needs a GPU), and names what it reports."""
    with pytest.raises(error):
        fa.launch_info(*args)
    assert fa.LAUNCH_INFO_KEYS == ("rows", "threads", "smem_bytes", "blocks_per_sm",
                                   "registers", "spill_bytes")


# ─── the baseline model against the JAX package ─────────────────────────

def _variables(jmodel, cfg, seed=0):
    m = cfg.model
    sample = jnp.zeros((1, m.image_size, m.image_size, m.in_channels))
    variables = jmodel.init({"params": jax.random.PRNGKey(seed)}, sample)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _pair(name, overrides, dtype="float32", attention_config=None):
    """(jax model, its variables, port model with the same weights)."""
    jcfg = jax_mnist_config(**overrides, compute_dtype=dtype)
    jmodel = jax_create_model(name, jcfg)
    variables = _variables(jmodel, jcfg)
    assert set(variables) == {"params"}  # softmax attention keeps no constants
    tmodel = create_model(name, mnist_config(**overrides, compute_dtype=dtype),
                          attention_config=attention_config, device="cpu")
    load_flax_variables(tmodel, variables["params"])
    return jmodel, variables, tmodel


def _images(overrides, batch, seed):
    m = jax_mnist_config(**overrides).model
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, m.image_size, m.image_size, m.in_channels)).astype(np.float32)
    y = rng.integers(0, m.num_classes, size=batch).astype(np.int32)
    return x, y


def _jax_logits(jmodel, variables, x, **kw):
    return jmodel.apply(variables, jnp.asarray(x), deterministic=True, **kw)


def _port_logits(tmodel, x, **kw):
    with torch.inference_mode():
        return tmodel(torch.from_numpy(x), **kw)


@pytest.mark.parametrize("method", ["flash", "dense"])
@pytest.mark.parametrize("patch", [7, 4], ids=["N17", "N50"])
def test_baseline_logits_match_jax_fp32(patch, method):
    overrides = dict(SMALL, patch_size=patch)
    jmodel, variables, tmodel = _pair("baseline", overrides,
                                      attention_config={"method": method})
    x, _ = _images(overrides, 3, seed=0)
    got = _port_logits(tmodel, x)
    assert got.shape == (3, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_logits(jmodel, variables, x)),
                               **FP32_TOL)


@pytest.mark.parametrize("patch", [7, 4], ids=["N17", "N50"])
def test_baseline_logits_match_jax_bf16(patch):
    overrides = dict(SMALL, patch_size=patch)
    jmodel32, variables, _ = _pair("baseline", overrides)
    jmodel16, _, tmodel16 = _pair("baseline", overrides, dtype="bfloat16")
    x, _ = _images(overrides, 4, seed=1)
    ref = np.asarray(_jax_logits(jmodel32, variables, x))
    jax_err = np.abs(np.asarray(_jax_logits(jmodel16, variables, x)) - ref).max()
    port_err = np.abs(_port_logits(tmodel16, x).numpy() - ref).max()
    assert 0 < jax_err < 0.5
    assert port_err <= BF16_ERROR_FACTOR * jax_err, (port_err, jax_err)


def test_baseline_full_width_depth1_matches_jax():
    """ViT-B/16 widths (dim 768, 12 heads, head_dim 64, N=197), depth 1, fp32."""
    overrides = dict(image_size=224, patch_size=16, in_channels=3, num_classes=1000,
                     dim=768, depth=1, heads=12, mlp_dim=3072, dropout=0.0)
    jmodel, variables, tmodel = _pair("baseline", overrides)
    x, _ = _images(overrides, 2, seed=2)
    np.testing.assert_allclose(_port_logits(tmodel, x).numpy(),
                               np.asarray(_jax_logits(jmodel, variables, x)), **FP32_TOL)


def test_attention_maps_match_jax():
    overrides = dict(SMALL, patch_size=7)
    jmodel, variables, tmodel = _pair("vit", overrides)
    x, _ = _images(overrides, 2, seed=3)
    j_logits, j_maps = _jax_logits(jmodel, variables, x, return_attention=True)
    logits, maps = _port_logits(tmodel, x, return_attention=True)
    assert len(maps) == len(j_maps) == SMALL["depth"]
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **FP32_TOL)
    for a, b in zip(maps, j_maps):
        assert a.shape == (2, 2, 17, 17)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(a.sum(-1), torch.ones(2, 2, 17))


def _jax_grads(jmodel, variables, x, y):
    def loss(params):
        logits = jmodel.apply({"params": params}, jnp.asarray(x), deterministic=True)
        return jax_training.cross_entropy_loss(logits.astype(jnp.float32), jnp.asarray(y))

    grads = jax.jit(jax.grad(loss))(variables["params"])
    return {n: t.numpy() for n, t in
            flax_to_state_dict(jax.tree_util.tree_map(np.asarray, grads)).items()}


def _port_grads(tmodel, x, y):
    tmodel.train()
    tmodel.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(tmodel(torch.from_numpy(x), torch.Generator()),
                              torch.from_numpy(y).long())
    loss.backward()
    return {n: p.grad.float().numpy() for n, p in tmodel.named_parameters()}


@pytest.mark.parametrize("method", ["flash", "dense"])
def test_baseline_gradients_match_jax_fp32(method):
    overrides = dict(SMALL, patch_size=7)
    jmodel, variables, tmodel = _pair("baseline", overrides,
                                      attention_config={"method": method})
    x, y = _images(overrides, 3, seed=4)
    got, want = _port_grads(tmodel, x, y), _jax_grads(jmodel, variables, x, y)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=MODEL_GRAD_RTOL,
                                   atol=MODEL_GRAD_ATOL_SCALE * np.abs(want[name]).max(),
                                   err_msg=name)


def test_baseline_three_train_steps_match_jax():
    overrides = dict(SMALL, patch_size=7)
    jmodel, variables, tmodel = _pair("baseline", overrides)
    jcfg = jax_mnist_config(**overrides)
    jstate = jax_training.create_train_state(jmodel, jcfg, jax.random.PRNGKey(0),
                                             jnp.zeros((1, 28, 28, 1)), steps_per_epoch=2)
    jstep = jax_training.make_train_step(jmodel)
    state = create_train_state(tmodel, mnist_config(**overrides), steps_per_epoch=2)
    step = make_train_step(tmodel, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        x, y = _images(overrides, 4, seed=10 + i)
        jstate, jloss, jcorrect = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                                        jax.random.PRNGKey(i))
        state, loss, correct = step(state, torch.from_numpy(x), torch.from_numpy(y), gen)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        assert correct.item() == int(jcorrect)
    start = flax_to_state_dict(variables["params"])
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))
    for n, p in tmodel.named_parameters():
        moved = np.linalg.norm(want[n].numpy() - start[n].numpy())
        diff = np.linalg.norm(p.detach().numpy() - want[n].numpy())
        assert moved > 0 and diff <= PARAM_REL_TOL * moved, (n, diff, moved)


def test_baseline_state_dict_round_trips_through_jax_importer():
    _, variables, tmodel = _pair("baseline", dict(SMALL, patch_size=7))
    assert not any("omega" in k for k in tmodel.state_dict())
    back, back_consts = state_dict_to_params(tmodel.state_dict(), variables["params"])
    assert back_consts is None
    want = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    flat = jax.tree_util.tree_leaves_with_path(back)
    assert len(flat) == len(want)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(leaf), want[path], err_msg=str(path))


def test_eval_step_serves_baseline():
    overrides = dict(SMALL, patch_size=7)
    jmodel, variables, tmodel = _pair("baseline", overrides)
    x, _ = _images(overrides, 5, seed=5)
    logits = np.asarray(_jax_logits(jmodel, variables, x))
    labels = np.argmax(logits, -1).astype(np.int32)
    loss, correct, preds = make_eval_step(tmodel, device="cpu")(
        torch.from_numpy(x), torch.from_numpy(labels))
    assert correct.item() == 5
    np.testing.assert_array_equal(preds.numpy(), labels)


# ─── the module ─────────────────────────────────────────────────────────

def test_baseline_and_vit_build_without_omega():
    cfg = mnist_config(**SMALL)
    for name in ("baseline", "vit"):
        model = create_model(name, cfg, device="cpu", generator=torch.Generator().manual_seed(1))
        attn = model.transformer_blocks[0].attention
        assert isinstance(attn, SoftmaxAttention) and attn.method == "auto"
        assert not any("omega" in k for k in model.state_dict())
    again = create_model("vit", cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    for (ka, va), (kb, vb) in zip(model.state_dict().items(), again.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    dense = create_model("baseline", cfg, device="cpu", attention_config={"method": "dense"})
    assert dense.transformer_blocks[1].attention.method == "dense"


def test_softmax_attention_module_refusals():
    attn = SoftmaxAttention(dim=32, heads=2)
    x = torch.zeros(1, 17, 32)
    with pytest.raises(NotImplementedError, match="KERPLE RPE is designed"):
        attn(x, rpe=KerpleRPE(num_patches=17, dim=32, heads=2))
    with pytest.raises(TypeError, match="unsupported RPE module"):
        attn(x, rpe=torch.nn.Identity())
    with pytest.raises(TypeError, match="seq_mesh must be a parallel.Mesh"):
        SoftmaxAttention(dim=32, heads=2, seq_mesh=object())
    with pytest.raises(NotImplementedError):
        create_model("baseline_most_general", mnist_config(**SMALL), device="cpu")
    # the KERPLE variants still refuse return_attention
    kerple = create_model("performer_favor_most_general", mnist_config(**SMALL), device="cpu")
    with pytest.raises(NotImplementedError):
        kerple(torch.zeros(1, 28, 28, 1), return_attention=True)


def test_train_mode_dropout_draws_from_the_generator():
    """Attention-probability dropout is live only in train mode; its seed
    and the output dropout come from the caller's generator, so the flash
    and dense arms give the same outputs from one generator seed."""
    cfg = mnist_config(**dict(SMALL, dropout=0.3))
    models = {m: create_model("baseline", cfg, device="cpu", attention_config={"method": m},
                              generator=torch.Generator().manual_seed(2))
              for m in ("flash", "dense")}
    x = torch.from_numpy(_images(SMALL, 2, seed=6)[0])
    with torch.no_grad():
        e1 = models["flash"].eval()(x)
        t = {m: model.train()(x, torch.Generator().manual_seed(1))
             for m, model in models.items()}
        t2 = models["flash"](x, torch.Generator().manual_seed(1))
        t3 = models["flash"](x, torch.Generator().manual_seed(2))
    torch.testing.assert_close(t["flash"], t["dense"], rtol=1e-5, atol=1e-5)
    assert torch.equal(t["flash"], t2)
    assert not torch.equal(t["flash"], t3) and not torch.equal(t["flash"], e1)
    with pytest.raises(ValueError, match="generator"):
        models["flash"](x)
