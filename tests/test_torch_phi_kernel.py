"""The phi+ kernels (csrc/phi_positive.cu) on the CPU: their dispatch rule,
their product scheme and their backward's rounding points, emulated.

- `phi_positive` takes the kernels only where `phi_kernel_takes` holds (CUDA
  or an export, bf16 x with D <= 64 and D % 8 == 0, fp32 Omega [H, D, F]
  without a gradient, even F <= 272); on the CPU it stays bitwise the plain
  chain, an export on the CPU holds the op, and the kernel path's autograd
  Function, run on CPU tensors, is bitwise the plain chain's autograd.
- Products: x is bf16, Omega is split into three bf16 planes (hi, mid, lo,
  summing to Omega exactly), and u = x Omega is the three plane products
  accumulated on the tensor cores in blocks of 16 (the mma's k), the small
  planes first; the backward's dz Omega^T splits dz too and takes six plane
  products a 16-feature step, summed from zero and added to the running sum
  once a step. This module writes that blocking out in PyTorch (each block
  product exact, as bf16 x bf16 products are, then rounded to fp32 with the
  sum it joins) and holds its error against an fp64 product to
  chip_smoke.PHI_PRODUCT_RATIO times a plain fp32 `torch.matmul`'s.
- The backward's rounding points (bf16(-sum dz) / 2, bf16(dsq x) twice,
  bf16(dz Omega^T), their bf16 sum) against the plain chain's autograd, to
  chip_smoke.PHI_DX_TOL: the two differ only in fp32 summation order, which
  can move a bf16 rounding of the chain by one step. The emulation takes
  exp as torch.exp; the kernels' exp on the special-function unit is within
  about 2^-21 of it, far inside that step.

Inputs come from numpy.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import PHI_DX_TOL, PHI_PRODUCT_RATIO, _bf16_steps, _max_rel
from efficient_rpe_vit_torch.models import attention
from efficient_rpe_vit_torch.ops import feature_maps
from efficient_rpe_vit_torch.ops.feature_maps import (
    orthogonal_gaussian_features,
    phi_kernel_takes,
    phi_positive,
    phi_positive_plain,
)
from efficient_rpe_vit_torch.ops.kernels import phi_positive as pk

torch.set_num_threads(2)

# (B, H, N, D, F): ViT-B/16's head (D, F) = (64, 266) and the narrow (16, 44)
SHAPES = [(2, 3, 33, 64, 266), (3, 2, 17, 16, 44)]


def _inputs(B, H, N, D, F, seed=0):
    """x as the flagship hands phi its q and k (L2-normalised rows, bf16),
    orthogonal Omega [H, D, F] and a bf16 cotangent."""
    rng = np.random.default_rng(seed + B * 1000 + F)
    x = rng.normal(size=(B, H, N, D))
    x = torch.from_numpy(x / np.linalg.norm(x, axis=-1, keepdims=True)).to(torch.bfloat16)
    omega = orthogonal_gaussian_features(torch.Generator().manual_seed(seed), H, D, F)
    g = torch.from_numpy(rng.normal(size=(B, H, N, F)) * 0.1).to(torch.bfloat16)
    return x, omega, g


def _old_phi_positive(x, omega):
    """phi_positive as it read before the kernels: the reference the CPU
    path must still equal bit for bit."""
    m = omega.shape[-1]
    proj = torch.matmul(x.float(), omega.float())
    proj_max = proj.amax(dim=-1, keepdim=True).detach()
    x_norm_sq_half = (x * x).sum(dim=-1, keepdim=True) / 2.0
    phi = torch.exp(proj - proj_max - x_norm_sq_half) / math.sqrt(m)
    return phi.to(x.dtype)


# ─── (a) the rule ───────────────────────────────────────────────────────

# (D, F, x dtype, Omega dtype, Omega needs a gradient, expected)
RULE_CASES = [
    (64, 266, torch.bfloat16, torch.float32, False, True),   # the flagship
    (16, 44, torch.bfloat16, torch.float32, False, True),    # the JAX tests' widths
    (8, 2, torch.bfloat16, torch.float32, False, True),      # the smallest taken
    (64, 272, torch.bfloat16, torch.float32, False, True),   # the widest taken
    (24, 128, torch.bfloat16, torch.float32, False, True),   # D not a multiple of 16
    (64, 266, torch.float32, torch.float32, False, False),   # fp32 compute
    (64, 266, torch.bfloat16, torch.bfloat16, False, False),  # Omega not fp32
    (64, 266, torch.bfloat16, torch.float32, True, False),   # dOmega asked for
    (64, 267, torch.bfloat16, torch.float32, False, False),  # odd F
    (64, 274, torch.bfloat16, torch.float32, False, False),  # wide F
    (80, 266, torch.bfloat16, torch.float32, False, False),  # wide D
    (20, 266, torch.bfloat16, torch.float32, False, False),  # D % 8 != 0
]


@pytest.mark.parametrize("D,F,x_dtype,om_dtype,om_grad,want", RULE_CASES)
def test_rule_takes_the_kernels_by_shape_and_dtype(D, F, x_dtype, om_dtype, om_grad, want):
    """The shape and dtype part of the rule, and the device part: CPU
    tensors never take the kernels."""
    x = torch.zeros(2, 3, 5, D, dtype=x_dtype)
    omega = torch.zeros(3, D, F, dtype=om_dtype, requires_grad=om_grad)
    assert phi_kernel_takes(x, omega, device_rule=False) is want
    assert phi_kernel_takes(x, omega) is False


@pytest.mark.parametrize("x_shape,om_shape", [((2, 3, 5, 64), (4, 64, 266)),
                                              ((2, 3, 5, 64), (3, 32, 266)),
                                              ((3, 5, 64), (3, 64, 266)),
                                              ((2, 3, 0, 64), (3, 64, 266))])
def test_rule_refuses_shapes_that_do_not_pair(x_shape, om_shape):
    """Heads or head dims that do not match, an x that is not [B, H, N, D],
    an empty sequence: the plain chain (which broadcasts or refuses)."""
    x = torch.zeros(x_shape, dtype=torch.bfloat16)
    assert not phi_kernel_takes(x, torch.zeros(om_shape), device_rule=False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cpu_phi_positive_is_bitwise_the_plain_chain(shape, dtype):
    """On the CPU phi_positive is the chain it always was, forward and
    gradient, bit for bit, and launches nothing."""
    x, omega, g = _inputs(*shape)
    x = x.to(dtype)
    before = (pk.phi_positive_fwd.launches, pk.phi_positive_bwd.launches)
    xa, xb = (x.clone().requires_grad_(True) for _ in range(2))
    got, want = phi_positive(xa, omega), _old_phi_positive(xb, omega)
    assert torch.equal(got, want)
    got.backward(g.to(dtype))
    want.backward(g.to(dtype))
    assert torch.equal(xa.grad, xb.grad)
    assert (pk.phi_positive_fwd.launches, pk.phi_positive_bwd.launches) == before


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_path_wiring_on_cpu_tensors(monkeypatch, shape):
    """With the rule's device part off, phi_positive takes the kernel path's
    autograd Function; on CPU tensors its ops run the plain forward and the
    plain chain's backward written out, so values and gradients are the
    plain chain's autograd's bit for bit, through the custom op nodes."""
    monkeypatch.setattr(feature_maps, "phi_kernel_takes",
                        lambda x, om: phi_kernel_takes(x, om, device_rule=False))
    x, omega, g = _inputs(*shape)
    xa, xb = (x.clone().requires_grad_(True) for _ in range(2))
    got = phi_positive(xa, omega)
    assert type(got.grad_fn).__name__ == "_PhiPositiveBackward"
    want = phi_positive_plain(xb, omega)
    assert torch.equal(got, want) and got.is_contiguous()
    got.backward(g)
    want.backward(g)
    assert torch.equal(xa.grad, xb.grad)


def test_cpu_export_holds_the_op_and_runs_the_plain_chain():
    """Exported on the CPU, phi is the op `phi_positive_fwd` (so the
    artifact launches the kernel once moved to the card), and the artifact
    on the CPU gives the plain chain's features bit for bit."""

    class Phi(torch.nn.Module):
        def __init__(self, omega):
            super().__init__()
            self.register_buffer("omega", omega)

        def forward(self, x):
            return phi_positive(x, self.omega)

    x, omega, _ = _inputs(*SHAPES[1])
    exported = torch.export.export(Phi(omega), (x,), strict=False)
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets.count("efficient_rpe_vit.phi_positive_fwd.default") == 1
    assert torch.equal(exported.module()(x), phi_positive_plain(x, omega))


def test_attention_keeps_no_checkpoint_on_the_kernel_path(monkeypatch):
    """`_KernelAttention` checkpoints phi past PHI_CHECKPOINT_BYTES on the
    plain chain only: on the kernel path the backward recomputes the
    projection itself. Either way the block's output and gradients are the
    same."""
    from efficient_rpe_vit_torch.models.rpe import KerpleRPE

    monkeypatch.setattr(attention, "PHI_CHECKPOINT_BYTES", 0)
    calls = []
    real = attention.checkpoint
    monkeypatch.setattr(attention, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    torch.manual_seed(0)
    block = attention.FavorPlusAttention(64, 2, num_features=44,
                                         compute_dtype=torch.bfloat16)
    block.omega.copy_(orthogonal_gaussian_features(torch.Generator().manual_seed(1), 2, 32, 44))
    rpe = KerpleRPE(17, 64, 2)
    torch.nn.init.normal_(rpe.rel_pos_bias, std=0.02)
    x = torch.randn(2, 17, 64)
    results = []
    for kernel in (False, True):
        monkeypatch.setattr(feature_maps, "phi_kernel_takes",
                            lambda q, om, k=kernel: k and phi_kernel_takes(q, om, False))
        block.zero_grad()
        xi = x.clone().requires_grad_(True)
        out = block(xi, rpe=rpe)
        out.float().sum().backward()
        results.append((out, xi.grad, block.qkv.weight.grad.clone(), len(calls)))
    (out_p, gx_p, gw_p, n_p), (out_k, gx_k, gw_k, n_k) = results
    assert n_p == 1 and n_k == 1  # the plain chain checkpointed; the kernel path did not
    assert torch.equal(out_p, out_k) and torch.equal(gx_p, gx_k) and torch.equal(gw_p, gw_k)


# ─── (b) the products, emulated ─────────────────────────────────────────

def _planes(t: torch.Tensor, count: int = 3):
    """t as `count` bf16 planes (fp32 tensors) summing to it: hi = bf16(t),
    mid = bf16(t - hi), lo = bf16(t - hi - mid); count 1 is t rounded."""
    parts, rest = [], t.float()
    for _ in range(count):
        part = rest.to(torch.bfloat16).float()
        parts.append(part)
        rest = rest - part
    return parts


def _block(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """One mma: acc + a b over a 16-deep block, the products exact (bf16
    values), the sum rounded to fp32 once."""
    return (acc.double() + a.double() @ b.double()).float()


def emulate_u(x: torch.Tensor, omega: torch.Tensor, planes: int = 3) -> torch.Tensor:
    """u = x Omega as phi_pos_fwd_mma_kernel forms it: for each plane of
    Omega (lo, mid, hi), each 16-step of D accumulated into the fp32 sum."""
    D = x.shape[-1]
    xf = x.float()
    acc = torch.zeros(*x.shape[:-1], omega.shape[-1])
    for plane in reversed(_planes(omega, planes)):
        for k0 in range(0, D, 16):
            acc = _block(xf[..., k0:k0 + 16], plane[:, k0:k0 + 16, :].unsqueeze(0), acc)
    return acc


def emulate_dz_omega_t(dz: torch.Tensor, omega: torch.Tensor, planes: int = 3) -> torch.Tensor:
    """dz Omega^T as phi_pos_bwd_mma_kernel forms it: per 16-feature step,
    the six plane products (dz_lo Om_hi, dz_mid Om_mid, dz_hi Om_lo, dz_mid
    Om_hi, dz_hi Om_mid, dz_hi Om_hi) summed from zero, then added to the
    fp32 running sum. With one plane: dz and Omega each rounded to bf16."""
    F = dz.shape[-1]
    zs, os = _planes(dz, planes), _planes(omega.transpose(-1, -2), planes)
    if planes == 1:
        pairs = [(0, 0)]
    else:
        pairs = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]
    acc = torch.zeros(*dz.shape[:-1], omega.shape[1])
    for f0 in range(0, F, 16):
        t = torch.zeros_like(acc)
        for i, j in pairs:
            t = _block(zs[i][..., f0:f0 + 16], os[j][:, f0:f0 + 16, :].unsqueeze(0), t)
        acc = acc + t
    return acc


def _dz(x, omega, g, u):
    """dz as both kernels form it from u: (g / sqrt(F)) * exp((u - max) - nh)."""
    nh = (x * x).sum(dim=-1, keepdim=True) / 2.0
    scale = pk.scale_of(omega.shape[-1])
    return (g.float() * scale) * torch.exp(u - u.amax(dim=-1, keepdim=True) - nh)


def _max_err(got, x, b):
    return (got.double() - x.double() @ b.double()).abs().max().item()


@pytest.mark.parametrize("product", ["u", "dz_omega_t"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_products_keep_fp32_accuracy(shape, product):
    """The emulated products against fp64: no more than PHI_PRODUCT_RATIO
    times the error of a plain fp32 torch.matmul (Omega never rounded)."""
    x, omega, g = _inputs(*shape)
    if product == "u":
        got, a, b = emulate_u(x, omega), x.float(), omega.unsqueeze(0)
    else:
        a = _dz(x, omega, g, emulate_u(x, omega))
        b = omega.transpose(-1, -2).unsqueeze(0)
        got = emulate_dz_omega_t(a, omega)
    err, plain = _max_err(got, a, b), _max_err(torch.matmul(a, b), a, b)
    assert err <= PHI_PRODUCT_RATIO * plain, (err, plain)


@pytest.mark.parametrize("product", ["u", "dz_omega_t"])
def test_one_bf16_pass_would_lose_fp32_accuracy(product):
    """Why Omega (and dz) are split: rounded to bf16 once, as the fused-phi
    kernel #3 rounds Omega, the products miss PHI_PRODUCT_RATIO by far."""
    x, omega, g = _inputs(*SHAPES[0])
    if product == "u":
        got, a, b = emulate_u(x, omega, planes=1), x.float(), omega.unsqueeze(0)
    else:
        a = _dz(x, omega, g, emulate_u(x, omega))
        b = omega.transpose(-1, -2).unsqueeze(0)
        got = emulate_dz_omega_t(a, omega, planes=1)
    err, plain = _max_err(got, a, b), _max_err(torch.matmul(a, b), a, b)
    assert err > 100 * PHI_PRODUCT_RATIO * plain, (err, plain)


def test_planes_sum_to_omega_exactly():
    """hi + mid + lo is Omega bit for bit (each remainder is exact in fp32):
    the split rounds nothing away."""
    _, omega, _ = _inputs(*SHAPES[0])
    hi, mid, lo = _planes(omega)
    assert torch.equal((hi.double() + mid.double() + lo.double()).float(), omega)
    assert torch.equal(hi + (mid + lo), omega)


# ─── (c) the forward and backward, emulated ────────────────────────────

def emulate_phi(x, omega):
    """phi as phi_pos_fwd_mma_kernel computes it, from the emulated u."""
    u = emulate_u(x, omega)
    nh = (x * x).sum(dim=-1, keepdim=True) / 2.0
    e = torch.exp((u - u.amax(dim=-1, keepdim=True)) - nh)
    return (e * pk.scale_of(omega.shape[-1])).to(torch.bfloat16)


def emulate_dx(x, omega, g):
    """dx as phi_pos_bwd_mma_kernel computes it: dsq = bf16(-sum dz) / 2,
    dx = bf16(2 bf16(dsq x) + bf16(dz Omega^T))."""
    dz = _dz(x, omega, g, emulate_u(x, omega))
    dsq = (-dz.sum(dim=-1, keepdim=True)).to(torch.bfloat16).float() * 0.5
    norm_term = 2.0 * (dsq * x.float()).to(torch.bfloat16).float()
    proj_term = emulate_dz_omega_t(dz, omega).to(torch.bfloat16).float()
    return (norm_term + proj_term).to(torch.bfloat16)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_emulated_phi_within_one_bf16_step_of_the_plain_chain(shape):
    """The kernel's phi differs from the plain chain's only where the
    projection's summation order moves a bf16 rounding: one step at most."""
    x, omega, _ = _inputs(*shape)
    assert _bf16_steps(emulate_phi(x, omega), phi_positive_plain(x, omega)) <= 1.0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_emulated_backward_against_autograd_of_the_plain_chain(shape):
    """dx from the kernel's rounding points against the plain chain's
    backward (phi_positive_bwd_reference): within PHI_DX_TOL of the largest
    element, since only fp32 summation orders differ."""
    x, omega, g = _inputs(*shape)
    got = emulate_dx(x, omega, g)
    want = pk.phi_positive_bwd_reference(g, x, omega)
    assert got.dtype == want.dtype == torch.bfloat16
    rel = _max_rel(got, want)
    assert rel <= PHI_DX_TOL, rel


def test_forward_op_passes_opcheck():
    """`efficient_rpe_vit::phi_positive_fwd` (CPU: the plain forward, fake:
    the shape) passes torch.library.opcheck, as the port's other ops do."""
    x, omega, _ = _inputs(*SHAPES[1])
    torch.library.opcheck(torch.ops.efficient_rpe_vit.phi_positive_fwd.default, (x, omega))


def test_backward_op_passes_opcheck():
    """`efficient_rpe_vit::phi_positive_bwd` (CPU: the plain chain's
    backward written out, fake: x's shape and strides) passes
    torch.library.opcheck, on a head-split view of x as the model hands it."""
    x, omega, g = _inputs(*SHAPES[1])
    x = x.transpose(1, 2).contiguous().transpose(1, 2)
    torch.library.opcheck(torch.ops.efficient_rpe_vit.phi_positive_bwd.default, (g, x, omega))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_op_is_bitwise_the_plain_chains_autograd(shape):
    """The backward op on CPU tensors (`phi_positive_bwd_reference`: the
    plain chain's backward written out, as autograd does not run inside an
    op) equals autograd of the plain chain bit for bit, at x's strides where
    x's last dim is contiguous and contiguous otherwise."""
    x, omega, g = _inputs(*shape)
    head_split = x.transpose(1, 2).contiguous().transpose(1, 2)
    last_dim_strided = x.transpose(-1, -2).contiguous().transpose(-1, -2)
    for xi, stride in ((x, x.stride()), (head_split, head_split.stride()),
                       (last_dim_strided, x.stride())):
        xd = xi.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(phi_positive_plain(xd, omega), xd, g)
        got = pk.phi_positive_bwd(g, xi, omega)
        assert torch.equal(got, want) and got.stride() == stride


def test_flop_counter_counts_the_ops_as_the_checkpointed_plain_chain(monkeypatch):
    """FlopCounterMode counts the forward op as 2 B H N D F (x Omega) and
    the backward op as 4 B H N D F (its recompute and dz Omega^T), and
    nothing inside them: the 6 B H N D F it counts of the plain chain under
    `models/attention.py`'s checkpoint (forward, recompute, dx), so a
    counted step's FLOPs mean what they meant before the kernels."""
    from torch.utils.checkpoint import checkpoint
    from torch.utils.flop_counter import FlopCounterMode

    monkeypatch.setattr(feature_maps, "phi_kernel_takes",
                        lambda x, om: phi_kernel_takes(x, om, device_rule=False))
    B, H, N, D, F = SHAPES[0]
    x, omega, g = _inputs(B, H, N, D, F)
    unit = 2 * B * H * N * D * F
    xa, xb = (x.clone().requires_grad_(True) for _ in range(2))
    with FlopCounterMode(display=False) as counter:
        phi_positive(xa, omega).backward(g)
    ops = counter.get_flop_counts()["Global"]
    assert ops[torch.ops.efficient_rpe_vit.phi_positive_fwd] == unit
    assert ops[torch.ops.efficient_rpe_vit.phi_positive_bwd] == 2 * unit
    assert counter.get_total_flops() == 3 * unit
    with FlopCounterMode(display=False) as counter:
        checkpoint(phi_positive_plain, xb, omega, use_reentrant=False).backward(g)
    assert counter.get_total_flops() == 3 * unit
