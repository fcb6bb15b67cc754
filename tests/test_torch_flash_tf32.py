"""The arithmetic of the f32 flash kernels (toycrystals_torch/csrc/flash_attn.cu,
fwd_tf32 / dkv_tf32 / dq_tf32), emulated on the CPU.

The kernels run f32 attention on TF32 tensor cores: every operand x is split
into hi = tf32(x) and lo = tf32(x - hi), rounded to nearest with ties away
from zero as `cvt.rna.tf32.f32` rounds (10 mantissa bits), and every product
is formed as lo hi + hi lo + hi hi in f32, lo lo dropped. The softmax, its
running max and sum, L and delta stay f32, with scale * log2(e) folded into
exp2. This file emulates that arithmetic in torch, bit for bit in the
rounding, and holds it to the tolerance that the kernels meet on the card
(2e-5 of the largest entry, `chip_smoke.py`'s FLASH_TOL["float32"]): against
the JAX package's `_flash_sdpa` (its Pallas kernel interpreted on the CPU)
and against float64. One TF32 product instead of three misses that
tolerance, so a kernel that drops the split cannot pass for f32.
"""

import math

import flax.linen as nn  # noqa: F401  (flax registers its pytrees before the JAX module loads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from toycrystals_tpu.ops import attention as jat

SHARE = 2e-5  # of the largest entry: chip_smoke.py FLASH_TOL["float32"]
LOG2E = 1.4426950408889634


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as cvt.rna.tf32.f32 does: add half of the 13
    dropped mantissa bits to the magnitude, then clear them (sign-magnitude,
    so ties round away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in f32 from three TF32 products, the small terms first."""
    ahi, alo = split(a)
    bhi, blo = split(b)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from one TF32 product."""
    return tf32_rna(a) @ tf32_rna(b)


def emulated_forward(q, k, v, mm):
    """The kernels' forward on [B, N, heads, d] f32: S = Q K^T, exp2 of
    S scale log2(e) less the row max, O = P V / l, L = m ln 2 + log l."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    sl2 = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=torch.float32) * LOG2E
    s = mm(qh, kh.transpose(-1, -2))
    m = s.amax(-1, keepdim=True) * sl2
    p = torch.exp2(s * sl2 - m)
    l = p.sum(-1, keepdim=True)
    o = mm(p, vh) / l
    return o.transpose(1, 2), (m / LOG2E + torch.log(l)).squeeze(-1)


def emulated_backward(q, k, v, o, lse, do, mm):
    """The kernels' backward: delta = rowsum(dO O), P from S and L,
    dS = P (dP - delta), dQ = dS K scale, dK = dS^T Q scale, dV = P^T dO."""
    qh, kh, vh, oh, doh = (t.transpose(1, 2) for t in (q, k, v, o, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    delta = (doh * oh).sum(-1, keepdim=True)
    p = torch.exp2(mm(qh, kh.transpose(-1, -2)) * sl2 - lse.unsqueeze(-1) * LOG2E)
    ds = p * (mm(doh, vh.transpose(-1, -2)) - delta)
    dq = mm(ds, kh) * scale
    dk = mm(ds.transpose(-1, -2), qh) * scale
    dv = mm(p.transpose(-1, -2), doh)
    return tuple(t.transpose(1, 2) for t in (dq, dk, dv))


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for _ in range(4)]


def _share(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest error as a share of the reference's largest entry."""
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max())


def _f64_attention(q, k, v):
    qd, kd, vd = (t.double().requires_grad_(True) for t in (q, k, v))
    logits = torch.einsum("bnhd,bmhd->bhnm", qd, kd) / math.sqrt(q.shape[-1])
    out = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, dim=-1), vd)
    return out, (qd, kd, vd)


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),     # a tie rounds away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),                  # under half a TF32 ulp: down
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),  # over half: up
    (3.0 * 2.0 ** -130, 3.0 * 2.0 ** -130),   # a subnormal keeps its top bits
])
def test_tf32_rounding_is_cvt_rna(x, want):
    assert float(tf32_rna(torch.tensor([x], dtype=torch.float32))[0]) == want


def test_split_keeps_f32_to_two_to_the_minus_22():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -22


def test_three_products_match_the_pallas_kernel_and_float64():
    """The forward at [2, 256, 2, 48] (N <= 256: the Pallas kernel is
    interpreted grid step by grid step) within 2e-5 of the largest entry of
    JAX's `_flash_sdpa` and of float64 attention; L within 2e-5 too."""
    q, k, v, _ = _inputs((2, 256, 2, 48), seed=17)
    got, lse = emulated_forward(q, k, v, mm3)
    with pltpu.force_tpu_interpret_mode():
        jax_out = np.array(jat._flash_sdpa(*(jnp.asarray(t.numpy()) for t in (q, k, v))))
    want, (qd, kd, _) = _f64_attention(q, k, v)
    assert _share(got, torch.from_numpy(jax_out)) <= SHARE
    assert _share(got, want) <= SHARE
    logits = torch.einsum("bnhd,bmhd->bhnm", qd, kd).detach() / math.sqrt(48)
    assert float((lse.double() - torch.logsumexp(logits, dim=-1)).abs().max()) <= 2e-5


@pytest.mark.parametrize("shape", [(2, 256, 2, 48), (1, 512, 2, 128)])
def test_one_tf32_product_misses_the_f32_tolerance(shape):
    """Dropping the split costs about 30x the tolerance (10 mantissa bits
    against f32's 23); the three products stay well inside it."""
    q, k, v, _ = _inputs(shape, seed=23)
    want, _ = _f64_attention(q, k, v)
    assert _share(emulated_forward(q, k, v, mm1)[0], want) > 5 * SHARE
    assert _share(emulated_forward(q, k, v, mm3)[0], want) <= SHARE / 5


@pytest.mark.parametrize("shape", [(2, 256, 2, 48), (1, 256, 2, 16), (1, 128, 1, 128)])
def test_three_product_gradients_match_float64(shape):
    """dq, dk and dv from the kernels' backward arithmetic (the forward's L,
    delta from the f32 output) within 2e-5 of each gradient's largest entry."""
    q, k, v, do = _inputs(shape, seed=shape[-1])
    o, lse = emulated_forward(q, k, v, mm3)
    got = emulated_backward(q, k, v, o, lse, do, mm3)
    out, leaves = _f64_attention(q, k, v)
    want = torch.autograd.grad(out, leaves, do.double())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _share(g, w) <= SHARE, name
