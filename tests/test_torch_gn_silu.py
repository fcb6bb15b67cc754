"""Port of the fused GroupNorm+SiLU(+halo) op (toycrystals_torch/ops/groupnorm.py)
against the JAX op, whose Pallas kernel runs in interpret mode on the CPU.

The port is NCHW and JAX is NHWC: inputs are made once with numpy and each
side gets its own layout. On the CPU the port's wrapper runs its plain
version; the CUDA kernel itself is held against that plain version on the
card by chip_smoke.py. Gradients: the port's (autograd through the plain
version, and the closed-form plain backward `gn_silu_backward_reference` that
the backward kernel computes) against `jax.grad` / `jax.vjp` through the JAX
op, which runs its custom VJP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from toycrystals_torch.ops import groupnorm as tgn
from toycrystals_tpu.ops.groupnorm import gn_silu as jax_gn_silu


def _inputs(seed, b=3, h=8, w=8, c=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32) * 2.0 + 0.5
    scale = (rng.normal(size=(c,)) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, scale, bias


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("groups", [8, 4, 1])
def test_plain_matches_jax_kernel(groups, pad):
    x, scale, bias = _inputs(groups)
    want = np.asarray(jax_gn_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                  groups, 1e-6, pad))
    got = tgn.gn_silu(_nchw(x), torch.from_numpy(scale), torch.from_numpy(bias), groups,
                      pad=pad)
    assert got.shape == ((3, 16, 10, 10) if pad else (3, 16, 8, 8))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-5)


def test_plain_matches_jax_on_odd_shape():
    """C=12 in 4 groups, H != W: the halo wraps each axis by its own size."""
    x, scale, bias = _inputs(7, b=2, h=5, w=9, c=12)
    want = np.asarray(jax_gn_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                  4, 1e-6, True))
    got = tgn.gn_silu(_nchw(x), torch.from_numpy(scale), torch.from_numpy(bias), 4, pad=True)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-5)


def test_plain_matches_torch_group_norm_with_flax_eps():
    x, scale, bias = _inputs(3)
    xt = _nchw(x)
    s, b = torch.from_numpy(scale), torch.from_numpy(bias)
    want = F.silu(F.group_norm(xt.double(), 4, s.double(), b.double(), eps=1e-6)).float()
    got = tgn.gn_silu_reference(xt, s, b, 4)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_module_runs_plain_version_on_cpu_without_counting():
    x, scale, bias = _inputs(4)
    m = tgn.GroupNormSiLU(16, 4, pad=True)
    assert set(m.state_dict()) == {"weight", "bias"}
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
    before = tgn.gn_silu.launches
    y = m(_nchw(x))
    assert tgn.gn_silu.launches == before  # the counter counts kernel launches only
    torch.testing.assert_close(
        y, tgn.gn_silu_reference(_nchw(x), m.weight, m.bias, 4, pad=True))


def test_plain_version_keeps_bf16_and_differentiates():
    x, scale, bias = _inputs(5)
    xt = _nchw(x).to(torch.bfloat16).requires_grad_(True)
    y = tgn.gn_silu(xt, torch.from_numpy(scale), torch.from_numpy(bias), 8, pad=True)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad.float()).all()


@pytest.mark.parametrize("case", ["rank", "dtype", "groups", "scale", "device"])
def test_kernel_wrapper_rejects_bad_input(case):
    x = torch.zeros(2, 8, 4, 4)
    s, b, g = torch.ones(8), torch.zeros(8), 4
    err = ValueError
    if case == "rank":
        x = x[0]
    elif case == "dtype":
        x, err = x.half(), TypeError
    elif case == "groups":
        g = 3
    elif case == "scale":
        s = torch.ones(4)
    with pytest.raises(err):
        tgn._gn_silu_cuda(x, s, b, g, 1e-6, False)


def _torch_grads(x, scale, bias, upstream, groups, pad, fn=None):
    leaves = [_nchw(x).requires_grad_(True), torch.from_numpy(scale).requires_grad_(True),
              torch.from_numpy(bias).requires_grad_(True)]
    y = (fn or tgn.gn_silu)(*leaves, groups, 1e-6, pad)
    gx, gs, gb = torch.autograd.grad((y * _nchw(upstream)).sum(), leaves)
    return gx.numpy().transpose(0, 2, 3, 1), gs.numpy(), gb.numpy()


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("groups,shape", [(8, (3, 8, 8, 16)), (4, (2, 5, 9, 12)),
                                          (1, (2, 4, 4, 6))])
def test_gradients_match_jax_custom_vjp(groups, shape, pad):
    """d/d(x, scale, bias) of sum(gn_silu(...) * upstream) in f32, atol 2e-5
    (sums over H*W*C/G elements in different orders). With pad=True the
    upstream gradient on the halo must fold back onto the opposite edge."""
    b, h, w, c = shape
    x, scale, bias = _inputs(groups + 10 * pad, b=b, h=h, w=w, c=c)
    p = 2 if pad else 0
    upstream = np.random.default_rng(99).normal(size=(b, h + p, w + p, c)).astype(np.float32)

    def f(xj, sj, bj):
        return jnp.sum(jax_gn_silu(xj, sj, bj, groups, 1e-6, pad) * upstream)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                          jnp.asarray(bias))
    got = _torch_grads(x, scale, bias, upstream, groups, pad)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w_), atol=2e-5, rtol=1e-5)


def test_halo_gradient_folds_back_onto_the_opposite_edge():
    """An upstream gradient that is non-zero on the halo only still reaches x:
    the top halo row is a copy of the bottom interior row."""
    x, scale, bias = _inputs(21, b=1, h=6, w=6, c=8)
    upstream = np.zeros((1, 8, 8, 8), np.float32)
    upstream[0, 0, 1:7, :] = 1.0  # the top halo row
    gx, _, _ = _torch_grads(x, scale, bias, upstream, 4, True)
    # with statistics over the whole group every pixel gets a gradient, but
    # the direct term lands on the bottom row: it dominates there
    assert np.abs(gx[0, 5]).mean() > 5 * np.abs(gx[0, :5]).mean()


def test_autograd_function_backward_equals_plain_autograd(monkeypatch):
    """The Function the CUDA path uses, with its kernel calls replaced by the
    plain versions (forward: `gn_silu_reference`, backward: the closed form
    `gn_silu_backward_reference`) so that it runs here: forward values, the
    launch count and every gradient agree with ordinary autograd through the
    plain version, within atol 2e-5 / rtol 1e-5 (the closed form sums in
    another order than autograd)."""
    calls = []

    def fake_kernel(x, scale, bias, groups, eps, pad, stats=None):
        calls.append(torch.is_grad_enabled())
        return tgn.gn_silu_reference(x, scale, bias, groups, eps, pad)

    def fake_backward(x, scale, bias, grad_out, stats, groups, eps, pad):
        calls.append("backward")
        return tgn.gn_silu_backward_reference(x, scale, bias, grad_out, groups, eps, pad)

    monkeypatch.setattr(tgn, "_gn_silu_cuda", fake_kernel)
    monkeypatch.setattr(tgn, "_gn_silu_backward_cuda", fake_backward)
    x, scale, bias = _inputs(22)
    upstream = np.random.default_rng(5).normal(size=(3, 10, 10, 16)).astype(np.float32)
    got = _torch_grads(x, scale, bias, upstream, 8, True,
                       fn=lambda *a: tgn._GnSiluKernel.apply(*a))
    want = _torch_grads(x, scale, bias, upstream, 8, True, fn=tgn.gn_silu_reference)
    assert calls == [False, "backward"]  # forward once, outside the graph; one backward
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, atol=2e-5, rtol=1e-5)
    # only the gradients that are needed are returned
    xt = _nchw(x).requires_grad_(True)
    y = tgn._GnSiluKernel.apply(xt, torch.from_numpy(scale), torch.from_numpy(bias), 8, 1e-6,
                                False)
    (gx,) = torch.autograd.grad(y.sum(), [xt])
    assert gx.shape == xt.shape


def _jax_vjp(x, scale, bias, upstream, groups, pad):
    _, vjp = jax.vjp(lambda *a: jax_gn_silu(*a, groups, 1e-6, pad), jnp.asarray(x),
                     jnp.asarray(scale), jnp.asarray(bias))
    gx, gs, gb = vjp(jnp.asarray(upstream))
    return np.asarray(gx), np.asarray(gs), np.asarray(gb)


def _closed_form(x, scale, bias, upstream, groups, pad):
    gx, gs, gb = tgn.gn_silu_backward_reference(
        _nchw(x), torch.from_numpy(scale), torch.from_numpy(bias), _nchw(upstream), groups,
        1e-6, pad)
    assert gx.dtype == torch.float32 and gs.shape == gb.shape == (x.shape[-1],)
    return gx.numpy().transpose(0, 2, 3, 1), gs.numpy(), gb.numpy()


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("groups,shape", [
    (8, (3, 8, 8, 16)), (4, (2, 5, 9, 12)), (1, (2, 4, 4, 6)),
    (4, (2, 1, 6, 8)), (4, (2, 6, 1, 8)), (4, (2, 2, 5, 8)), (4, (2, 5, 2, 8)),
    (2, (1, 1, 1, 16)), (4, (2, 2, 2, 8)),
])
def test_backward_reference_matches_jax_vjp(groups, shape, pad):
    """The closed-form plain backward against `jax.vjp` through the JAX op (its
    custom VJP differentiates `_ref_full`), f32, atol 2e-5 / rtol 1e-5. H or W
    of 1 and 2 make one padded row or column fold onto the same pixel from
    both sides."""
    b, h, w, c = shape
    x, scale, bias = _inputs(groups + 3 * h + w + 10 * pad, b=b, h=h, w=w, c=c)
    p = 2 if pad else 0
    upstream = np.random.default_rng(7).normal(size=(b, h + p, w + p, c)).astype(np.float32)
    want = _jax_vjp(x, scale, bias, upstream, groups, pad)
    got = _closed_form(x, scale, bias, upstream, groups, pad)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("value", [0.0, 0.5, -1.5])
@pytest.mark.parametrize("pad", [False, True])
def test_backward_reference_on_a_constant_group_matches_jax_vjp(value, pad):
    """Groups whose values are all equal, at values whose mean is exact in f32:
    the variance is 0, xhat is exactly 0, and the gradient is the clipped
    branch's dx = inv * (dxhat - mean(dxhat)) with inv = 1/sqrt(eps), as JAX's
    custom VJP gives. (At a value whose mean rounds, x - mean is one ulp of
    the mean in one framework's summation order and 0 in the other's, and
    inv = 1000 magnifies that beyond any f32 tolerance on either side.)"""
    x, scale, bias = _inputs(31, b=2, h=4, w=6, c=8)
    x[0, :, :, :2] = value  # group 0 of item 0 (channels 0-1 of 4 groups)
    x[1] = value            # every group of item 1
    p = 2 if pad else 0
    upstream = np.random.default_rng(8).normal(size=(2, 4 + p, 6 + p, 8)).astype(np.float32)
    want = _jax_vjp(x, scale, bias, upstream, 4, pad)
    got = _closed_form(x, scale, bias, upstream, 4, pad)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("groups,shape", [(8, (3, 16, 8, 8)), (4, (2, 12, 5, 9)),
                                          (4, (2, 8, 1, 2)), (2, (2, 6, 2, 1))])
def test_backward_reference_matches_autograd_of_plain_version(groups, shape, pad, dtype):
    """The closed form against torch.autograd through `gn_silu_reference` on
    the same leaves. f32: atol 2e-5 / rtol 1e-5. bf16: the autograd path folds
    the halo in bf16 (F.pad's backward runs in the output's type) where the
    closed form folds in f32, so each gradient is held within 8e-3 of its
    largest entry, as chip_smoke.py holds the kernel."""
    rng = np.random.default_rng(sum(shape) + pad)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 2.0 + 0.5).to(dtype)
    c = shape[1]
    scale = torch.from_numpy((rng.normal(size=c) * 0.1 + 1.0).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=c) * 0.1).astype(np.float32))
    p = 2 if pad else 0
    up = torch.from_numpy(rng.normal(size=(shape[0], c, shape[2] + p, shape[3] + p))
                          .astype(np.float32)).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    want = torch.autograd.grad(tgn.gn_silu_reference(*leaves, groups, 1e-6, pad), leaves, up)
    got = tgn.gn_silu_backward_reference(x, scale, bias, up, groups, 1e-6, pad)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and g.shape == w_.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, w_, atol=2e-5, rtol=1e-5)
        else:
            assert float((g.float() - w_.float()).abs().max()) <= \
                8e-3 * float(w_.float().abs().max())
