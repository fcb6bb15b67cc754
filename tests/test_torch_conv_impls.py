"""The int8 and border circular convs of the port (toycrystals_torch/ops/conv.py)
against the JAX package's `CircularConv(impl="int8" | "border")`, from the
same flax params and numpy inputs, in f32 on the CPU.

Tolerances:
- int8: the quantised tensors and the int32 accumulators equal JAX's exactly
  (integers); the dequantised output y = acc * (sx * sw_c) + bias within 1 ulp
  of JAX's (the same f32 operations; XLA may contract the multiply-add).
- border: 1e-5, f32 rounding of convs summed in another order (as
  tests/test_torch_unet.py holds "pad").
- The int8 U-Net: 2e-4, the float U-Net's tolerance (tests/test_torch_unet.py).
  The f32 GroupNorms of the two packages differ by ~1e-7, which could move an
  activation across a rounding boundary of its int8 grid; a flipped quantum
  changes the next convs' inputs enough to flip more (at full width a 1e-7
  relative change of the input moves the output by up to ~0.1), and would fail
  the bound. At these sizes and seeds none flips (measured 3.6e-7), so the
  bound allows f32 rounding and nothing more; the test also checks that int8
  moved the output away from the float U-Net's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.ops import conv as tc
from toycrystals_torch.utils.params import (
    flax_from_torch_state_dict,
    load_flax_params,
    torch_state_dict_from_flax,
)
from toycrystals_tpu.models import sde_score_model as jm
from toycrystals_tpu.ops.conv import CircularConv as JaxCircularConv

KW = dict(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16)
GEOMETRIES = [(3, 1), (4, 2)]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _conv_pair(k, s, impl, seed=0, cin=5, cout=7):
    """(numpy x NHWC, flax params, JAX module, port module)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, 8, 6, cin)) * 1.5).astype(np.float32)
    jmod = JaxCircularConv(cout, (k, k), strides=(s, s), impl=impl)
    params = jmod.init(jax.random.key(seed), jnp.asarray(x))["params"]
    params = dict(params, bias=np.linspace(-1, 1, cout).astype(np.float32))
    tmod = tc.CircularConv(cin, cout, k, s, impl=impl)
    tmod.load_state_dict({n: torch.tensor(v)
                          for n, v in torch_state_dict_from_flax(params).items()})
    return x, params, jmod, tmod


@pytest.mark.parametrize("k,s", GEOMETRIES)
@pytest.mark.parametrize("impl", ["int8", "border"])
def test_circular_conv_impl_matches_jax(impl, k, s):
    x, params, jmod, tmod = _conv_pair(k, s, impl, seed=k)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    assert got.shape == want.shape
    if impl == "int8":
        ulp = np.spacing(np.abs(want))
        assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("k,s", GEOMETRIES)
def test_int8_quantised_tensors_and_accumulators_equal_jax(k, s):
    """The JAX int8 branch's intermediates (toycrystals_tpu/ops/conv.py:95-112,
    written out here) against quantize_int8, wrap_pad and int8_conv_acc."""
    x, params, _, _ = _conv_pair(k, s, "int8", seed=10 + k)
    kernel = jnp.asarray(params["kernel"])
    xj = jnp.asarray(x)
    sx = jnp.maximum(jnp.max(jnp.abs(xj)).astype(jnp.float32), 1e-12) / 127.0
    sw_c = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)), 1e-12) / 127.0
    xq = jnp.clip(jnp.round(xj.astype(jnp.float32) / sx), -127, 127).astype(jnp.int8)
    wq = jnp.clip(jnp.round(kernel / sw_c), -127, 127).astype(jnp.int8)
    xp = jnp.pad(xq, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="wrap")
    acc = lax.conv_general_dilated(xp, wq, (s, s), "VALID",
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                   preferred_element_type=jnp.int32)

    txq, tsx = tc.quantize_int8(_nchw(x))
    w = torch.from_numpy(np.ascontiguousarray(np.asarray(kernel).transpose(3, 2, 0, 1)))
    twq, tsw = tc.quantize_int8(w, dims=(1, 2, 3))
    assert txq.dtype == twq.dtype == torch.int8
    assert float(tsx) == float(sx)
    np.testing.assert_array_equal(tsw.reshape(-1).numpy(), np.asarray(sw_c))
    np.testing.assert_array_equal(_nhwc(txq), np.asarray(xq))
    np.testing.assert_array_equal(twq.numpy().transpose(2, 3, 1, 0), np.asarray(wq))
    txp = tc.wrap_pad(txq)
    np.testing.assert_array_equal(_nhwc(txp), np.asarray(xp))
    tacc = tc.int8_conv_acc(txp, twq, s)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(_nhwc(tacc), np.asarray(acc))


def test_quantize_rounds_half_to_even_and_clips():
    x = torch.tensor([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, 63.5])
    q, scale = tc.quantize_int8(x)
    assert float(scale) == 1.0
    assert q.tolist() == [127, -127, 0, 2, 2, 0, 64]
    q0, s0 = tc.quantize_int8(torch.zeros(3))
    assert q0.tolist() == [0, 0, 0] and float(s0) == np.float32(1e-12) / np.float32(127.0)


@pytest.mark.parametrize("m,k,n", [(5, 3, 1), (17, 8, 8), (40, 27, 4), (3, 216, 13)])
def test_int_mm_padding_is_exact(m, k, n):
    """Zero padding of M past 16 and of K and N to multiples of 8 around
    torch._int_mm (which the CPU build runs without those limits) gives the
    exact product."""
    g = torch.Generator().manual_seed(m * k * n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    got = tc._int_mm_padded(a, w)
    assert got.shape == (m, n) and got.dtype == torch.int32
    torch.testing.assert_close(got, (a.long() @ w.long()).int(), rtol=0, atol=0)


def test_int8_conv_acc_chunks_by_batch_items(monkeypatch):
    """An im2col budget of one item's patches splits the product into one
    chunk per batch item; the accumulators do not change."""
    g = torch.Generator().manual_seed(3)
    xq = torch.randint(-127, 128, (3, 4, 7, 7), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (5, 4, 3, 3), generator=g, dtype=torch.int8)
    want = tc.int8_conv_acc(xq, wq, 1)
    monkeypatch.setattr(tc, "_IM2COL_BYTES", 25 * 36)
    torch.testing.assert_close(tc.int8_conv_acc(xq, wq, 1), want, rtol=0, atol=0)
    exact = torch.nn.functional.conv2d(xq.double(), wq.double()).int()
    torch.testing.assert_close(want, exact, rtol=0, atol=0)
    with pytest.raises(TypeError, match="int8"):
        tc.int8_conv_acc(xq.float(), wq, 1)


def test_int8_valid_conv_over_halo_equals_int8_circular_conv():
    """The fused block's conv1 (a VALID int8 Conv2d over a wrap-padded input)
    is the int8 CircularConv of the unpadded input, bit for bit."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 6, 5, 7)).astype(np.float32))
    circ = tc.CircularConv(6, 4, 3, 1, impl="int8")
    valid = tc.Conv2d(6, 4, 3, 1, int8=True)
    valid.load_state_dict(circ.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(valid(tc.wrap_pad(x)), circ(x), rtol=0, atol=0)


def test_bad_impl_raises():
    with pytest.raises(ValueError, match="impl"):
        tc.CircularConv(4, 4, impl="int4")


def _unet_inputs(seed, b=2, size=16):
    r = np.random.default_rng(seed)
    x = r.normal(size=(b, size, size, 1)).astype(np.float32)
    t = r.uniform(0.05, 1.0, size=(b,)).astype(np.float32)
    y_cat = np.array([1, 4][:b], np.int32)  # 4 = the CFG null token
    y_cont = r.normal(size=(b, 4)).astype(np.float32)
    return x, t, y_cat, y_cont


@pytest.mark.parametrize("impl", ["int8", "border"])
@pytest.mark.parametrize("stem", ["none", "s2dr"])
def test_unet_conv_impl_matches_jax(stem, impl):
    """The port's U-Net (fused block layout) with conv_impl against JAX's
    CondUNetTiny(conv_impl=...) with gn_impl "xla", the layout the JAX
    service runs int8 in: both convs of every block are int8 there."""
    x, t, y_cat, y_cont = _unet_inputs(10)
    args = tuple(jnp.asarray(a) for a in (x, t, y_cat, y_cont))
    # the port's own init as a flax tree (a JAX init would cost seconds of
    # compile), with non-trivial GroupNorm affines
    torch.manual_seed(11)
    sd = {k: v.numpy() + (0.05 if ".gn" in k else 0.0)
          for k, v in tm.CondUNetTiny(**KW, stem=stem).state_dict().items()}
    params = flax_from_torch_state_dict(sd)
    want = np.asarray(jax.jit(jm.CondUNetTiny(**KW, stem=stem, conv_impl=impl).apply)(
        {"params": params}, *args))
    tmodel = tm.CondUNetTiny(**KW, stem=stem, conv_impl=impl)
    load_flax_params(tmodel, params)
    assert tmodel.down1.conv1.int8 == (impl == "int8") and tmodel.out.impl == impl
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(a) for a in (x, t, y_cat, y_cont))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
    if impl == "int8":
        float_out = np.asarray(jax.jit(jm.CondUNetTiny(**KW, stem=stem).apply)(
            {"params": params}, *args))
        assert np.abs(want - float_out).max() > 1e-2
