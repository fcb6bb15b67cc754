"""Port of the score U-Net and its ops (toycrystals_torch/models, ops) against
the JAX modules, from the same flax params and numpy inputs, in f32 on the
CPU. Tolerances: 1e-5 for single ops, 2e-4 for the whole U-Net (as
tests/test_groupnorm.py holds the two JAX gn_impls to each other).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.ops.attention import SelfAttention2d, gn_groups
from toycrystals_torch.ops.conv import CircularConv
from toycrystals_torch.utils.params import load_flax_params, torch_state_dict_from_flax
from toycrystals_tpu.models import sde_score_model as jm
from toycrystals_tpu.ops.attention import SelfAttention2d as JaxAttention
from toycrystals_tpu.ops.attention import gn_groups as jax_gn_groups
from toycrystals_tpu.ops.conv import CircularConv as JaxCircularConv

KW = dict(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16)


def _rng(seed):
    return np.random.default_rng(seed)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _load(module, params):
    sd = {k: torch.tensor(v) for k, v in torch_state_dict_from_flax(params).items()}
    module.load_state_dict(sd, strict=True)
    return module


def _unet_inputs(seed, b=2, size=16):
    r = _rng(seed)
    x = r.normal(size=(b, size, size, 1)).astype(np.float32)
    t = r.uniform(0.05, 1.0, size=(b,)).astype(np.float32)
    y_cat = np.array([1, 4][:b], np.int32)  # 4 = the CFG null token
    y_cont = r.normal(size=(b, 4)).astype(np.float32)
    return x, t, y_cat, y_cont


def test_gn_groups_matches_jax():
    for ch in (1, 2, 3, 6, 12, 16, 17, 96, 192):
        assert gn_groups(ch) == jax_gn_groups(ch)


def test_self_attention_matches_jax():
    x = _rng(0).normal(size=(2, 4, 4, 16)).astype(np.float32)
    jmod = JaxAttention(num_heads=4, attn_impl="xla")
    v = jmod.init(jax.random.key(0), jnp.asarray(x))
    params = jax.tree.map(
        lambda a: np.asarray(a) + _rng(1).normal(size=a.shape).astype(np.float32) * 0.1,
        v["params"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = _load(SelfAttention2d(16, num_heads=4), params)
    np.testing.assert_allclose(_nhwc(tmod(_nchw(x))), want, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_self_attention_runs_at_2304_tokens_on_the_cpu(impl):
    """48x48 tokens: no refusal on the CPU; xla and auto are the same matmul path."""
    x = torch.from_numpy(_rng(2).normal(size=(1, 8, 48, 48)).astype(np.float32))
    torch.manual_seed(0)
    m = SelfAttention2d(8, num_heads=4, attn_impl=impl)
    ref = SelfAttention2d(8, num_heads=4, attn_impl="xla")
    ref.load_state_dict(m.state_dict())
    with torch.no_grad():
        y = m(x)
        assert y.shape == x.shape and torch.isfinite(y).all()
        assert torch.equal(y, ref(x))


@pytest.mark.parametrize("k,s", [(3, 1), (4, 2)])
def test_circular_conv_matches_jax(k, s):
    x = _rng(k).normal(size=(2, 8, 6, 5)).astype(np.float32)
    jmod = JaxCircularConv(7, (k, k), strides=(s, s))
    params = jmod.init(jax.random.key(k), jnp.asarray(x))["params"]
    params = dict(params, bias=np.linspace(-1, 1, 7).astype(np.float32))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = _load(CircularConv(5, 7, k, s), params)
    np.testing.assert_allclose(_nhwc(tmod(_nchw(x))), want, atol=1e-5)


@pytest.mark.parametrize("impl", ["int8", "border"])
def test_circular_conv_other_impls_raise(impl):
    """The other impls take the pad-1 geometries only, as "pad" does (their
    parity with JAX: tests/test_torch_conv_impls.py)."""
    with pytest.raises(ValueError, match="pad-1"):
        CircularConv(4, 4, kernel_size=5, stride=1, impl=impl)
    assert CircularConv(4, 4, 4, 2, impl=impl).impl == impl


@pytest.mark.parametrize("dim", [16, 17])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0.0, 0.3, 0.999], np.float32)
    want = np.asarray(jm.timestep_embedding_continuous(jnp.asarray(t), dim))
    got = tm.timestep_embedding_continuous(torch.from_numpy(t), dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_condition_embedding_matches_jax():
    y_cat = np.array([0, 3, 4, 9, -2], np.int32)  # out-of-range ids clip, 4 = null token
    y_cont = _rng(2).normal(size=(5, 4)).astype(np.float32)
    jmod = jm.ConditionEmbedding(4, 4, 16)
    params = jmod.init(jax.random.key(1), jnp.asarray(y_cat), jnp.asarray(y_cont))["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(y_cat), jnp.asarray(y_cont)))
    tmod = _load(tm.ConditionEmbedding(4, 4, 16), params)
    got = tmod(torch.from_numpy(y_cat), torch.from_numpy(y_cont))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


def test_space_depth_folds_match_jax():
    x = _rng(3).normal(size=(2, 6, 4, 17)).astype(np.float32)
    s2d = tm._space_to_depth2(_nchw(x))
    np.testing.assert_array_equal(_nhwc(s2d), np.asarray(jm._space_to_depth2(jnp.asarray(x))))
    np.testing.assert_array_equal(_nhwc(tm._depth_to_space2(s2d)), x)
    y = x[..., :16]
    np.testing.assert_array_equal(_nhwc(tm._depth_to_space2(_nchw(y))),
                                  np.asarray(jm._depth_to_space2(jnp.asarray(y))))


def test_bilinear_up2_matches_jax():
    x = _rng(4).normal(size=(2, 4, 6, 3)).astype(np.float32)
    want = np.asarray(jm._bilinear_up2(jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(tm._bilinear_up2(_nchw(x))), want, atol=1e-5)


@pytest.mark.parametrize("gn_impl", ["pallas", "xla"])
@pytest.mark.parametrize("stem", ["none", "s2d", "s2dr"])
def test_unet_matches_jax(stem, gn_impl):
    x, t, y_cat, y_cont = _unet_inputs(10)
    jmodel = jm.CondUNetTiny(**KW, stem=stem, gn_impl=gn_impl)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(y_cat), jnp.asarray(y_cont))
    # both gn_impls share one param tree; init through xla keeps the test fast
    v = jm.CondUNetTiny(**KW, stem=stem).init(jax.random.key(11), *args)
    # non-trivial GroupNorm affines, so the scale/bias mapping is exercised
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a) + (0.05 if p[-1].key in ("scale", "bias") else 0.0),
        v["params"])
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, *args))
    tmodel = tm.CondUNetTiny(**KW, stem=stem)
    load_flax_params(tmodel, params)
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(a) for a in (x, t, y_cat, y_cont)))
    assert got.shape == (2, 16, 16, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_unet_matches_jax_at_2304_bottleneck_tokens():
    """Stem none at 192x192: the bottleneck is 48x48 = 2,304 tokens, above the
    2,048 where auto would pick the flash kernel on an accelerator. On the CPU
    both sides run their matmul path; 2e-4 as for the 16x16 U-Net."""
    x, t, y_cat, y_cont = _unet_inputs(13, b=1, size=192)
    jmodel = jm.CondUNetTiny(**KW, stem="none")
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(y_cat), jnp.asarray(y_cont))
    small = tuple(jnp.asarray(a) for a in _unet_inputs(13, b=1, size=16))
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(12), *small)["params"])
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, *args))
    tmodel = tm.CondUNetTiny(**KW, stem="none")
    load_flax_params(tmodel, params)
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(a) for a in (x, t, y_cat, y_cont)))
    assert got.shape == (1, 192, 192, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_unet_bf16_forward_runs_and_returns_f32():
    x, t, y_cat, y_cont = _unet_inputs(12)
    model = tm.CondUNetTiny(**KW, stem="s2dr", dtype=torch.bfloat16)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (x, t, y_cat, y_cont)))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()


def test_flax_groupnorm_is_the_attention_norm():
    """The attention norm is flax GroupNorm (eps 1e-6, no SiLU)."""
    x = _rng(5).normal(size=(2, 3, 3, 8)).astype(np.float32) * 3.0
    gn = nn.GroupNorm(num_groups=4)
    v = gn.init(jax.random.key(2), jnp.asarray(x))
    want = np.asarray(gn.apply(v, jnp.asarray(x)))
    from toycrystals_torch.ops.attention import GroupNorm

    got = _load(GroupNorm(8, 4), v["params"])(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5)
