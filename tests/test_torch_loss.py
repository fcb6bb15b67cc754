"""Port of the denoising loss (toycrystals_torch/models/sde_score_model.py:
draw_diffusion_loss_noise, diffusion_loss_eps_given, diffusion_loss_eps) and
of `shift_t` against the JAX package, in f32 on the CPU.

The loss and every gradient leaf are compared on JAX's own (t, eps) and the
same params. Tolerances: loss rtol 2e-5; gradients atol 1e-5 + rtol 2e-3 per
leaf (f32 convs and reductions in different orders through ~20 layers; the
JAX side runs once per gn_impl, "xla" and "pallas", the latter through the
Pallas kernel in interpret mode and its custom VJP).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.models.flow_matching import shift_t
from toycrystals_torch.utils.params import load_flax_params, torch_state_dict_from_flax
from toycrystals_tpu.models import flow_matching as jfm
from toycrystals_tpu.models import sde_score_model as jm

KW = dict(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16)
B, SIZE = 4, 16


def _batch(seed):
    r = np.random.default_rng(seed)
    x0 = r.uniform(size=(B, SIZE, SIZE, 1)).astype(np.float32)
    y_cat = r.integers(0, 4, size=(B,)).astype(np.int32)
    y_cont = r.normal(size=(B, 4)).astype(np.float32)
    return x0, y_cat, y_cont


def _params(stem, seed=11):
    args = (jnp.zeros((2, SIZE, SIZE, 1)), jnp.zeros((2,)), jnp.zeros((2,), jnp.int32),
            jnp.zeros((2, 4)))
    v = jm.CondUNetTiny(**KW, stem=stem).init(jax.random.key(seed), *args)
    # non-trivial GroupNorm affines and biases, so every leaf has a gradient path
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a) + (0.05 * r.normal(size=a.shape).astype(np.float32)
                                      if p[-1].key in ("scale", "bias") else 0.0),
        v["params"])


def _jax_loss_and_grads(stem, gn_impl, params, sde_kw, batch, t, eps, param, gamma):
    model = jm.CondUNetTiny(**KW, stem=stem, gn_impl=gn_impl)
    apply_fn = lambda p, x_t, tt, yc, yv: model.apply({"params": p}, x_t, tt, yc, yv)
    x0, y_cat, y_cont = (jnp.asarray(a) for a in batch)

    def loss_fn(p):
        return jm.diffusion_loss_eps_given(apply_fn, p, jm.VPSDE(**sde_kw), x0, y_cat, y_cont,
                                           t, eps, param, gamma)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), torch_state_dict_from_flax(grads)


def _torch_loss_and_grads(stem, params, sde_kw, batch, t, eps, param, gamma):
    model = tm.CondUNetTiny(**KW, stem=stem)
    load_flax_params(model, params)
    x0, y_cat, y_cont = (torch.tensor(a) for a in batch)
    loss = tm.diffusion_loss_eps_given(model, tm.VPSDE(**sde_kw), x0, y_cat, y_cont,
                                       torch.from_numpy(np.asarray(t)),
                                       torch.from_numpy(np.asarray(eps)), param, gamma)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), {k: g.numpy() for k, g in zip(names, grads)}


@pytest.mark.parametrize("gn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("stem", ["none", "s2dr"])
@pytest.mark.parametrize("param,gamma", [("eps", 0.0), ("v", 0.0), ("fm", 0.0),
                                         ("eps", 5.0), ("v", 5.0)])
def test_loss_and_every_gradient_leaf_match_jax(param, gamma, stem, gn_impl):
    batch = _batch(1)
    params = _params(stem)
    sde_kw = dict(beta_min=0.1, beta_max=30.0)
    key = jax.random.key(3)
    t, eps, yc, yv = jm.draw_diffusion_loss_noise(
        jnp.asarray(batch[0]), jnp.asarray(batch[1]), jnp.asarray(batch[2]), key, 4, 0.5)
    batch = (batch[0], np.asarray(yc), np.asarray(yv))
    want_loss, want = _jax_loss_and_grads(stem, gn_impl, params, sde_kw, batch, t, eps,
                                          param, gamma)
    got_loss, got = _torch_loss_and_grads(stem, params, sde_kw, batch, t, eps, param, gamma)
    assert np.isfinite(got_loss)
    np.testing.assert_allclose(got_loss, want_loss, rtol=2e-5)
    assert set(got) == set(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-3)
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 + 2e-3 * scale, rtol=0,
                                   err_msg=k)


def test_loss_raises_on_unknown_parameterization_and_min_snr_fm():
    model = tm.CondUNetTiny(**KW)
    x0, y_cat, y_cont = (torch.from_numpy(a) for a in _batch(2))
    t, eps = torch.full((B,), 0.5), torch.zeros_like(x0)
    with pytest.raises(ValueError, match="eps|v|fm"):
        tm.diffusion_loss_eps_given(model, tm.VPSDE(), x0, y_cat, y_cont, t, eps, "x0")
    with pytest.raises(ValueError, match="min-SNR"):
        tm.diffusion_loss_eps_given(model, tm.VPSDE(), x0, y_cat, y_cont, t, eps, "fm", 5.0)


@pytest.mark.parametrize("s", [1.0, 0.5, 4.0])
def test_shift_t_matches_jax(s):
    t = np.linspace(0.0, 1.0, 11).astype(np.float32)
    want = np.asarray(jfm.shift_t(jnp.asarray(t), s))
    got = shift_t(torch.from_numpy(t), s)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
    assert float(got[0]) == 0.0 and abs(float(got[-1]) - 1.0) < 1e-7


@pytest.mark.parametrize("t_power,t_shift", [(1.0, 1.0), (2.0, 1.0), (1.0, 4.0)])
def test_draw_noise_semantics(t_power, t_shift):
    b = 4096
    x0 = torch.zeros(b, 2, 2, 1)
    y_cat = torch.arange(b, dtype=torch.int32) % 4
    y_cont = torch.ones(b, 4)
    g = torch.Generator().manual_seed(0)
    t, eps, yc, yv = tm.draw_diffusion_loss_noise(x0, y_cat, y_cont, g, 4, 0.25, t_power,
                                                  t_shift)
    assert t.shape == (b,) and eps.shape == x0.shape and eps.dtype == x0.dtype
    assert float(t.min()) >= 0.0 and float(t.max()) <= 1.0
    # the same generator state gives u; t = shift(u ** t_power)
    u = torch.rand(b, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(t, shift_t(u ** t_power, t_shift))
    want_mean = {(1.0, 1.0): 0.5, (2.0, 1.0): 1.0 / 3.0}.get((t_power, t_shift))
    if want_mean is not None:
        assert abs(float(t.mean()) - want_mean) < 0.02
    else:
        assert float(t.mean()) > 0.6  # shift > 1 pushes towards the noise side
    assert abs(float(eps.mean())) < 0.03 and abs(float(eps.std()) - 1.0) < 0.03
    drop = yc == 4
    assert abs(float(drop.float().mean()) - 0.25) < 0.03
    assert bool((yv[drop] == 0).all()) and bool((yv[~drop] == 1).all())
    assert bool((yc[~drop] == y_cat[~drop]).all()) and yc.dtype == torch.int32
    # p_uncond = 0 leaves the conditioning alone
    _, _, yc0, yv0 = tm.draw_diffusion_loss_noise(x0, y_cat, y_cont, g, 4, 0.0)
    assert yc0 is y_cat and yv0 is y_cont


def test_diffusion_loss_eps_is_draw_then_given():
    model = tm.CondUNetTiny(**KW)
    x0, y_cat, y_cont = (torch.from_numpy(a) for a in _batch(5))
    sde = tm.VPSDE(0.1, 30.0)
    with torch.no_grad():
        got = tm.diffusion_loss_eps(model, sde, x0, y_cat, y_cont,
                                    torch.Generator().manual_seed(7), 4, 0.5, 2.0, "v")
        t, eps, yc, yv = tm.draw_diffusion_loss_noise(
            x0, y_cat, y_cont, torch.Generator().manual_seed(7), 4, 0.5, 2.0)
        want = tm.diffusion_loss_eps_given(model, sde, x0, yc, yv, t, eps, "v")
    assert got.dtype == torch.float32 and float(got) == float(want)


def test_bf16_model_gives_an_f32_loss():
    model = tm.CondUNetTiny(**KW, stem="s2dr", dtype=torch.bfloat16)
    x0, y_cat, y_cont = (torch.from_numpy(a) for a in _batch(6))
    loss = tm.diffusion_loss_eps(model, tm.VPSDE(0.1, 30.0), x0, y_cat, y_cont,
                                 torch.Generator().manual_seed(1), 4)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)
