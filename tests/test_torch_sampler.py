"""Port of the VP-SDE, CFG and samplers (toycrystals_torch/models/sde_score_model.py)
against the JAX samplers, with JAX's own random draws injected into the port.

Both sides run the same small U-Net (base_ch 8, emb_dim 16, 16x16, batch 2)
from the same flax params in f32 on the CPU. Tolerance 2e-4 on the [0, 1]
images: the U-Net alone agrees to 2e-4 (tests/test_torch_unet.py) and the
few steps here add f32 rounding of the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.utils.params import load_flax_params
from toycrystals_tpu.models import sde_score_model as jm

KW = dict(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16)
SHAPE = (2, 16, 16, 1)
ATOL = 2e-4


@pytest.fixture(scope="module")
def models():
    jmodel = jm.CondUNetTiny(**KW)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros(SHAPE), jnp.zeros((2,)),
                                  jnp.zeros((2,), jnp.int32), jnp.zeros((2, 4)))["params"]
    params = jax.tree.map(np.asarray, params)
    tmodel = tm.CondUNetTiny(**KW)
    load_flax_params(tmodel, params)
    tmodel.requires_grad_(False)

    @jax.jit
    def japply(prm, xt, t, yc, yv):
        return jmodel.apply({"params": prm}, xt, t, yc, yv)

    return japply, params, tmodel


def _conds():
    y_cat, y_cont = jm.sample_grid_conditions(2, 4, 4)
    return (y_cat, y_cont), (torch.from_numpy(np.array(y_cat)),
                             torch.from_numpy(np.array(y_cont)))


@pytest.mark.parametrize("shift", [0.0, -1.3])
def test_vpsde_matches_jax(shift):
    t = np.linspace(0.0, 1.0, 11, dtype=np.float32)
    js, ts = jm.VPSDE(0.1, 30.0, shift), tm.VPSDE(0.1, 30.0, shift)
    for name in ("beta", "alpha", "sigma", "int_beta"):
        want = np.asarray(getattr(js, name)(jnp.asarray(t)))
        got = getattr(ts, name)(torch.from_numpy(t)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)


def test_grids_and_conditions_match_jax():
    np.testing.assert_allclose(tm._quadratic_grid(300, 0.005).numpy(),
                               np.asarray(jm._quadratic_grid(300, 0.005)), atol=1e-6)
    (jc, jv), (tc, tv) = _conds()
    yc, yv = tm.sample_grid_conditions(2, 4, 4)
    np.testing.assert_array_equal(yc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(yv.numpy(), np.asarray(jv), atol=1e-7)
    with pytest.raises(ValueError):
        tm._check_t_end(1.0)


@pytest.mark.parametrize("cfg", [0.0, 1.5])
def test_predict_eps_cfg_matches_jax(models, cfg):
    japply, params, tmodel = models
    rng = np.random.default_rng(1)
    x = rng.normal(size=SHAPE).astype(np.float32)
    t = np.array([0.2, 0.9], np.float32)
    (jc, jv), (tc, tv) = _conds()
    want = np.asarray(jm.predict_eps_cfg(japply, params, jnp.asarray(x), jnp.asarray(t),
                                         jc, jv, cfg, 4))
    got = tm.predict_eps_cfg(tmodel, torch.from_numpy(x), torch.from_numpy(t), tc, tv, cfg, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_predict_eps_cfg_batch_order_and_passes():
    seen = []

    def fake(x, t, yc, yv):
        seen.append((yc.clone(), yv.clone()))
        return yc.float().reshape(-1, 1, 1, 1).expand(-1, 2, 2, 1)

    x = torch.zeros(2, 2, 2, 1)
    yc, yv = torch.tensor([1, 2]), torch.ones(2, 4)
    out = tm.predict_eps_cfg(fake, x, torch.ones(2), yc, yv, 1.5, 4)
    (ycat2, ycont2), = seen  # one doubled forward, [uncond; cond]
    assert ycat2.tolist() == [4, 4, 1, 2]
    assert ycont2[:2].abs().sum() == 0 and (ycont2[2:] == 1).all()
    torch.testing.assert_close(out[:, 0, 0, 0], 4 + 1.5 * (yc.float() - 4))
    seen.clear()
    tm.predict_eps_cfg(fake, x, torch.ones(2), yc, yv, 0.0, 4)
    assert len(seen) == 1 and seen[0][0].tolist() == [1, 2]


def test_eps_apply_from_v_matches_jax(models):
    japply, params, tmodel = models
    rng = np.random.default_rng(2)
    x = rng.normal(size=SHAPE).astype(np.float32)
    t = np.array([0.3, 0.6], np.float32)
    (jc, jv), (tc, tv) = _conds()
    js, ts = jm.VPSDE(0.1, 30.0), tm.VPSDE(0.1, 30.0)
    want = np.asarray(jm.eps_apply_from_v(js, japply)(params, jnp.asarray(x),
                                                     jnp.asarray(t), jc, jv))
    got = tm.eps_apply_from_v(ts, tmodel)(torch.from_numpy(x), torch.from_numpy(t), tc, tv)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_sde_sampler_matches_jax_on_injected_draws(models):
    japply, params, tmodel = models
    (jc, jv), (tc, tv) = _conds()
    key, n = jax.random.key(3), 4
    js, ts = jm.VPSDE(0.1, 30.0), tm.VPSDE(0.1, 30.0)
    want = np.asarray(jm.sample_reverse_sde_euler_maruyama(
        japply, params, js, jc, jv, SHAPE, key, n, 1.5, 0.005, 4))
    k_init, k_noise = jax.random.split(key)
    x0 = np.asarray(jax.random.normal(k_init, SHAPE, jnp.float32))
    z = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k_noise, i), SHAPE,
                                               jnp.float32)) for i in range(n)])
    got = tm.sample_reverse_sde_euler_maruyama(
        tmodel, ts, tc, tv, SHAPE, n_steps=n, guidance_scale=1.5, t_end=0.005,
        n_types=4, noise=(x0, z))
    assert got.shape == SHAPE
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("clip_x0", [False, True])
def test_ode_sampler_matches_jax_on_injected_draws(models, clip_x0):
    japply, params, tmodel = models
    (jc, jv), (tc, tv) = _conds()
    key = jax.random.key(4)
    js, ts = jm.VPSDE(0.1, 30.0), tm.VPSDE(0.1, 30.0)
    want = np.asarray(jm.sample_probability_flow_ode(
        japply, params, js, jc, jv, SHAPE, key, 3, 1.5, 0.005, 4, clip_x0))
    x0 = np.asarray(jax.random.normal(key, SHAPE, jnp.float32))
    got = tm.sample_probability_flow_ode(
        tmodel, ts, tc, tv, SHAPE, n_steps=3, guidance_scale=1.5, t_end=0.005,
        n_types=4, clip_x0=clip_x0, noise=x0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_ddim_sampler_matches_jax_on_injected_draws(models, prediction):
    japply, params, tmodel = models
    (jc, jv), (tc, tv) = _conds()
    key = jax.random.key(5)
    js, ts = jm.VPSDE(0.1, 30.0), tm.VPSDE(0.1, 30.0)
    want = np.asarray(jm.sample_ddim(japply, params, js, jc, jv, SHAPE, key, 2, 1.5,
                                     0.005, 4, False, None, prediction))
    x0 = np.asarray(jax.random.normal(key, SHAPE, jnp.float32))
    got = tm.sample_ddim(tmodel, ts, tc, tv, SHAPE, n_steps=2, guidance_scale=1.5,
                         t_end=0.005, n_types=4, prediction=prediction, noise=x0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_sampler_generator_draws_are_reproducible(models):
    _, _, tmodel = models
    _, (tc, tv) = _conds()
    ts = tm.VPSDE(0.1, 30.0)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tm.sample_reverse_sde_euler_maruyama(tmodel, ts, tc, tv, SHAPE, g,
                                                    n_steps=2, guidance_scale=1.5)

    a, b, c = run(7), run(7), run(8)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert a.min() >= 0 and a.max() <= 1
    with pytest.raises(ValueError, match="injected z"):
        tm.sample_reverse_sde_euler_maruyama(
            tmodel, ts, tc, tv, SHAPE, n_steps=2,
            noise=(np.zeros(SHAPE, np.float32), np.zeros((3, *SHAPE), np.float32)))
