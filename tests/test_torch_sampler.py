"""Port of the VP-SDE, CFG and samplers (toycrystals_torch/models/sde_score_model.py)
against the JAX samplers, with JAX's own random draws injected into the port.

Both sides run the same small U-Net (base_ch 8, emb_dim 16, 16x16, batch 2)
from the same flax params in f32 on the CPU. Tolerance 2e-4 on the [0, 1]
images: the U-Net alone agrees to 2e-4 (tests/test_torch_unet.py) and the
few steps here add f32 rounding of the same order.
"""

import types

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


@pytest.mark.parametrize("shift", [0.0, -2.77])
@pytest.mark.parametrize("n_steps,t_end", [(50, 0.005), (8, 1e-3)])
def test_dpm_lambda_grid_matches_jax(shift, n_steps, t_end):
    """The uniform-lambda grid inverted over 4,097 points: ts within 1e-6 of
    JAX's (jnp.interp on the reversed dense grid), lambda within 1e-5."""
    js, ts_ = jm.VPSDE(0.1, 30.0, shift), tm.VPSDE(0.1, 30.0, shift)

    def lam(t):
        a, s = js.alpha(t), js.sigma(t)
        return 0.5 * (jnp.log(jnp.clip(a * a, min=1e-20)) - jnp.log(s * s))

    ts_dense = jnp.linspace(t_end, 1.0, 4097)
    lam_dense = lam(ts_dense)
    lam_grid = jnp.linspace(lam(jnp.array(1.0)), lam(jnp.array(t_end)), n_steps + 1)
    want = jnp.interp(lam_grid, lam_dense[::-1], ts_dense[::-1]).at[0].set(1.0).at[-1].set(t_end)
    got_ts, got_lam = tm._uniform_lambda_grid(ts_, n_steps, t_end)
    assert got_ts.shape == (n_steps + 1,) and got_ts.dtype == torch.float32
    np.testing.assert_allclose(got_ts.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got_lam.numpy(), np.asarray(lam_grid), atol=1e-5)


def test_interp_matches_numpy():
    rng = np.random.default_rng(0)
    xp = np.sort(rng.uniform(-3, 3, size=50)).astype(np.float32)
    fp = rng.normal(size=50).astype(np.float32)
    x = np.concatenate([rng.uniform(-4, 4, size=40).astype(np.float32), xp[[0, 7, -1]]])
    got = tm._interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp))
    np.testing.assert_allclose(got.numpy(), np.interp(x, xp, fp), atol=1e-6)


@pytest.mark.parametrize("clip_x0", [False, True])
@pytest.mark.parametrize("param", ["eps", "v"])
def test_dpm_sampler_matches_jax_on_injected_draws(models, param, clip_x0):
    """DPM-Solver++(2M), 5 steps under CFG 1.5 on the 256x256 recipe's shifted
    schedule (logsnr_shift -2.77), eps and v (through eps_apply_from_v)."""
    japply, params, tmodel = models
    (jc, jv), (tc, tv) = _conds()
    key = jax.random.key(6)
    js, ts = jm.VPSDE(0.1, 30.0, -2.77), tm.VPSDE(0.1, 30.0, -2.77)
    japp, tapp = japply, tmodel
    if param == "v":
        japp, tapp = jm.eps_apply_from_v(js, japply), tm.eps_apply_from_v(ts, tmodel)
    want = np.asarray(jm.sample_dpmpp_2m(japp, params, js, jc, jv, SHAPE, key, 5, 1.5,
                                         0.005, 4, clip_x0))
    x0 = np.asarray(jax.random.normal(key, SHAPE, jnp.float32))
    got = tm.sample_dpmpp_2m(tapp, ts, tc, tv, SHAPE, n_steps=5, guidance_scale=1.5,
                             t_end=0.005, n_types=4, clip_x0=clip_x0, noise=x0)
    assert got.shape == SHAPE
    # 1e-4 on [0, 1] images: half the 2e-4 the U-Net alone is held to, over 6 evaluations
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_dpm_step_for_step_against_jax_with_an_analytic_model():
    """With a closed-form eps model the whole trajectory is compared after
    1, 2, 3 and 6 steps, so a wrong multistep coefficient shows at its step."""
    def jmodel(prm, x, t, yc, yv):
        return 0.3 * x + t.reshape(-1, 1, 1, 1)

    def tmodel(x, t, yc, yv):
        return 0.3 * x + t.reshape(-1, 1, 1, 1)

    (jc, jv), (tc, tv) = _conds()
    key = jax.random.key(8)
    x0 = np.asarray(jax.random.normal(key, SHAPE, jnp.float32))
    for n in (1, 2, 3, 6):
        want = np.asarray(jm.sample_dpmpp_2m(jmodel, None, jm.VPSDE(0.1, 30.0), jc, jv, SHAPE,
                                             key, n, 0.0, 0.005, 4))
        got = tm.sample_dpmpp_2m(tmodel, tm.VPSDE(0.1, 30.0), tc, tv, SHAPE, n_steps=n,
                                 t_end=0.005, noise=x0)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, err_msg=f"{n} steps")


@pytest.mark.parametrize("sampler", ["sde", "ode", "dpm", "ddim"])
def test_auto_chunk_matches_jax(sampler):
    for img_size in (16, 64, 96, 128, 224, 256, 512):
        for steps in (1, 4, 50, 300, 1000):
            assert tm.auto_chunk(img_size, steps, sampler) == \
                jm.auto_chunk(img_size, steps, sampler), (img_size, steps)
    assert tm.auto_chunk(256, 300) == 12 and tm.auto_chunk(64, 300) == 192


def test_chunk_seed_is_injective_and_checked():
    seen = {tm.chunk_seed(s, i) for s in (0, 1, 2**31 - 1) for i in (0, 3, 12, 2**32 - 1)}
    assert len(seen) == 12 and max(seen) < 2**63
    for bad in ((-1, 0), (2**31, 0), (0, -1), (0, 2**32)):
        with pytest.raises(ValueError):
            tm.chunk_seed(*bad)


def test_sample_chunked_pads_trims_and_seeds_each_chunk(models):
    """n = 7 in chunks of 3: three calls of exactly 3 rows, the last padded
    with its last condition row and trimmed; each chunk equals a direct call
    with that chunk's generator."""
    _, _, tmodel = models
    ts = tm.VPSDE(0.1, 30.0)
    yc, yv = tm.sample_grid_conditions(7, 4, 4)
    mask = torch.arange(7, dtype=torch.float32)
    calls = []

    def sampler(apply_fn, sde, y_cat, y_cont, shape, gen, *, tag, **kw):
        calls.append((tuple(shape), y_cat.clone(), tag.clone()))
        return tm.sample_ddim(apply_fn, sde, y_cat, y_cont, shape, gen, **kw)

    got = tm.sample_chunked(sampler, tmodel, ts, yc, yv, (7, 16, 16, 1), 11, chunk=3,
                            batch_kw={"tag": mask}, n_steps=2, guidance_scale=1.5)
    assert isinstance(got, np.ndarray) and got.shape == (7, 16, 16, 1)
    assert [c[0] for c in calls] == [(3, 16, 16, 1)] * 3
    assert calls[2][1].tolist() == [yc[6].item()] * 3 and calls[2][2].tolist() == [6.0] * 3
    assert calls[1][2].tolist() == [3.0, 4.0, 5.0]
    for i0 in (0, 3):
        gen = torch.Generator().manual_seed(tm.chunk_seed(11, i0))
        want = tm.sample_ddim(tmodel, ts, yc[i0:i0 + 3], yv[i0:i0 + 3], (3, 16, 16, 1), gen,
                              n_steps=2, guidance_scale=1.5)
        np.testing.assert_array_equal(got[i0:i0 + 3], want.numpy())
    gen = torch.Generator().manual_seed(tm.chunk_seed(11, 6))
    want = tm.sample_ddim(tmodel, ts, yc[6:].repeat(3), yv[6:].repeat(3, 1), (3, 16, 16, 1),
                          gen, n_steps=2, guidance_scale=1.5)
    np.testing.assert_array_equal(got[6:], want.numpy()[:1])
    with pytest.raises(NotImplementedError, match="JAX's CLIs offer no such mesh"):
        tm.sample_chunked(sampler, tmodel, ts, yc, yv, (7, 16, 16, 1), 0, chunk=3,
                          mesh=types.SimpleNamespace(mesh_dim_names=("data", "pipe")))


def test_sample_chunked_one_chunk_when_chunk_exceeds_n(models):
    _, _, tmodel = models
    yc, yv = tm.sample_grid_conditions(2, 4, 4)
    got = tm.sample_chunked(tm.sample_dpmpp_2m, tmodel, tm.VPSDE(0.1, 30.0), yc, yv, SHAPE, 3,
                            chunk=12, n_steps=2)
    gen = torch.Generator().manual_seed(tm.chunk_seed(3, 0))
    want = tm.sample_dpmpp_2m(tmodel, tm.VPSDE(0.1, 30.0), yc, yv, SHAPE, gen, n_steps=2)
    np.testing.assert_array_equal(got, want.numpy())
