"""Port of the SDE train step and epoch (toycrystals_torch/train) and of the
initialisers (models/torch_init.py) against the JAX package and optax, on
the CPU in f32.

Tolerances are stated at each comparison. Adam's first updates are
lr * sign(g)-like, so a gradient at rounding-noise level can flip a
parameter's update; parameters are therefore compared with an absolute
tolerance of a tenth of one update (lr / 10), and the moments, which are
linear in the gradients, carry the tight comparison.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from toycrystals_torch.data.lattice import LatticeConfig
from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.models.torch_init import flax_default_init, torch_like_init
from toycrystals_torch.train import state as ts
from toycrystals_torch.train.steps import (
    make_sde_train_epoch,
    make_sde_train_step,
    sde_loss_and_grads,
)
from toycrystals_torch.utils.params import (
    flax_from_torch_state_dict,
    load_flax_params,
    load_train_state_from_flax,
    torch_state_dict_from_flax,
    train_state_to_flax,
)
from toycrystals_tpu.models import sde_score_model as jm
from toycrystals_tpu.train.state import create_train_state as jax_create_train_state
from toycrystals_tpu.train.steps import make_sde_train_step as jax_make_sde_train_step

KW = dict(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16)
B, SIZE = 4, 16

# ---------------------------------------------------------------------------
# The optimizer alone, on injected gradients, against optax
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adam": (lambda: optax.adam(1e-2), lambda: ts.Optimizer(1e-2)),
    "clip": (lambda: optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-2)),
             lambda: ts.Optimizer(1e-2, clip_grad_norm=0.5)),
    "clip_inactive": (lambda: optax.chain(optax.clip_by_global_norm(1e3), optax.adam(1e-2)),
                      lambda: ts.Optimizer(1e-2, clip_grad_norm=1e3)),
    "warmup": (lambda: optax.adam(optax.linear_schedule(0.0, 1e-2, 4)),
               lambda: ts.Optimizer(ts.linear_schedule(0.0, 1e-2, 4))),
    "cosine": (lambda: optax.adam(optax.warmup_cosine_decay_schedule(
                   init_value=0.0, peak_value=1e-2, warmup_steps=2, decay_steps=6,
                   end_value=1e-4)),
               lambda: ts.Optimizer(ts.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6, 1e-4))),
}


def _leaves(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return {"a": (r.normal(size=(3, 4)) * scale).astype(np.float32),
            "b": (r.normal(size=(5,)) * scale).astype(np.float32)}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    make_optax, make_port = OPTIMIZERS[name]
    jtx, ttx = make_optax(), make_port()
    jp = {k: jnp.asarray(v) for k, v in _leaves(0).items()}
    jstate = jtx.init(jp)
    tp = [torch.tensor(v) for v in _leaves(0).values()]
    tstate = ttx.init(tp)
    for i in range(8):
        g = _leaves(100 + i, scale=0.3)
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        assert ttx.update(tp, [torch.tensor(v) for v in g.values()], tstate)
        for got, want in zip(tp, jp.values()):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert tstate.count == 8


@pytest.mark.parametrize("name", ["warmup", "cosine"])
def test_schedules_match_optax(name):
    sched = {"warmup": (optax.linear_schedule(0.0, 1e-2, 4), ts.linear_schedule(0.0, 1e-2, 4)),
             "cosine": (optax.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 10, 1e-4),
                        ts.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 10, 1e-4))}[name]
    for count in range(14):
        np.testing.assert_allclose(sched[1](count), float(sched[0](count)), rtol=1e-6,
                                   atol=1e-10)


def test_skipped_nonfinite_step_leaves_everything_untouched_like_optax():
    jtx = optax.apply_if_finite(optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-2)),
                                max_consecutive_errors=2)
    ttx = ts.Optimizer(1e-2, clip_grad_norm=0.5, skip_nonfinite=2)
    jp = {k: jnp.asarray(v) for k, v in _leaves(0).items()}
    jstate = jtx.init(jp)
    tp = [torch.tensor(v) for v in _leaves(0).values()]
    tstate = ttx.init(tp)
    applied = []
    for i, bad in enumerate([False, True, False, True, True, True, False]):
        g = _leaves(200 + i, scale=0.3)
        if bad:
            g["b"][2] = np.nan if i % 2 else np.inf
        before = [p.clone() for p in tp]
        mu_before, count_before = [m.clone() for m in tstate.mu], tstate.count
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        applied.append(ttx.update(tp, [torch.tensor(v) for v in g.values()], tstate))
        if not applied[-1]:
            assert tstate.count == count_before
            for p, q in zip(tp, before):
                assert torch.equal(p, q)
            for m, q in zip(tstate.mu, mu_before):
                assert torch.equal(m, q)
        if i < 5:  # up to the third bad step in a row, which both accept (NaN from then on)
            for got, want in zip(tp, jp.values()):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    # two consecutive bad steps are skipped, the third is accepted
    assert applied == [True, False, True, False, False, True, True]
    assert tstate.total_notfinite == int(jstate.total_notfinite) == 4
    assert bool(np.isnan(np.asarray(jp["b"])).any()) and bool(torch.isnan(tp[1]).any())


# ---------------------------------------------------------------------------
# Whole steps against JAX
# ---------------------------------------------------------------------------


def _batch(seed):
    r = np.random.default_rng(seed)
    return (r.uniform(size=(B, SIZE, SIZE, 1)).astype(np.float32),
            r.integers(0, 4, size=(B,)).astype(np.int32),
            r.normal(size=(B, 4)).astype(np.float32))


def _jax_params(stem, seed=11):
    args = (jnp.zeros((2, SIZE, SIZE, 1)), jnp.zeros((2,)), jnp.zeros((2,), jnp.int32),
            jnp.zeros((2, 4)))
    return jax.tree.map(np.asarray,
                        jm.CondUNetTiny(**KW, stem=stem).init(jax.random.key(seed),
                                                              *args)["params"])


@pytest.mark.parametrize("stem", ["none", "s2dr"])
def test_three_train_steps_match_jax(stem):
    lr, decay, clip = 1e-3, 0.9, 1.0
    params = _jax_params(stem)
    jmodel = jm.CondUNetTiny(**KW, stem=stem)
    jtx = optax.chain(optax.clip_by_global_norm(clip), optax.adam(lr))
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, params), jtx, ema=True)
    jstep = jax_make_sde_train_step(jmodel, jtx, jm.VPSDE(0.1, 30.0), 4, 0.5, 1.0, decay)

    tmodel = tm.CondUNetTiny(**KW, stem=stem)
    load_flax_params(tmodel, params)
    ttx = ts.Optimizer(lr, clip_grad_norm=clip)
    tstate = ts.create_train_state(tmodel, ttx, ema=True)
    tstep = make_sde_train_step(tmodel, ttx, tm.VPSDE(0.1, 30.0), 4, 0.5, 1.0, decay)

    for i in range(3):
        x0, y_cat, y_cont = _batch(20 + i)
        key = jax.random.key(30 + i)
        t, eps, yc, yv = jm.draw_diffusion_loss_noise(
            jnp.asarray(x0), jnp.asarray(y_cat), jnp.asarray(y_cont), key, 4, 0.5)
        jstate, jloss = jstep(jstate, jnp.asarray(x0), jnp.asarray(y_cat),
                              jnp.asarray(y_cont), key)
        tstate, tloss = tstep(tstate, torch.tensor(x0), torch.tensor(np.asarray(yc)),
                              torch.tensor(np.asarray(yv)),
                              noise=(torch.tensor(np.asarray(t)), torch.tensor(np.asarray(eps))))
        assert tloss.dim() == 0 and not tloss.requires_grad
        # the loss after i updates: 1e-4 relative (parameters may differ by
        # sign-flipped Adam updates of noise-level gradients)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    assert tstate.step == int(jstate.step) == 3 and tstate.opt_state.count == 3

    trees = train_state_to_flax(tstate)
    adam = jstate.opt_state[1][0]
    want = {"params": jstate.params, "ema_params": jstate.ema_params, "mu": adam.mu,
            "nu": adam.nu}
    sds = {name: (torch_state_dict_from_flax(trees[name]),
                  torch_state_dict_from_flax(jax.tree.map(np.asarray, want[name])))
           for name in want}
    for name, atol in (("mu", 1e-5), ("nu", 1e-7)):
        got_sd, want_sd = sds[name]
        assert set(got_sd) == set(want_sd)
        for k in want_sd:
            scale = max(float(np.abs(want_sd[k]).max()), 1e-3)
            np.testing.assert_allclose(got_sd[k], want_sd[k], atol=atol + 2e-3 * scale, rtol=0,
                                       err_msg=f"{name} {k}")
    # Parameters and EMA where the gradient is not at noise level (|mu| at least
    # a tenth of the leaf's largest and above 1e-5): within a tenth of one update.
    compared = 0
    for name in ("params", "ema_params"):
        got_sd, want_sd = sds[name]
        for k, mu in sds["mu"][1].items():
            mask = np.abs(mu) >= max(0.1 * float(np.abs(mu).max()), 1e-5)
            compared += int(mask.sum())
            np.testing.assert_allclose(got_sd[k][mask], want_sd[k][mask], atol=lr / 10, rtol=0,
                                       err_msg=f"{name} {k}")
    assert compared > 1000
    # the EMA moved away from the params and towards them
    assert any(not torch.equal(tstate.ema_params[k], tstate.params[k]) for k in tstate.params)


@pytest.mark.parametrize("attn", ["auto_2304_tokens", "flash_256_tokens"])
def test_v_param_step_loss_and_gradients_match_jax_at_the_flash_sizes(attn):
    """`parameterization="v"` on the shifted schedule of the 256x256 recipe
    (logsnr_shift -2.77), on injected (t, eps): the loss (2e-5 relative) and
    every gradient leaf (1e-5 + 2e-3 of the leaf's largest entry, the limits of
    tests/test_torch_loss.py; conv biases ahead of a GroupNorm have gradients
    at rounding-noise level) against JAX.

    auto_2304_tokens: a 192x192 item, 48x48 = 2,304 bottleneck tokens, where
    both sides take their matmul path on the CPU. flash_256_tokens: 64x64
    items with attn_impl="flash" forced on both sides; JAX runs its Pallas
    kernel and the backward kernels in interpret mode, the port the plain
    version under autograd."""
    from jax.experimental.pallas import tpu as pltpu

    size, b, impl = (192, 1, "auto") if attn.startswith("auto") else (64, 2, "flash")
    r = np.random.default_rng(40)
    x0 = r.uniform(size=(b, size, size, 1)).astype(np.float32)
    y_cat = r.integers(0, 4, size=(b,)).astype(np.int32)
    y_cont = r.normal(size=(b, 4)).astype(np.float32)
    t = r.uniform(0.05, 1.0, size=(b,)).astype(np.float32)
    eps = r.normal(size=x0.shape).astype(np.float32)
    params = _jax_params("none")
    sde_kw = dict(beta_min=0.1, beta_max=30.0, logsnr_shift=-2.77)

    jmodel = jm.CondUNetTiny(**KW, stem="none", attn_impl=impl)

    def loss_fn(p):
        apply_fn = lambda prm, x_t, tt, yc, yv: jmodel.apply({"params": prm}, x_t, tt, yc, yv)
        return jm.diffusion_loss_eps_given(apply_fn, p, jm.VPSDE(**sde_kw), jnp.asarray(x0),
                                           jnp.asarray(y_cat), jnp.asarray(y_cont),
                                           jnp.asarray(t), jnp.asarray(eps), "v")

    with pltpu.force_tpu_interpret_mode():
        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = torch_state_dict_from_flax(jax.tree.map(np.asarray, jgrads))

    tmodel = tm.CondUNetTiny(**KW, stem="none", attn_impl=impl)
    load_flax_params(tmodel, params)
    loss, grads = sde_loss_and_grads(tmodel, tm.VPSDE(**sde_kw), torch.tensor(x0),
                                     torch.tensor(y_cat), torch.tensor(y_cont),
                                     torch.tensor(t), torch.tensor(eps), "v")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
    names = [k for k, _ in tmodel.named_parameters()]
    assert set(names) == set(want)
    for k, g in zip(names, grads):
        lim = 1e-5 + 2e-3 * max(float(np.abs(want[k]).max()), 1e-3)
        np.testing.assert_allclose(g.numpy(), want[k], atol=lim, rtol=0, err_msg=k)


def test_grad_accum_equals_the_unsplit_step():
    sde = tm.VPSDE(0.1, 30.0)
    x0, y_cat, y_cont = (torch.tensor(a) for a in _batch(40))
    g = torch.Generator().manual_seed(0)
    t, eps = torch.rand(B, generator=g), torch.randn(x0.shape, generator=g)
    results = []
    for k in (1, 2, 4):
        model = flax_default_init(tm.CondUNetTiny(**KW, stem="s2dr"), np.random.default_rng(1))
        tx = ts.Optimizer(1e-3)
        state = ts.create_train_state(model, tx, ema=True)
        step = make_sde_train_step(model, tx, sde, 4, 0.1, 1.0, 0.99, grad_accum=k)
        loss, grads = sde_loss_and_grads(model, sde, x0, y_cat, y_cont, t, eps, grad_accum=k)
        state, loss2 = step(state, x0, y_cat, y_cont, noise=(t, eps))
        assert float(loss) == float(loss2)
        results.append((float(loss), grads, [m.clone() for m in state.opt_state.mu]))
    for loss, grads, mu in results[1:]:
        # mean of chunk means == batch mean, up to f32 summation order
        np.testing.assert_allclose(loss, results[0][0], rtol=1e-5)
        for g_, w_ in zip(grads, results[0][1]):
            torch.testing.assert_close(g_, w_, atol=2e-6, rtol=1e-4)
        for m_, w_ in zip(mu, results[0][2]):
            torch.testing.assert_close(m_, w_, atol=2e-7, rtol=1e-4)
    with pytest.raises(ValueError, match="divisible"):
        sde_loss_and_grads(model, sde, x0, y_cat, y_cont, t, eps, grad_accum=3)


def test_step_draws_from_its_generator_only():
    model = flax_default_init(tm.CondUNetTiny(**KW), np.random.default_rng(2))
    tx = ts.Optimizer(1e-3)
    step = make_sde_train_step(model, tx, tm.VPSDE(0.1, 30.0), 4, 0.1, 1.0, 0.0)
    x0, y_cat, y_cont = (torch.tensor(a) for a in _batch(41))
    with pytest.raises(ValueError, match="Generator"):
        step(ts.create_train_state(model, tx), x0, y_cat, y_cont)
    losses = []
    for _ in range(2):
        flax_default_init(model, np.random.default_rng(2))
        torch.manual_seed(len(losses))  # the global generator must not matter
        _, loss = step(ts.create_train_state(model, tx), x0, y_cat, y_cont,
                       torch.Generator().manual_seed(5))
        losses.append(float(loss))
    assert losses[0] == losses[1]


def test_skipped_step_moves_neither_params_nor_ema():
    model = flax_default_init(tm.CondUNetTiny(**KW), np.random.default_rng(3))
    tx = ts.Optimizer(1e-3, skip_nonfinite=3)
    state = ts.create_train_state(model, tx, ema=True)
    step = make_sde_train_step(model, tx, tm.VPSDE(0.1, 30.0), 4, 0.1, 1.0, 0.9)
    x0, y_cat, y_cont = (torch.tensor(a) for a in _batch(42))
    state, _ = step(state, x0, y_cat, y_cont, torch.Generator().manual_seed(0))
    params = {k: v.detach().clone() for k, v in state.params.items()}
    ema = {k: v.clone() for k, v in state.ema_params.items()}
    bad = x0.clone()
    bad[0, 0, 0, 0] = float("nan")
    state, loss = step(state, bad, y_cat, y_cont, torch.Generator().manual_seed(1))
    assert math.isnan(float(loss))
    assert state.step == 2 and state.opt_state.count == 1
    assert state.opt_state.total_notfinite == 1
    for k in params:
        assert torch.equal(state.params[k], params[k]) and torch.equal(state.ema_params[k],
                                                                       ema[k])


def test_epoch_over_a_procedural_set_lowers_the_loss():
    model = flax_default_init(tm.CondUNetTiny(**KW, stem="s2dr"), np.random.default_rng(0))
    tx = ts.Optimizer(1e-3, clip_grad_norm=1.0)
    state = ts.create_train_state(model, tx, ema=True)
    cfg = LatticeConfig(img_size=SIZE, rot_only=True)
    epoch = make_sde_train_epoch(model, tx, tm.VPSDE(0.1, 30.0), 4, 0.1, 1.0, 0.999, 16, 64,
                                 lattice_cfg=cfg, dataset_seed=0, nan_safe_metrics=True)
    g = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(5):
        state, loss = epoch(state, g)
        losses.append(float(loss))
    assert state.step == 20 and all(np.isfinite(losses))
    assert losses[-1] < 0.8 * losses[0]
    with pytest.raises(ValueError, match="offset"):
        epoch(state, g, 64)


def test_epoch_sources_and_arguments():
    model = flax_default_init(tm.CondUNetTiny(**KW), np.random.default_rng(0))
    tx = ts.Optimizer(1e-3)
    sde = tm.VPSDE(0.1, 30.0)
    cfg = LatticeConfig(img_size=SIZE, rot_only=True)
    args = (model, tx, sde, 4, 0.1, 1.0, 0.0, 8)
    with pytest.raises(ValueError, match="exactly one"):
        make_sde_train_epoch(*args, 16)
    with pytest.raises(ValueError, match="fresh_data"):
        make_sde_train_epoch(*args, 16, resident=(None, None, None), fresh_data=True)
    with pytest.raises(ValueError, match="batch_size"):
        make_sde_train_epoch(*args, 4, lattice_cfg=cfg)
    with pytest.raises(NotImplementedError, match="JAX's CLIs offer no such mesh"):
        make_sde_train_epoch(*args, 16, lattice_cfg=cfg,
                             mesh=types.SimpleNamespace(mesh_dim_names=("data", "space",
                                                                        "pipe")))
    # resident source: u8 images decoded on the fly; fresh_data shifts the items
    r = np.random.default_rng(1)
    resident = (torch.tensor(r.integers(0, 256, size=(16, SIZE, SIZE, 1), dtype=np.uint8)),
                torch.tensor(r.integers(0, 4, size=(16,)).astype(np.int32)),
                torch.tensor(r.normal(size=(16, 4)).astype(np.float32)))
    state = ts.create_train_state(model, tx)
    state, loss = make_sde_train_epoch(*args, 16, resident=resident)(
        state, torch.Generator().manual_seed(0))
    assert state.step == 2 and torch.isfinite(loss) and state.ema_params is None
    fresh = make_sde_train_epoch(*args, 16, lattice_cfg=cfg, fresh_data=True)
    state, loss = fresh(state, torch.Generator().manual_seed(0), 1000)
    assert state.step == 4 and torch.isfinite(loss)


def test_train_state_round_trips_through_flax_trees():
    model = flax_default_init(tm.CondUNetTiny(**KW, stem="s2dr"), np.random.default_rng(4))
    tx = ts.Optimizer(1e-3)
    state = ts.create_train_state(model, tx, ema=True)
    step = make_sde_train_step(model, tx, tm.VPSDE(0.1, 30.0), 4, 0.1, 1.0, 0.9)
    x0, y_cat, y_cont = (torch.tensor(a) for a in _batch(43))
    for i in range(2):
        state, _ = step(state, x0, y_cat, y_cont, torch.Generator().manual_seed(i))
    trees = train_state_to_flax(state)
    assert trees["step"] == 2 and trees["count"] == 2
    assert trees["mu"]["down1"]["conv0"]["kernel"].shape == (3, 3, 68, 8)
    assert trees["params"]["up1"]["gn1"]["scale"].shape == (8,)
    other = flax_default_init(tm.CondUNetTiny(**KW, stem="s2dr"), np.random.default_rng(5))
    fresh = ts.create_train_state(other, tx, ema=True)
    load_train_state_from_flax(fresh, trees)
    assert fresh.step == 2 and fresh.opt_state.count == 2
    for k in state.params:
        assert torch.equal(fresh.params[k], state.params[k])
        assert torch.equal(fresh.ema_params[k], state.ema_params[k])
    for a, b in zip(fresh.opt_state.mu + fresh.opt_state.nu,
                    state.opt_state.mu + state.opt_state.nu):
        assert torch.equal(a, b)
    assert fresh.sample_params is fresh.ema_params
    with pytest.raises(ValueError, match="EMA"):
        load_train_state_from_flax(ts.create_train_state(other, tx), trees)
    with pytest.raises(KeyError):
        load_train_state_from_flax(fresh, dict(trees, mu=trees["mu"]["down1"]))


def test_create_train_state_holds_the_models_own_f32_parameters():
    model = tm.CondUNetTiny(**KW, dtype=torch.bfloat16)
    state = ts.create_train_state(model, ts.Optimizer(1e-3))
    assert state.step == 0 and state.ema_params is None
    assert state.sample_params is state.params
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert state.params["down1.conv0.weight"] is model.down1.conv0.weight
    assert all(float(m.abs().max()) == 0.0 for m in state.opt_state.mu)
    with pytest.raises(TypeError, match="float32"):
        ts.create_train_state(tm.CondUNetTiny(**KW).to(torch.bfloat16), ts.Optimizer(1e-3))


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------


def test_torch_like_init_statistics():
    model = tm.CondUNetTiny(n_types=4, y_cont_dim=4, base_ch=32, emb_dim=64, stem="s2dr")
    torch_like_init(model, torch.Generator().manual_seed(0))
    for m, fan_in in ((model.down1.conv1, 32 * 9), (model.Dense_0, 64), (model.attn.qkv, 64)):
        bound = 1.0 / math.sqrt(fan_in)
        for p in (m.weight, m.bias):
            assert float(p.detach().abs().max()) <= bound
        assert abs(float(m.weight.detach().std()) - bound / math.sqrt(3.0)) < 0.06 * bound
        assert float(m.bias.detach().abs().max()) > 0.5 * bound
    emb = model.ConditionEmbedding_0.cat_emb.weight
    assert abs(float(emb.std()) - 1.0) < 0.15 and abs(float(emb.mean())) < 0.15
    for gn in (model.down1.gn0, model.attn.GroupNorm_0):
        assert bool((gn.weight == 1).all()) and bool((gn.bias == 0).all())
    again = tm.CondUNetTiny(n_types=4, y_cont_dim=4, base_ch=32, emb_dim=64, stem="s2dr")
    torch_like_init(again, torch.Generator().manual_seed(0))
    assert torch.equal(again.out.weight, model.out.weight)


def test_flax_default_init_statistics_and_seed():
    model = flax_default_init(tm.CondUNetTiny(n_types=4, y_cont_dim=4, base_ch=32, emb_dim=64),
                              np.random.default_rng(0))
    w = model.down1.conv1.weight
    assert abs(float(w.std()) * math.sqrt(32 * 9) - 1.0) < 0.05
    assert float(model.down1.conv1.bias.abs().max()) == 0.0
    assert bool((model.mid.gn1.weight == 1).all()) and bool((model.mid.gn1.bias == 0).all())
    assert abs(float(model.ConditionEmbedding_0.cat_emb.weight.std()) - 1.0) < 0.15
    other = flax_default_init(tm.CondUNetTiny(n_types=4, y_cont_dim=4, base_ch=32, emb_dim=64),
                              np.random.default_rng(0))
    assert torch.equal(other.up2.conv0.weight, model.up2.conv0.weight)
    tree = flax_from_torch_state_dict(model.state_dict())
    assert tree["down1"]["conv1"]["kernel"].shape == (3, 3, 32, 32)
