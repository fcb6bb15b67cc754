"""The port's latent diffusion prior (toycrystals_torch/models/diffusion_prior.py,
the prior train step and epoch of train/steps.py, the prior bridges) against
the JAX package on the CPU, at a small size: width 32, 2-3 blocks, z 8, T 50,
batches of 8.

Tolerances: the module forwards on bridged weights, f32, atol 1e-5 x max|out|;
the discrete embedding within two f32 ulps of its largest argument t f (XLA's
and torch's sin/cos/exp differ by an ulp); the schedule's betas and
alpha_bars within 2e-6 relative (XLA's cumprod associates differently; below
f32's smallest normal, where XLA flushes to 0, both must be denormal or 0);
q_sample on JAX's schedule arrays 1e-6; DDIM-10 on injected z and JAX's
schedule atol 1e-4 x max|z0|; the step's loss 1e-6 relative, bucket sums
1e-5 relative, counts exact, gradients leaf by leaf atol 1e-5 x the leaf's
max|g| + 1e-7; ddim_timesteps and the epoch against its own steps exact.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from toycrystals_torch.models import diffusion_prior as tp
from toycrystals_torch.train.state import Optimizer, create_train_state
from toycrystals_torch.train.steps import (
    make_prior_train_epoch,
    make_prior_train_step,
    prior_loss_and_grads,
)
from toycrystals_torch.utils.params import (
    flax_prior_from_torch_state_dict,
    torch_state_dict_from_flax_prior,
)
from toycrystals_torch.utils.torch_interop import load_torch_prior_checkpoint
from toycrystals_tpu.models import diffusion_prior as jp
from toycrystals_tpu.train.state import create_train_state as j_create_train_state
from toycrystals_tpu.train.steps import make_prior_train_step as j_make_prior_train_step
from toycrystals_tpu.utils.torch_interop import (
    flax_prior_params_from_torch_state_dict as j_flax_prior_params_from_torch_state_dict,
)

Z, W, T, B = 8, 32, 50, 8
KW = dict(z_dim=Z, n_types=4, y_cont_dim=4, t_emb_dim=16, width=W)
FILM_KW = dict(KW, n_blocks=3, y_cat_emb_dim=8)


def _inputs(seed: int = 0, b: int = B):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, Z)).astype(np.float32), rng.integers(0, T, b).astype(np.int32),
            rng.integers(0, 4, b).astype(np.int32),
            rng.uniform(0, 1, (b, 4)).astype(np.float32))


def _init(jmodel, seed: int = 0):
    z, t, yc, yv = _inputs(seed, 2)
    return jax.jit(jmodel.init)(jax.random.key(seed), z, t, yc, yv)["params"]


def _load(model, params):
    model.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                           for k, v in torch_state_dict_from_flax_prior(params).items()})
    return model


def _close(got, want, scale: float = 1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=scale * float(np.abs(want).max()))


def test_discrete_embedding_matches_jax():
    t = np.arange(0, 1000, 7).astype(np.int32)
    for dim in (16, 17, 64):
        got = tp.timestep_embedding_discrete(torch.from_numpy(t), dim).numpy()
        want = np.asarray(jp.timestep_embedding_discrete(jnp.asarray(t), dim))
        assert got.shape == want.shape == (len(t), dim)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * 999 * 2.0**-23)
        # sin first, then cos
        assert np.all(got[0, : dim // 2] == 0.0) and np.all(got[0, dim // 2: 2 * (dim // 2)] == 1)


@pytest.mark.parametrize("which", ["film", "plain", "block"])
def test_modules_match_flax_on_bridged_weights(which):
    z, t, yc, yv = _inputs(1)
    if which == "film":
        jm, tm = jp.DiffusionPriorFiLM(**FILM_KW), tp.DiffusionPriorFiLM(**FILM_KW)
        params = _init(jm)
        want = jm.apply({"params": params}, z, t, yc, yv)
        got = _load(tm, params)(*map(torch.from_numpy, (z, t, yc, yv)))
    elif which == "plain":
        jm, tm = jp.DiffusionPrior(**KW), tp.DiffusionPrior(**KW)
        params = _init(jm)
        want = jm.apply({"params": params}, z, t, yc, yv)
        got = _load(tm, params)(*map(torch.from_numpy, (z, t, yc, yv)))
    else:
        rng = np.random.default_rng(2)
        x, cond = (rng.normal(size=s).astype(np.float32) for s in ((B, W), (B, 2 * W)))
        jm, tm = jp.FiLMResBlock(W), tp.FiLMResBlock(W, 2 * W)
        params = jm.init(jax.random.key(3), x, cond)["params"]
        # a block's flax tree bridges as block_0 of a prior
        sd = torch_state_dict_from_flax_prior({"in_proj": {}, "block_0": params})
        tm.load_state_dict({k.removeprefix("blocks.0."): torch.from_numpy(v)
                            for k, v in sd.items()})
        want = jm.apply({"params": params}, x, cond)
        got = tm(torch.from_numpy(x), torch.from_numpy(cond))
    _close(got.detach().numpy(), want)
    # the bridge is exact both ways
    back = flax_prior_from_torch_state_dict(tm.state_dict())
    if which != "block":
        jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, params))


def test_linear_schedule_is_within_2e6_of_jax():
    for t_max, beta_end in ((200, 1.0), (1000, 0.05)):
        js = jp.DiffusionSchedule.linear(t_max, 1e-4, beta_end)
        ts = tp.DiffusionSchedule.linear(t_max, 1e-4, beta_end)
        assert ts.T == t_max
        for k in ("betas", "alpha_bars"):
            want, got = np.asarray(getattr(js, k)), getattr(ts, k).numpy()
            normal = np.abs(want) >= np.finfo(np.float32).tiny
            np.testing.assert_allclose(got[normal], want[normal], rtol=2e-6, atol=0)
            assert np.all(np.abs(got[~normal]) < np.finfo(np.float32).tiny)


def _jax_sched(t_max: int = T, beta_end: float = 0.05):
    js = jp.DiffusionSchedule.linear(t_max, 1e-4, beta_end)
    return js, tp.DiffusionSchedule.from_arrays(np.asarray(js.betas), np.asarray(js.alpha_bars))


def test_q_sample_matches_jax():
    js, ts = _jax_sched()
    z0, t, _, _ = _inputs(4)
    eps = np.random.default_rng(5).normal(size=z0.shape).astype(np.float32)
    want = js.q_sample(jnp.asarray(z0), jnp.asarray(t), jnp.asarray(eps))
    got = ts.q_sample(*map(torch.from_numpy, (z0, t, eps)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    for k in ("alphas", "sqrt_alpha_bars", "sqrt_one_minus_alpha_bars"):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)),
                                   rtol=1e-6, atol=0)


def test_ddim_timesteps_equal():
    for t_max, n in ((50, 10), (200, 50), (1000, 50), (7, 20), (3, 1)):
        np.testing.assert_array_equal(tp.ddim_timesteps(t_max, n), jp.ddim_timesteps(t_max, n))


def test_ddim_sample_matches_jax_on_injected_noise():
    js, ts = _jax_sched()
    jm, tm = jp.DiffusionPriorFiLM(**FILM_KW), tp.DiffusionPriorFiLM(**FILM_KW)
    params = _init(jm, 6)
    _load(tm, params)
    _, _, yc, yv = _inputs(7)
    key = jax.random.key(8)
    want = jp.ddim_sample(lambda p, *a: jm.apply({"params": p}, *a), params, js,
                          jnp.asarray(yc), jnp.asarray(yv), 10, Z, key)
    z = np.asarray(jax.random.normal(key, (B, Z), jnp.float32))  # the JAX sampler's start noise
    got = tp.ddim_sample(tm, ts, torch.from_numpy(yc), torch.from_numpy(yv), 10, Z,
                         z=torch.from_numpy(z))
    _close(got.numpy(), want, 1e-4)
    with pytest.raises(NotImplementedError, match="eta"):
        tp.ddim_sample(tm, ts, torch.from_numpy(yc), torch.from_numpy(yv), 10, Z,
                       z=torch.from_numpy(z), eta=0.5)
    with pytest.raises(ValueError, match="Generator"):
        tp.ddim_sample(tm, ts, torch.from_numpy(yc), torch.from_numpy(yv), 10, Z)


def _reference_state_dict(rng, n_blocks: int = 2, yce: int = 8) -> dict:
    """A random state_dict in the original torch DiffusionPriorFiLM's layout."""
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.1)

    sd = {"y_cat_emb.weight": t(4, yce), "y_cont_mlp.0.weight": t(yce, 4),
          "y_cont_mlp.0.bias": t(yce), "y_cont_mlp.2.weight": t(yce, yce),
          "y_cont_mlp.2.bias": t(yce), "y_fuse.0.weight": t(W, 2 * yce), "y_fuse.0.bias": t(W),
          "y_fuse.2.weight": t(W, W), "y_fuse.2.bias": t(W), "t_mlp.0.weight": t(W, 16),
          "t_mlp.0.bias": t(W), "t_mlp.2.weight": t(W, W), "t_mlp.2.bias": t(W),
          "in_proj.weight": t(W, Z), "in_proj.bias": t(W), "out_norm.weight": 1 + t(W),
          "out_norm.bias": t(W), "out_proj.weight": t(Z, W), "out_proj.bias": t(Z)}
    for i in range(n_blocks):
        sd.update({f"blocks.{i}.norm.weight": 1 + t(W), f"blocks.{i}.norm.bias": t(W),
                   f"blocks.{i}.cond.weight": t(2 * W, 2 * W), f"blocks.{i}.cond.bias": t(2 * W),
                   f"blocks.{i}.fc1.weight": t(4 * W, W), f"blocks.{i}.fc1.bias": t(4 * W),
                   f"blocks.{i}.fc2.weight": t(W, 4 * W), f"blocks.{i}.fc2.bias": t(W)})
    return sd


def test_reference_pt_round_trip(tmp_path):
    """A reference `diffusion_prior_last.pt` loads into the port's module as it
    is, converts to the JAX loader's tree exactly, and both forwards agree."""
    sd = _reference_state_dict(np.random.default_rng(9))
    path = tmp_path / "diffusion_prior_last.pt"
    torch.save(sd, path)
    tree = load_torch_prior_checkpoint(str(path))["params"]
    want_tree = j_flax_prior_params_from_torch_state_dict(sd)
    jax.tree.map(np.testing.assert_array_equal, tree, want_tree)
    kw = dict(FILM_KW, n_blocks=2)
    tm = tp.DiffusionPriorFiLM(**kw)
    tm.load_state_dict(sd)
    z, t, yc, yv = _inputs(10)
    want = jp.DiffusionPriorFiLM(**kw).apply({"params": want_tree}, z, t, yc, yv)
    got = tm(*map(torch.from_numpy, (z, t, yc, yv))).detach().numpy()
    _close(got, want)
    # and back: the port's state_dict is the reference's
    sd2 = torch_state_dict_from_flax_prior(tree)
    assert set(sd2) == set(sd)
    assert all(np.array_equal(sd2[k], sd[k].numpy()) for k in sd)
    torch.save({"nope": torch.zeros(1)}, tmp_path / "x.pt")
    with pytest.raises(ValueError, match="not a reference FiLM-prior checkpoint"):
        load_torch_prior_checkpoint(str(tmp_path / "x.pt"))


def _jax_loss(jm, aux_weight: float = 0.0):
    """The JAX step's loss (toycrystals_tpu/train/steps.py:make_prior_train_step)
    after its draws, for jax.grad on injected (t, eps)."""
    def loss_fn(params, sched, z0n, yc, yv, t, eps):
        z_t = sched.q_sample(z0n, t, eps)
        if aux_weight:
            out, mut = jm.apply({"params": params}, z_t, t, yc, yv, mutable=["losses"])
            terms = jax.tree.leaves(mut["losses"])
            aux = sum(jnp.mean(v) for v in terms) / len(terms)
        else:
            out, aux = jm.apply({"params": params}, z_t, t, yc, yv), 0.0
        return jnp.mean(jnp.mean((out - eps) ** 2, axis=1)) + aux_weight * aux
    return loss_fn


def check_step_against_jax(jm, tm, aux_weight: float, seed: int) -> None:
    """One prior step: JAX's own step on its key, the port's on JAX's draws of
    that key; metrics, then jax.grad against the port's gradients."""
    js, ts = _jax_sched()
    params = _init(jm, seed)
    _load(tm, params)
    z0n, _, yc, yv = _inputs(seed + 1)
    key = jax.random.key(seed + 2)
    jstep = j_make_prior_train_step(jm, optax.adam(1e-4), T, aux_weight=aux_weight)
    # the JAX step donates its state: give it a copy of the params
    state0 = j_create_train_state(jax.tree.map(jnp.array, params), optax.adam(1e-4))
    _, jmet = jstep(state0, js, jnp.asarray(z0n),
                    jnp.asarray(yc), jnp.asarray(yv), key)
    k_t, k_eps = jax.random.split(key)
    u = jax.random.uniform(k_t, (B,))
    t = np.asarray(jnp.clip((u**2 * T).astype(jnp.int32), 0, T - 1))
    eps = np.asarray(jax.random.normal(k_eps, (B, Z), jnp.float32))
    args = [torch.from_numpy(a) for a in (z0n, yc, yv, t, eps)]
    met, grads = prior_loss_and_grads(tm, ts, *args, aux_weight=aux_weight)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]), rtol=1e-6)
    np.testing.assert_array_equal(met["bucket_n"].numpy(), np.asarray(jmet["bucket_n"]))
    np.testing.assert_allclose(met["bucket_sum"].numpy(), np.asarray(jmet["bucket_sum"]),
                               rtol=1e-5)
    assert int(met["bucket_n"].sum()) == B
    jg = jax.jit(jax.grad(_jax_loss(jm, aux_weight)))(params, js, z0n, yc, yv, t, eps)
    want = torch_state_dict_from_flax_prior(jax.tree.map(np.asarray, jg))
    for (name, _), g in zip(tm.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0,
                                   atol=1e-5 * float(np.abs(want[name]).max()) + 1e-7,
                                   err_msg=name)
    # the step applies them: the same parameters after one update as Adam by hand
    tx = Optimizer(1e-4)
    state = create_train_state(tm, tx)
    make_prior_train_step(tm, tx, T, aux_weight=aux_weight)(state, ts, *args[:3],
                                                            noise=tuple(args[3:]))
    assert state.step == 1 and state.opt_state.count == 1


def test_prior_step_matches_jax_grad():
    check_step_against_jax(jp.DiffusionPriorFiLM(**FILM_KW), tp.DiffusionPriorFiLM(**FILM_KW),
                           0.0, 11)


def test_epoch_is_its_shuffle_then_its_steps():
    _, ts = _jax_sched()
    n = 3 * B + 5
    rng = np.random.default_rng(12)
    lat = (torch.from_numpy(rng.normal(size=(n, Z)).astype(np.float32)),
           torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)),
           torch.from_numpy(rng.uniform(size=(n, 4)).astype(np.float32)))
    runs = []
    for fused in (True, False):
        from toycrystals_torch.models.torch_init import flax_default_init

        tm = flax_default_init(tp.DiffusionPriorFiLM(**FILM_KW), np.random.default_rng(13))
        tx = Optimizer(1e-3)
        state = create_train_state(tm, tx)
        gen = torch.Generator().manual_seed(14)
        if fused:
            state, em = make_prior_train_epoch(tm, tx, T, B, lat)(state, ts, gen)
        else:
            step = make_prior_train_step(tm, tx, T)
            order = torch.randperm(n, generator=gen)[: 3 * B].reshape(3, B)
            ms = [step(state, ts, *(a[idx] for a in lat), gen)[1] for idx in order]
            em = {"loss": torch.stack([m["loss"] for m in ms]).mean(),
                  "aux": torch.stack([m["aux"] for m in ms]).mean(),
                  "bucket_sum": torch.stack([m["bucket_sum"] for m in ms]).sum(0),
                  "bucket_n": torch.stack([m["bucket_n"] for m in ms]).sum(0)}
        runs.append((em, {k: v.detach().clone() for k, v in state.params.items()}, state.step))
    (e1, p1, s1), (e2, p2, s2) = runs
    assert s1 == s2 == 3 and float(e1["bucket_n"].sum()) == 3 * B
    assert all(torch.equal(e1[k], e2[k]) for k in e1)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert math.isfinite(float(e1["loss"]))
    with pytest.raises(NotImplementedError, match="JAX's CLIs offer no such mesh"):  # 3-D
        make_prior_train_epoch(tm, tx, T, B, lat, mesh=types.SimpleNamespace(
            mesh_dim_names=("data", "space", "model")))


def test_layernorm_variance_formula_costs_under_2e6_at_width_1024():
    """flax's LayerNorm takes var = E[x^2] - E[x]^2 (floored at 0), torch two
    passes; at the CLI's width 1024 the normalised values differ by < 2e-6."""
    x = torch.from_numpy(np.random.default_rng(15).normal(2.0, 3.0, (512, 1024))
                         .astype(np.float32))
    m = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - m * m).clamp_min(0.0)
    flax_ln = (x - m) * torch.rsqrt(var + tp.LN_EPS)
    got = torch.nn.LayerNorm(1024, eps=tp.LN_EPS)(x).detach()
    assert float((got - flax_ln).abs().max()) < 2e-6
