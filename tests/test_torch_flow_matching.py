"""Rectified flow in the port (toycrystals_torch/models/flow_matching.py, the
service's rf sampler, --param fm and --sampler rf in the CLIs) against the
JAX package on the CPU, at base_ch 8.

Tolerances: samples on JAX's injected initial noise within 2e-5 absolute
(f32 forwards in another order, a few steps); the fm loss within 2e-5
relative and every gradient leaf within 1e-5 + 2e-3 of the leaf's largest
entry (the limits of tests/test_torch_train_step.py). Everything else is
exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from toycrystals_torch import serve
from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.models.flow_matching import sample_rectified_flow, shift_t
from toycrystals_torch.scripts import sample_sde_score_model as sample_cli
from toycrystals_torch.scripts import train_sde_score_model as train_cli
from toycrystals_torch.train import state as ts
from toycrystals_torch.train.steps import make_sde_train_step
from toycrystals_torch.utils.params import load_flax_params, torch_state_dict_from_flax
from toycrystals_tpu.models import flow_matching as jfm
from toycrystals_tpu.models import sde_score_model as jm
from toycrystals_tpu.serve import ScoreModelService as JaxService
from toycrystals_tpu.train.state import create_train_state as jax_create_train_state
from toycrystals_tpu.train.steps import make_sde_train_step as jax_make_sde_train_step

KW = dict(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16)
SIZE = 16
TINY = ["--device", "cpu", "--procedural", "--img-size", str(SIZE), "--base-ch", "8",
        "--emb-dim", "16", "--n-samples", "32", "--batch-size", "16", "--sample-every", "0"]


@pytest.fixture(scope="module")
def params():
    args = (jnp.zeros((2, SIZE, SIZE, 1)), jnp.zeros((2,)), jnp.zeros((2,), jnp.int32),
            jnp.zeros((2, 4)))
    return jax.tree.map(np.asarray,
                        jm.CondUNetTiny(**KW).init(jax.random.key(3), *args)["params"])


def _port_model(params):
    m = tm.CondUNetTiny(**KW)
    load_flax_params(m, params)
    return m.eval().requires_grad_(False)


def test_shift_t_matches_jax():
    t = np.linspace(0.0, 1.0, 11).astype(np.float32)
    for s in (1.0, 2.0, 4.0):
        np.testing.assert_allclose(shift_t(torch.tensor(t), s).numpy(),
                                   np.asarray(jfm.shift_t(jnp.asarray(t), s)), atol=1e-7)


@pytest.mark.parametrize("case", ["euler", "heun", "t_shift", "clip_x0", "cfg"])
def test_sample_rectified_flow_matches_jax_on_injected_noise(params, case):
    kw = dict(n_steps=3, guidance_scale=1.5 if case == "cfg" else 0.0, t_end=0.005,
              n_types=4, clip_x0=case == "clip_x0", solver="heun" if case == "heun" else "euler",
              t_shift=3.0 if case == "t_shift" else 1.0)
    b = 3
    y_cat = np.array([0, 2, 3], np.int32)
    y_cont = np.zeros((b, 4), np.float32)
    y_cont[:, 1] = [0.1, 0.5, 0.9]
    jmodel = jm.CondUNetTiny(**KW)
    apply_fn = lambda prm, x, t, yc, yv: jmodel.apply({"params": prm}, x, t, yc, yv)  # noqa: E731
    key = jax.random.key(9)
    want = jfm.sample_rectified_flow(apply_fn, params, None, jnp.asarray(y_cat),
                                     jnp.asarray(y_cont), (b, SIZE, SIZE, 1), key, **kw)
    noise = np.asarray(jax.random.normal(key, (b, SIZE, SIZE, 1), jnp.float32))
    got = sample_rectified_flow(_port_model(params), None, torch.tensor(y_cat),
                                torch.tensor(y_cont), (b, SIZE, SIZE, 1), noise=noise, **kw)
    assert got.shape == (b, SIZE, SIZE, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_sample_rectified_flow_counts_evaluations_and_draws_from_its_generator(params):
    calls = []
    model = _port_model(params)

    def apply_fn(*a):
        calls.append(a[0].shape[0])
        return model(*a)

    yc, yv = torch.zeros(2, dtype=torch.int32), torch.zeros(2, 4)
    for solver, steps, gs, want in (("euler", 4, 0.0, [2] * 5), ("heun", 3, 1.5, [4] * 7)):
        calls.clear()
        x1 = sample_rectified_flow(apply_fn, None, yc, yv, (2, SIZE, SIZE, 1),
                                   torch.Generator().manual_seed(1), n_steps=steps,
                                   guidance_scale=gs, solver=solver)
        assert calls == want  # steps (x2 for heun) + the projection; CFG doubles the rows
        x2 = sample_rectified_flow(apply_fn, None, yc, yv, (2, SIZE, SIZE, 1),
                                   torch.Generator().manual_seed(1), n_steps=steps,
                                   guidance_scale=gs, solver=solver)
        assert torch.equal(x1, x2)
    with pytest.raises(ValueError, match="euler|heun"):
        sample_rectified_flow(apply_fn, None, yc, yv, (2, SIZE, SIZE, 1), solver="rk4")


@dataclasses.dataclass(frozen=True)
class CaptureGrads(ts.Optimizer):
    """The port's optimizer, keeping a copy of the gradients of every update."""

    seen: list = dataclasses.field(default_factory=list)

    def update(self, params, grads, state):
        self.seen.append([g.clone() for g in grads])
        return super().update(params, grads, state)


def _capture_grads():
    """An optax transformation whose state after a step is that step's
    gradients (and whose updates are zero)."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def test_fm_train_step_matches_jax(params):
    """One fm step at t_shift 2 with CFG dropout: JAX's own step (its draws
    from the key), against the port's step on those draws."""
    r = np.random.default_rng(5)
    x0 = r.uniform(size=(4, SIZE, SIZE, 1)).astype(np.float32)
    y_cat = r.integers(0, 4, size=(4,)).astype(np.int32)
    y_cont = r.normal(size=(4, 4)).astype(np.float32)
    key = jax.random.key(21)
    sde_j, sde_t = jm.VPSDE(0.1, 30.0), tm.VPSDE(0.1, 30.0)
    jstep = jax_make_sde_train_step(jm.CondUNetTiny(**KW), _capture_grads(), sde_j, 4, 0.5, 1.0,
                                    0.0, parameterization="fm", t_shift=2.0)
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, params), _capture_grads())
    jstate, jloss = jstep(jstate, jnp.asarray(x0), jnp.asarray(y_cat), jnp.asarray(y_cont), key)
    want = torch_state_dict_from_flax(jax.tree.map(np.asarray, jstate.opt_state))
    t, eps, yc, yv = jm.draw_diffusion_loss_noise(jnp.asarray(x0), jnp.asarray(y_cat),
                                                  jnp.asarray(y_cont), key, 4, 0.5, 1.0, 2.0)

    tmodel = tm.CondUNetTiny(**KW)
    load_flax_params(tmodel, params)
    tx = CaptureGrads(0.0)
    tstate = ts.create_train_state(tmodel, tx)
    step = make_sde_train_step(tmodel, tx, sde_t, 4, 0.5, 1.0, 0.0, parameterization="fm",
                               t_shift=2.0)
    _, loss = step(tstate, torch.tensor(x0), torch.tensor(np.asarray(yc)),
                   torch.tensor(np.asarray(yv)),
                   noise=(torch.tensor(np.asarray(t)), torch.tensor(np.asarray(eps))))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
    grads = dict(zip(tstate.params, tx.seen[0]))
    assert set(grads) == set(want)
    for k, g in grads.items():
        lim = 1e-5 + 2e-3 * max(float(np.abs(want[k]).max()), 1e-3)
        np.testing.assert_allclose(g.numpy(), want[k], atol=lim, rtol=0, err_msg=k)


CFG = dict(KW, cond_ch=8, time_ch=8, img_size=SIZE)


def test_service_resolves_rf_for_fm_checkpoints(params):
    s = serve.ScoreModelService(dict(CFG, param="fm", fm_shift=2.0), params, device="cpu",
                                buckets=(2,))
    assert (s.sampler_name, s.steps, s.guidance_scale, s.t_end) == ("rf", 50, 1.5, 0.005)
    assert s._sampler_fn is sample_rectified_flow and s._extra_kw == {"t_shift": 2.0}
    assert s._apply_fn is s.model
    plain = serve.ScoreModelService(dict(CFG, param="fm"), params, device="cpu", steps=2)
    assert plain._extra_kw == {}
    x = plain.sample_conditions([0, 3], [0.1, 0.4], seed=2)
    assert x.shape == (2, SIZE, SIZE, 1) and np.isfinite(x).all()
    np.testing.assert_array_equal(x, plain.sample_conditions([0, 3], [0.1, 0.4], seed=2))


@pytest.mark.parametrize("cfg, sampler, match", [
    ({"param": "fm"}, "sde", "rectified flow"), ({"param": "fm"}, "ddim", "rectified flow"),
    ({}, "rf", "velocity field"), ({"param": "v"}, "rf", "velocity field")])
def test_service_refuses_a_sampler_that_does_not_match_the_checkpoint(params, cfg, sampler,
                                                                      match):
    with pytest.raises(ValueError, match=match):
        serve.ScoreModelService(dict(CFG, **cfg), params, device="cpu", sampler=sampler)


def test_cli_trains_fm_and_samples_rf_and_jax_reads_it(tmp_path):
    run = tmp_path / "run"
    out = train_cli.train(TINY + ["--epochs", "1", "--param", "fm", "--fm-shift", "2.0",
                                  "--sample-every", "1", "--sample-steps", "2",
                                  "--out-dir", str(run)])
    assert (out.config["param"], out.config["fm_shift"]) == ("fm", 2.0)
    assert np.isfinite(out.loss_hist).all()
    assert (run / "results" / "sde_samples_epoch_001.png").exists()  # the rf grid
    res = sample_cli.sample(["--device", "cpu", "--out-dir", str(run), "--steps", "2",
                             "--n", "4"])
    assert res.sampler == "rf" and "samplerrf" in res.out_path
    heun = sample_cli.sample(["--device", "cpu", "--out-dir", str(run), "--sampler", "rf",
                              "--rf-solver", "heun", "--steps", "2", "--n", "4"])
    assert heun.x.shape == (4, SIZE, SIZE, 1) and not np.array_equal(heun.x, res.x)
    with pytest.raises(SystemExit, match="--sampler rf"):
        sample_cli.sample(["--device", "cpu", "--out-dir", str(run), "--sampler", "sde"])
    # the JAX service reads the port's fm checkpoint as an rf model on its shift
    jsvc = JaxService(str(run / "checkpoints" / "sde_score_model_last.msgpack"))
    assert (jsvc.sampler_name, jsvc.steps, jsvc._extra_kw) == ("rf", 50, {"t_shift": 2.0})


def test_cli_refuses_rf_on_vp_checkpoints_and_fm_only_flags(tmp_path):
    run = tmp_path / "run"
    train_cli.train(TINY + ["--epochs", "1", "--out-dir", str(run)])
    with pytest.raises(SystemExit, match="rectified-flow velocity field"):
        sample_cli.sample(["--device", "cpu", "--out-dir", str(run), "--sampler", "rf"])
    with pytest.raises(SystemExit, match="--fm-shift"):
        train_cli.train(TINY + ["--epochs", "1", "--fm-shift", "2.0",
                                "--out-dir", str(tmp_path / "b")])
    with pytest.raises(SystemExit, match="--min-snr-gamma"):
        train_cli.train(TINY + ["--epochs", "1", "--param", "fm", "--min-snr-gamma", "5",
                                "--out-dir", str(tmp_path / "c")])
