"""Progressive distillation in the port (toycrystals_torch/train/distill.py,
scripts/distill_sde_score_model.py) against the JAX package on the CPU, at
base_ch 8.

Tolerances: the DDIM step and the target inversion within 1e-5 relative (f32
arithmetic in another order); the distillation loss within 2e-5 relative and
every gradient leaf within 1e-5 + 2e-3 of the leaf's largest entry (the
limits of tests/test_torch_train_step.py, plus 1e-6 of the step's largest
gradient), on JAX's own (i, eps) draws;
DDIM samples of a student through either package's service within 2e-5 on
the same initial noise. Everything else is exact.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from toycrystals_torch import serve
from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.scripts import distill_sde_score_model as distill_cli
from toycrystals_torch.scripts import train_sde_score_model as train_cli
from toycrystals_torch.train import distill as td
from toycrystals_torch.train import state as ts
from toycrystals_torch.utils import checkpoint as tck
from toycrystals_torch.utils.params import load_flax_params, torch_state_dict_from_flax
from toycrystals_tpu.models import sde_score_model as jm
from toycrystals_tpu.serve import ScoreModelService as JaxService
from toycrystals_tpu.train import distill as jd
from toycrystals_tpu.train.state import create_train_state as jax_create_train_state
from toycrystals_tpu.utils import checkpoint as jck

KW = dict(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16)
SIZE = 16
STUDENT_KEYS = {"param": "v", "distilled": True, "distill_cfg": 1.5, "distill_t_end": 0.005}


def _params(seed):
    args = (jnp.zeros((2, SIZE, SIZE, 1)), jnp.zeros((2,)), jnp.zeros((2,), jnp.int32),
            jnp.zeros((2, 4)))
    return jax.tree.map(np.asarray,
                        jm.CondUNetTiny(**KW).init(jax.random.key(seed), *args)["params"])


@pytest.fixture(scope="module")
def teacher_and_student():
    return _params(3), _params(4)


@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_ddim_step_and_target_inversion_match_jax(prediction):
    r = np.random.default_rng(0)
    x_t, raw = (r.normal(size=(5, 4, 4, 1)).astype(np.float32) for _ in range(2))
    t = np.array([1.0, 0.8, 0.5, 0.2, 0.05], np.float32)
    t_next = (t * 0.6).astype(np.float32)
    jsde, tsde = jm.VPSDE(0.1, 30.0, -1.0), tm.VPSDE(0.1, 30.0, -1.0)
    want = jd.ddim_step_from_raw(jsde, jnp.asarray(x_t), jnp.asarray(t), jnp.asarray(t_next),
                                 jnp.asarray(raw), prediction)
    got = td.ddim_step_from_raw(tsde, torch.tensor(x_t), torch.tensor(t), torch.tensor(t_next),
                                torch.tensor(raw), prediction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    want_x0 = jd.pd_target_x0(jsde, jnp.asarray(x_t), jnp.asarray(t), jnp.asarray(t_next), want)
    got_x0 = td.pd_target_x0(tsde, torch.tensor(x_t), torch.tensor(t), torch.tensor(t_next), got)
    np.testing.assert_allclose(got_x0.numpy(), np.asarray(want_x0), rtol=1e-5, atol=1e-5)
    if prediction == "v":
        # inverting the one-step map of x0_hat gives x0_hat back
        a, s = tsde.alpha(torch.tensor(t)), tsde.sigma(torch.tensor(t))
        x0_hat = a.reshape(-1, 1, 1, 1) * torch.tensor(x_t) - s.reshape(-1, 1, 1, 1) * \
            torch.tensor(raw)
        np.testing.assert_allclose(got_x0.numpy(), x0_hat.numpy(), rtol=1e-4, atol=1e-4)


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


@pytest.mark.parametrize("teacher_prediction, cfg", [("eps", 1.5), ("v", 1.5), ("v", 0.0)])
def test_distill_step_loss_and_gradients_match_jax(teacher_and_student, teacher_prediction,
                                                   cfg):
    """JAX's own step (its (i, eps) drawn from the key), against the port's
    step fed those draws: split(key), then randint and normal."""
    tparams, sparams = teacher_and_student
    r = np.random.default_rng(1)
    b, n = 4, 4
    x0 = r.uniform(size=(b, SIZE, SIZE, 1)).astype(np.float32)
    y_cat = r.integers(0, 4, size=(b,)).astype(np.int32)
    y_cont = r.normal(size=(b, 4)).astype(np.float32)
    key = jax.random.key(17)
    jsde, tsde = jm.VPSDE(0.1, 30.0), tm.VPSDE(0.1, 30.0)
    jmodel = jm.CondUNetTiny(**KW)
    apply_fn = lambda prm, x, t, yc, yv: jmodel.apply({"params": prm}, x, t, yc, yv)  # noqa: E731
    jstep = jd.make_distill_train_step(jmodel, apply_fn, jax.tree.map(jnp.asarray, tparams),
                                       _capture_grads(), jsde, n, n_types=4,
                                       guidance_scale=cfg, teacher_prediction=teacher_prediction,
                                       t_end=0.005)
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, sparams), _capture_grads())
    jstate, jloss = jstep(jstate, jnp.asarray(x0), jnp.asarray(y_cat), jnp.asarray(y_cont), key)
    want = torch_state_dict_from_flax(jax.tree.map(np.asarray, jstate.opt_state))
    k_i, k_eps = jax.random.split(key)
    i = np.asarray(jax.random.randint(k_i, (b,), 0, n))
    eps = np.asarray(jax.random.normal(k_eps, x0.shape, jnp.float32))

    teacher, student = tm.CondUNetTiny(**KW), tm.CondUNetTiny(**KW)
    load_flax_params(teacher, tparams)
    load_flax_params(student, sparams)
    teacher.eval().requires_grad_(False)
    tx = CaptureGrads(0.0)
    state = ts.create_train_state(student, tx)
    step = td.make_distill_train_step(student, teacher, tx, tsde, n, n_types=4,
                                      guidance_scale=cfg, teacher_prediction=teacher_prediction,
                                      t_end=0.005)
    state, loss = step(state, torch.tensor(x0), torch.tensor(y_cat), torch.tensor(y_cont),
                       noise=(torch.tensor(i), torch.tensor(eps)))
    assert state.step == 1 and loss.dim() == 0 and not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
    grads = dict(zip(state.params, tx.seen[0]))
    assert set(grads) == set(want)
    # an eps teacher with random weights makes huge targets at t = 1 (the
    # alpha-ratio step multiplies by alpha_n / alpha_1 ~ 1e2-1e3): there the
    # leaves whose gradients are at rounding-noise level of the step's largest
    # gradient (time and condition embeddings, conv biases ahead of a
    # GroupNorm) are held to 1e-6 of that largest gradient as well
    floor = 1e-6 * max(float(np.abs(w).max()) for w in want.values())
    for k, g in grads.items():
        lim = 1e-5 + 2e-3 * max(float(np.abs(want[k]).max()), 1e-3) + floor
        np.testing.assert_allclose(g.numpy(), want[k], atol=lim, rtol=0, err_msg=k)
    assert all(p.grad is None for p in teacher.parameters())


def test_distill_epoch_draws_from_its_generator_and_updates_the_ema(teacher_and_student):
    tparams, _ = teacher_and_student
    from toycrystals_torch.data.lattice import LatticeConfig

    def run():
        teacher, student = tm.CondUNetTiny(**KW), tm.CondUNetTiny(**KW)
        load_flax_params(teacher, tparams)
        load_flax_params(student, tparams)
        teacher.eval().requires_grad_(False)
        tx = ts.Optimizer(1e-3)
        state = ts.create_train_state(student, tx, ema=True)
        epoch = td.make_distill_train_epoch(
            student, teacher, tx, tm.VPSDE(0.1, 30.0), 2, n_types=4, guidance_scale=1.5,
            batch_size=4, n_items=12, ema_decay=0.5,
            lattice_cfg=LatticeConfig(img_size=SIZE, rot_only=True))
        return epoch(state, torch.Generator().manual_seed(3))

    (s1, l1), (s2, l2) = run(), run()
    assert s1.step == 3 and torch.isfinite(l1) and float(l1) == float(l2)
    assert all(torch.equal(s1.ema_params[k], s2.ema_params[k]) for k in s1.ema_params)
    assert any(not torch.equal(s1.ema_params[k], s1.params[k]) for k in s1.params)


def _teacher_ckpt(tmp_path, param="eps"):
    run = tmp_path / "teacher"
    train_cli.train(["--device", "cpu", "--procedural", "--img-size", str(SIZE), "--base-ch",
                     "8", "--emb-dim", "16", "--n-samples", "16", "--batch-size", "16",
                     "--epochs", "1", "--sample-every", "0", "--param", param,
                     "--ema-decay", "0.9", "--out-dir", str(run)])
    return str(run / "checkpoints" / "sde_score_model_last.msgpack")


DISTILL = ["--device", "cpu", "--from-steps", "4", "--to-steps", "2", "--epochs", "1",
           "--n-samples", "16", "--batch-size", "8", "--grid-n", "4"]


def test_distill_cli_end_to_end(tmp_path, capsys):
    teacher = _teacher_ckpt(tmp_path)
    out_dir = tmp_path / "d"
    run = distill_cli.distill(DISTILL + ["--teacher", teacher, "--out-dir", str(out_dir)])
    assert "WARNING: eps-parameterized teacher" in capsys.readouterr().out
    assert run.schedule == [4, 2] and not run.preempted
    with open(out_dir / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [(r["phase"], r["steps"], r["epoch"]) for r in rows] == [(0, 4, 1), (1, 2, 1)]
    with open(out_dir / "distill_summary.jsonl") as f:
        summary = [json.loads(line) for line in f]
    assert [s["steps"] for s in summary] == [4, 2] and summary == run.summary
    for s in summary:
        assert all(np.isfinite(s[k]) for k in ("final_loss", "type_acc", "type_acc_merged01",
                                               "theta_mae_deg", "cond_fidelity"))
    teacher_cfg = tck.load_score_payload(teacher)["config"]
    for n in (4, 2):
        assert (out_dir / "results" / f"ddim_{n}step.png").exists()
        raw = tck.load_checkpoint(out_dir / "checkpoints" / f"distilled_{n}step.msgpack")
        cfg = raw["config"]
        assert {k: cfg[k] for k in STUDENT_KEYS} == STUDENT_KEYS
        assert cfg["distill_steps"] == n and cfg["distill_teacher"] == os.path.abspath(teacher)
        assert cfg["base_ch"] == teacher_cfg["base_ch"] and raw["epoch_next"] == 1
        assert raw["state"]["ema_params"] is None and int(raw["state"]["step"]) == 2
    # the students serve through the DDIM path at their trained steps
    svc = serve.ScoreModelService.from_checkpoint(
        str(out_dir / "checkpoints" / "distilled_2step.msgpack"), device="cpu")
    assert (svc.sampler_name, svc.steps, svc.guidance_scale) == ("ddim", 2, 0.0)
    x = svc.sample_conditions([0, 1, 2], seed=1)
    assert x.shape == (3, SIZE, SIZE, 1) and np.isfinite(x).all()


def test_students_cross_load_between_the_packages(tmp_path, teacher_and_student):
    """A port student in the JAX service and a JAX student in the port's:
    the same DDIM samples on the same initial noise."""
    teacher = _teacher_ckpt(tmp_path, param="v")
    out_dir = tmp_path / "d"
    distill_cli.distill(DISTILL + ["--teacher", teacher, "--to-steps", "4", "--grid-n", "0",
                                   "--ema-decay", "0.5", "--out-dir", str(out_dir)])
    port_student = str(out_dir / "checkpoints" / "distilled_4step.msgpack")
    _, sparams = teacher_and_student
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, sparams), optax.adam(1e-3))
    jax_student = str(tmp_path / "jax_student.msgpack")
    jck.save_checkpoint(jax_student, {
        "epoch_next": 1, "state": jstate, "loss_hist": [0.1],
        "config": dict(KW, cond_ch=8, time_ch=8, img_size=SIZE, beta_min=0.1, beta_max=30.0,
                       dtype="float32", stem="none", **STUDENT_KEYS, distill_steps=2,
                       distill_teacher="t.msgpack")})
    b = 3
    y_cat = np.array([0, 1, 3], np.int32)
    y_cont = np.zeros((b, 4), np.float32)
    y_cont[:, 1] = [0.2, 0.4, 0.8]
    key = jax.random.key(5)
    noise = np.asarray(jax.random.normal(key, (b, SIZE, SIZE, 1), jnp.float32))
    for path, steps in ((port_student, 4), (jax_student, 2)):
        jsvc = JaxService(path)
        tsvc = serve.ScoreModelService.from_checkpoint(path, device="cpu")
        for s in (jsvc, tsvc):
            assert (s.sampler_name, s.steps, s.guidance_scale, s.t_end) == \
                ("ddim", steps, 0.0, 0.005)
        jmodel = jsvc.model
        want = jm.sample_ddim(lambda prm, x, t, yc, yv: jmodel.apply({"params": prm}, x, t, yc,
                                                                    yv),
                              jsvc.params, jsvc.sde, jnp.asarray(y_cat), jnp.asarray(y_cont),
                              (b, SIZE, SIZE, 1), key, n_steps=steps, guidance_scale=0.0,
                              t_end=0.005, n_types=4, prediction="v")
        got = tm.sample_ddim(tsvc._apply_fn, tsvc.sde, torch.tensor(y_cat), torch.tensor(y_cont),
                             (b, SIZE, SIZE, 1), n_steps=steps, t_end=0.005, n_types=4,
                             noise=noise, **tsvc._extra_kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_preemption_saves_the_partial_student(tmp_path, monkeypatch):
    class Stop:
        requested, signame = True, "SIGTERM"

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(distill_cli, "GracefulShutdown", Stop)
    teacher = _teacher_ckpt(tmp_path, param="v")
    run = distill_cli.distill(DISTILL + ["--teacher", teacher, "--out-dir", str(tmp_path / "d")])
    assert run.preempted and run.checkpoints == [
        str(tmp_path / "d" / "checkpoints" / "distilled_4step.msgpack")]
    raw = tck.load_checkpoint(run.checkpoints[0])
    assert raw["config"]["distill_steps"] == 4 and raw["epoch_next"] == 1
    assert not (tmp_path / "d" / "results" / "ddim_4step.png").exists()


def test_refusals(tmp_path, monkeypatch):
    fm = _teacher_ckpt(tmp_path, param="fm")
    with pytest.raises(SystemExit, match="--param fm"):
        distill_cli.distill(DISTILL + ["--teacher", fm, "--out-dir", str(tmp_path / "a")])
    v = _teacher_ckpt(tmp_path / "v", param="v")
    with pytest.raises(SystemExit, match="powers of 2"):
        distill_cli.distill(DISTILL + ["--teacher", v, "--from-steps", "6"])
    with pytest.raises(SystemExit, match="batch size 8 not divisible by --shard 3"):
        distill_cli.distill(DISTILL + ["--teacher", v, "--shard", "3"])
    with pytest.raises(ValueError, match="teacher_prediction"):
        td.make_distill_train_step(tm.CondUNetTiny(**KW), None, ts.Optimizer(1e-3),
                                   tm.VPSDE(), 2, n_types=4, guidance_scale=0.0,
                                   teacher_prediction="fm")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        distill_cli.distill(["--teacher", fm])
