"""Progressive distillation of the score model into a few-step sampler.

Counterpart of toycrystals_tpu/train/distill.py (Salimans & Ho 2022, with
the guided-teacher variant of Meng et al. 2023): one phase halves the DDIM
step count. At a grid step t_i -> t_{i+1} of its own N-step quadratic grid
the student learns to reproduce in ONE deterministic DDIM step what the
teacher does in TWO on the nested 2N grid (grid(2N)[2i] == grid(N)[i]), each
teacher evaluation CFG-combined at the distilled guidance, so the student
samples with one conditional pass per step. Students train in
v-parameterization; teachers are eps (the reference's) or v (every later
phase).

The teacher is a frozen module run under `torch.no_grad` (two doubled-batch
forwards per step); the student's loss is a v-space MSE, its update the
optimizer of train/state.py, with an optional EMA. The epoch is
train/steps.py's loop over batches rendered (or gathered) on the device.
On a data mesh the teacher is whole on every rank and the student is the
module that `parallel.place_state` returns; each rank trains its rows of
the global batch (train/steps.py).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from toycrystals_torch.models.sde_score_model import (
    VPSDE,
    ApplyFn,
    _quadratic_grid,
    predict_eps_cfg,
)
from toycrystals_torch.utils.rng import randint, randn
from toycrystals_torch.train.state import Optimizer, TrainState, ema_update
from toycrystals_torch.train.steps import (
    _batch_source,
    _make_epoch,
    _rows_generator,
    accumulate_grads,
    check_placed,
    mesh_metrics,
)


def _at(f, t: torch.Tensor) -> torch.Tensor:
    return f(t).reshape(-1, 1, 1, 1)


def ddim_step_from_raw(sde: VPSDE, x_t, t, t_next, raw, prediction: str) -> torch.Tensor:
    """One deterministic DDIM step t -> t_next from the net's raw output,
    x_s = alpha_s x0_hat + sigma_s eps_hat, written so nothing divides by
    alpha: v reads (x0, eps) off the exact identities; eps uses the
    alpha-ratio form. t, t_next: [B]; x_t, raw: [B, H, W, 1]."""
    a_t, s_t = _at(sde.alpha, t), _at(sde.sigma, t)
    a_n, s_n = _at(sde.alpha, t_next), _at(sde.sigma, t_next)
    if prediction == "v":
        x0 = a_t * x_t - s_t * raw
        eps = s_t * x_t + a_t * raw
        return a_n * x0 + s_n * eps
    return (a_n / a_t.clamp(min=1e-6)) * (x_t - s_t * raw) + s_n * raw


def pd_target_x0(sde: VPSDE, x_t, t, t_next, x_next) -> torch.Tensor:
    """The x0 for which one DDIM step from x_t lands on x_next: solve x_next
    = alpha_n x0 + (sigma_n / sigma_t)(x_t - alpha_t x0) for x0 (Salimans &
    Ho 2022, algorithm 2). The denominator sigma_n (SNR_n^1/2 - SNR_t^1/2)
    is positive whenever t_next < t."""
    a_t, s_t = _at(sde.alpha, t), _at(sde.sigma, t)
    a_n, s_n = _at(sde.alpha, t_next), _at(sde.sigma, t_next)
    ratio = s_n / s_t
    return (x_next - ratio * x_t) / (a_n - ratio * a_t).clamp(min=1e-8)


def make_distill_train_step(student: nn.Module, teacher_apply: ApplyFn, tx: Optimizer,
                            sde: VPSDE, n_student_steps: int, *, n_types: int,
                            guidance_scale: float, teacher_prediction: str = "eps",
                            t_end: float = 1e-3, ema_decay: float = 0.0,
                            mesh=None) -> Callable:
    """Returns step(state, x0, y_cat, y_cont, generator=None, noise=None) ->
    (state, loss); `state` (of `create_train_state(student, tx, ...)`) is
    updated in place.

    Per sample: a grid index i ~ U{0..N-1} and eps ~ N(0, I) from
    `generator` (noise=(i, eps) replaces the draw), x_t = alpha x0 + sigma
    eps at t = grid_N[i]; the teacher's two guided DDIM half-steps on the
    nested 2N grid give x_next; the one-step map is inverted for the x0
    target, and the student's v output regresses on the equivalent v target
    (v-space MSE). `teacher_apply` is called under `torch.no_grad`. On a
    `mesh` the batch is this rank's rows and `loss` the global mean."""
    check_placed(student, mesh)
    if teacher_prediction not in ("eps", "v"):
        raise ValueError(f"teacher_prediction must be eps|v, got {teacher_prediction}")
    n = int(n_student_steps)
    gs = float(guidance_scale)
    device = next(student.parameters()).device
    ts_s = _quadratic_grid(n, t_end, device)        # N + 1 points, the student's grid
    ts_t = _quadratic_grid(2 * n, t_end, device)    # nested: ts_t[2i] == ts_s[i]

    def step(state: TrainState, x0, y_cat, y_cont, generator: torch.Generator | None = None,
             noise=None):
        b = x0.shape[0]
        if noise is not None:
            i, eps = noise
        elif generator is None:
            raise ValueError("pass a torch.Generator (or noise=(i, eps)); the step never "
                             "draws from the global generator")
        else:
            generator = _rows_generator(mesh, generator, b)
            i = randint(n, (b,), generator, device)
            eps = randn(x0.shape, generator, device)
        i = i.long()
        t, t_mid, t_next = ts_s[i], ts_t[2 * i + 1], ts_s[i + 1]
        x0 = x0 * 2.0 - 1.0
        a_t, s_t = _at(sde.alpha, t), _at(sde.sigma, t)
        x_t = a_t * x0 + s_t * eps

        with torch.no_grad():
            # the teacher: two guided DDIM half-steps, frozen
            r1 = predict_eps_cfg(teacher_apply, x_t, t, y_cat, y_cont, gs, n_types)
            x_mid = ddim_step_from_raw(sde, x_t, t, t_mid, r1, teacher_prediction)
            r2 = predict_eps_cfg(teacher_apply, x_mid, t_mid, y_cat, y_cont, gs, n_types)
            x_next = ddim_step_from_raw(sde, x_mid, t_mid, t_next, r2, teacher_prediction)
            x0_tgt = pd_target_x0(sde, x_t, t, t_next, x_next)
            # v = alpha eps - sigma x0 with eps = (x_t - alpha x0) / sigma
            v_tgt = (a_t / s_t) * x_t - ((a_t * a_t + s_t * s_t) / s_t) * x0_tgt

        loss, grads = accumulate_grads(
            student, lambda _c: ((student(x_t, t, y_cat, y_cont).float() - v_tgt) ** 2).mean(),
            1, mesh)
        applied = tx.update(list(state.params.values()), grads, state.opt_state)
        if applied and state.ema_params is not None:
            ema_update(state.ema_params, state.params, ema_decay)
        state.step += 1
        return state, mesh_metrics(mesh, loss)

    return step


def make_distill_train_epoch(student: nn.Module, teacher_apply: ApplyFn, tx: Optimizer,
                             sde: VPSDE, n_student_steps: int, *, n_types: int,
                             guidance_scale: float, batch_size: int, n_items: int,
                             teacher_prediction: str = "eps", t_end: float = 1e-3,
                             ema_decay: float = 0.0, lattice_cfg=None, dataset_seed: int = 0,
                             resident: tuple | None = None, mesh=None) -> Callable:
    """A whole distillation epoch: shuffle (drop-last), each step's batch
    from the data source (train/steps.py `_batch_source`) on the student's
    device, then the distillation step. Returns epoch(state, generator) ->
    (state, mean_loss); `generator` drives the shuffle and every draw. On a
    `mesh` (`batch_size` global) each rank trains its rows of every batch."""
    step_fn = make_distill_train_step(
        student, teacher_apply, tx, sde, n_student_steps, n_types=n_types,
        guidance_scale=guidance_scale, teacher_prediction=teacher_prediction, t_end=t_end,
        ema_decay=ema_decay, mesh=mesh)
    device = next(student.parameters()).device
    get_batch = _batch_source(lattice_cfg, dataset_seed, resident, device)
    return _make_epoch(step_fn, get_batch, n_items, batch_size, device, torch.mean, mesh)
