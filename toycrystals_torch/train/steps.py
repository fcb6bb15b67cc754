"""Train step and epoch of the VP-SDE score model.

Counterpart of `make_sde_train_step` and `make_sde_train_epoch` in
toycrystals_tpu/train/steps.py: `diffusion_loss_eps` with CFG conditioning
dropout, gradient accumulation that draws (t, eps) once for the whole batch,
the optimizer of train/state.py, and the EMA lerp inside the step. The epoch
is a Python loop over steps with the batches rendered (or gathered) on the
model's device; nothing returns to the host inside it unless the optimizer
checks for non-finite gradients.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from toycrystals_torch.models.sde_score_model import (
    VPSDE,
    diffusion_loss_eps_given,
    draw_diffusion_loss_noise,
)
from toycrystals_torch.train.state import Optimizer, TrainState, ema_update


def sde_loss_and_grads(model: nn.Module, sde: VPSDE, x0, y_cat, y_cont, t, eps,
                       parameterization: str = "eps", min_snr_gamma: float = 0.0,
                       grad_accum: int = 1) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Loss at the given (t, eps) and its gradient for every parameter of
    `model`, in `model.parameters()` order. grad_accum k > 1 runs k chunks of
    the batch one after the other and averages, which equals the unsplit
    batch (mean of equal-sized chunk means) at 1/k of the activations."""
    params = list(model.parameters())
    b, k = x0.shape[0], max(int(grad_accum), 1)
    if b % k:
        raise ValueError(f"batch {b} not divisible by grad_accum {k}")
    loss_sum, grad_sum = None, None
    for c in range(k):
        sl = slice(c * (b // k), (c + 1) * (b // k))
        loss = diffusion_loss_eps_given(model, sde, x0[sl], y_cat[sl], y_cont[sl], t[sl],
                                        eps[sl], parameterization, min_snr_gamma)
        grads = list(torch.autograd.grad(loss, params))
        if grad_sum is None:
            loss_sum, grad_sum = loss.detach(), grads
        else:
            loss_sum = loss_sum + loss.detach()
            torch._foreach_add_(grad_sum, grads)
    if k > 1:
        loss_sum = loss_sum / k
        torch._foreach_div_(grad_sum, float(k))
    return loss_sum, grad_sum


def make_sde_train_step(model: nn.Module, tx: Optimizer, sde: VPSDE, n_types: int,
                        p_uncond: float, t_power: float, ema_decay: float,
                        parameterization: str = "eps", grad_accum: int = 1,
                        t_shift: float = 1.0, min_snr_gamma: float = 0.0) -> Callable:
    """Returns step(state, x0, y_cat, y_cont, generator=None, noise=None) ->
    (state, loss). `state` (of `create_train_state(model, tx, ...)`) is
    updated in place and returned; `loss` is a 0-d tensor on the device.

    The step draws (t, eps) and the conditioning dropout from `generator`
    (on x0's device). noise=(t, eps) replaces the draw; the conditioning is
    then taken as given (tests inject JAX's draws). On a step the optimizer
    skips as non-finite, neither the parameters nor the EMA move.
    """

    def step(state: TrainState, x0, y_cat, y_cont, generator: torch.Generator | None = None,
             noise=None):
        if noise is not None:
            t, eps = noise
        elif generator is None:
            raise ValueError("pass a torch.Generator (or noise=(t, eps)); the step never "
                             "draws from the global generator")
        else:
            t, eps, y_cat, y_cont = draw_diffusion_loss_noise(
                x0, y_cat, y_cont, generator, n_types, p_uncond, t_power, t_shift)
        loss, grads = sde_loss_and_grads(model, sde, x0, y_cat, y_cont, t, eps,
                                         parameterization, min_snr_gamma, grad_accum)
        applied = tx.update(list(state.params.values()), grads, state.opt_state)
        if applied and state.ema_params is not None:
            ema_update(state.ema_params, state.params, ema_decay)
        state.step += 1
        return state, loss

    return step


def _batch_source(lattice_cfg, dataset_seed: int, resident: tuple | None, device) -> Callable:
    """get_batch(idx) -> (x, y_cat, y_cont) on `device`, from exactly one of
    lattice_cfg (procedural: rendered per step from (dataset_seed, idx), the
    same items as the indexable dataset) and resident (x_u8 [N, H, W, 1] u8,
    y_cat [N] i32, y_cont [N, 4] f32 tensors on the device, gathered and
    decoded u8 -> f32 / 255 per step)."""
    if (lattice_cfg is None) == (resident is None):
        raise ValueError("pass exactly one of lattice_cfg / resident")
    if lattice_cfg is not None:
        from toycrystals_torch.data.datasets import generate_batch
        from toycrystals_torch.data.lattice import static_point_budget

        budget = static_point_budget(lattice_cfg)
        return lambda idx: generate_batch(lattice_cfg, dataset_seed, idx, budget, device)
    x_u8, y_cat, y_cont = resident
    return lambda idx: (x_u8[idx].to(torch.float32) / 255.0, y_cat[idx], y_cont[idx])


def make_sde_train_epoch(model: nn.Module, tx: Optimizer, sde: VPSDE, n_types: int,
                         p_uncond: float, t_power: float, ema_decay: float, batch_size: int,
                         n_items: int, lattice_cfg=None, dataset_seed: int = 0,
                         resident: tuple | None = None, mesh=None,
                         parameterization: str = "eps", grad_accum: int = 1,
                         nan_safe_metrics: bool = False, t_shift: float = 1.0,
                         min_snr_gamma: float = 0.0, fresh_data: bool = False) -> Callable:
    """A whole SDE training epoch: shuffle (drop-last), per-step batch from
    the data source (`_batch_source`) on the model's device, then the train
    step. Returns epoch_fn(state, generator, offset=0) -> (state, mean_loss).

    `generator` (on the model's device) drives the shuffle and every step's
    draws. `nan_safe_metrics` reports the nanmean over steps, to pair with an
    optimizer that skips non-finite steps. `fresh_data` (procedural source
    only) lets `offset` shift the item indices, so epoch e trains on items
    [e n, (e + 1) n) instead of the same n; offset 0 is the fixed dataset.
    """
    if mesh is not None:
        raise NotImplementedError("training on a mesh is not ported yet (ROADMAP.md, "
                                  "module 10, parallel axes)")
    if fresh_data and lattice_cfg is None:
        raise ValueError("fresh_data needs the procedural (lattice_cfg) source: a resident "
                         "archive has only n items")
    device = next(model.parameters()).device
    step_fn = make_sde_train_step(model, tx, sde, n_types, p_uncond, t_power, ema_decay,
                                  parameterization, grad_accum, t_shift, min_snr_gamma)
    get_batch = _batch_source(lattice_cfg, dataset_seed, resident, device)
    run_epoch = _make_epoch(step_fn, get_batch, n_items, batch_size, device,
                            torch.nanmean if nan_safe_metrics else torch.mean)

    def epoch_fn(state: TrainState, generator: torch.Generator, offset: int = 0):
        if offset and not fresh_data:
            raise ValueError("an index offset needs fresh_data=True")
        return run_epoch(state, generator, offset)

    return epoch_fn


def _make_epoch(step_fn: Callable, get_batch: Callable, n_items: int, batch_size: int, device,
                reduce: Callable) -> Callable:
    """epoch(state, generator, offset=0) -> (state, reduce(losses)): shuffle
    [0, n_items) with `generator` (drop-last), then one `step_fn(state, x0,
    y_cat, y_cont, generator)` per batch of `get_batch(idx + offset)`."""
    n_steps = n_items // batch_size
    if n_steps == 0:
        raise ValueError(f"n_items {n_items} < batch_size {batch_size}")

    def epoch_fn(state: TrainState, generator: torch.Generator, offset: int = 0):
        order = torch.randperm(n_items, generator=generator, device=device)
        order = order[: n_steps * batch_size].reshape(n_steps, batch_size)
        losses = []
        for idx in order:
            x0, y_cat, y_cont = get_batch(idx + offset)
            state, loss = step_fn(state, x0, y_cat, y_cont, generator)
            losses.append(loss)
        return state, reduce(torch.stack(losses))

    return epoch_fn
