"""Train steps and epochs of the VP-SDE score model, the VAE and the latent prior.

Counterpart of `make_sde_train_step` / `make_sde_train_epoch`,
`make_vae_train_step` / `make_vae_train_epoch` and `make_prior_train_step` /
`make_prior_train_epoch` in toycrystals_tpu/train/steps.py.

- SDE: `diffusion_loss_eps` with CFG conditioning dropout, gradient
  accumulation that draws (t, eps) once for the whole batch, the optimizer of
  train/state.py, and the EMA lerp inside the step.
- VAE: MSE reconstruction + beta_eff * the free-bits KL of models/vae.py,
  with the metrics loss, recon, kl and kl_raw, and the same optimizer.
- prior: t = clamp(int(u^2 T), 0, T - 1) (a bias to small t), q_sample, the
  eps-MSE per example, plus aux_weight x the mean over blocks of the MoE
  prior's load-balancing term; the metrics loss, aux and the 4-bucket-over-t
  bucket_sum / bucket_n, which the epoch sums.

An epoch is a Python loop over steps with the batches rendered (or gathered)
on the model's device; nothing returns to the host inside it unless the
optimizer checks for non-finite gradients.

On a data mesh (parallel/; `mesh=`), `model` is the module that
`parallel.place_state` returns (DistributedDataParallel or FSDP2). Every
rank shuffles and draws the whole batch's randomness from the same
generator and keeps its own rows (`utils.rng.RowGenerator`); the
gradients are averaged over the ranks, gradient accumulation syncs only on
its last micro-batch, and the metrics are reduced over the ranks, so each
rank reports the single-device run's values.

The SDE step and epoch also take a ("data", "space") mesh (parallel/spatial.py):
each rank then holds its rows of the batch and of the image height, draws the
global batch's eps and keeps both cuts of it, and runs its forward and
backward in the mesh's dispatch scope, where every exchange of rows has its
adjoint in the backward. The weights are replicated over both axes and DDP
averages the gradients over all D S ranks; each rank's loss is the mean over
its own pixels, so that average is the gradient of the global mean, as in
JAX's GSPMD step. Under --fsdp the same mesh runs HSDP (parallel/fsdp.py).

They, and the VAE's and the prior's steps and epochs, also take a ("data",
"model") mesh (parallel/tensor.py): each rank holds its rows of the batch,
the model ranks of a data coordinate the same rows and the same draws, and
its block of the sharded weights; the forward and backward run in the mesh's
dispatch scope, where every channel collective has its adjoint, and the loss
is the replicated output's, not summed over "model". DDP averages over the
"data" group (FSDP2 under --fsdp, its reduce-scatter over the same group),
and the whole leaves' gradients are then broadcast over "model" so that the
replicas keep the same bits. The SDE step and epoch also take JAX's 3-D
("data", "space", "model") mesh, which composes the two: x0 and eps cut by
rows and by height, the blocks of the model axis, and DDP (or HSDP under
--fsdp) over the D S ranks of the rank's model coordinate, which also
average the metrics. The prior's step and epoch also take ("data", "pipe")
and ("data", "expert") meshes (parallel/pipeline.py, parallel/expert.py),
whose placed modules reduce their own gradients. A mesh with any other axis
raises, as does a space axis in the other models' steps or a model axis in
the distillation step: JAX's CLIs build no such mesh.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch import nn

from toycrystals_torch.models.sde_score_model import (
    VPSDE,
    diffusion_loss_eps_given,
    draw_diffusion_loss_noise,
)
from toycrystals_torch.models.vae import kl_stats
from toycrystals_torch.parallel import spatial
from toycrystals_torch.parallel.fsdp import local, reduce_replicated_grads
from toycrystals_torch.parallel.mesh import (
    EXPERT,
    PIPE,
    SPACE,
    axis_size,
    check_data_mesh,
    mesh_axes,
    data_sharding,
    replica_group,
    row_generator,
)
from toycrystals_torch.parallel.tensor import sync_whole_grads
from toycrystals_torch.train.state import Optimizer, TrainState, ema_update
from toycrystals_torch.utils.rng import RowGenerator, rand, randn


def _is_fsdp(model: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def check_placed(model: nn.Module, mesh, space: bool = False, tp: bool = False,
                 pipe: bool = False, expert: bool = False) -> None:
    """On a mesh of several ranks, `model` must be the module that
    `parallel.place_state` returns: its gradients are then averaged. A
    ("data", "space") mesh only where `space` (the score model's steps), a
    ("data", "model") one only where `tp` (the score model's, the VAE's and
    the prior's), ("data", "pipe") and ("data", "expert") only where `pipe`
    and `expert` (the prior's: a `PipelineStage` or an `ExpertPlaced`)."""
    if mesh is None:
        return
    check_data_mesh(mesh, space, model=tp, pipe=pipe, expert=expert)
    axes = mesh_axes(mesh)
    if PIPE in axes or EXPERT in axes:
        from toycrystals_torch.parallel.expert import ExpertPlaced
        from toycrystals_torch.parallel.pipeline import PipelineStage

        want = PipelineStage if PIPE in axes else ExpertPlaced
        if not isinstance(model, want):
            raise ValueError(f"on a mesh with axes {axes}, train the {want.__name__} that "
                             f"parallel.place_state returns")
        return
    from torch.nn.parallel import DistributedDataParallel

    if mesh.size() > 1 and not isinstance(model, DistributedDataParallel) \
            and not _is_fsdp(model):
        raise ValueError("on a mesh, train the module that parallel.place_state returns "
                         "(DistributedDataParallel or FSDP2)")


@contextlib.contextmanager
def _grad_sync(model: nn.Module, sync: bool):
    """Run a backward that averages the gradients over the ranks only when
    `sync` (the last micro-batch); the others accumulate locally."""
    if sync:
        yield
        return
    from torch.nn.parallel import DistributedDataParallel

    if isinstance(model, DistributedDataParallel):
        with model.no_sync():
            yield
    elif _is_fsdp(model):
        model.set_requires_gradient_sync(False)
        try:
            yield
        finally:
            model.set_requires_gradient_sync(True)
    else:
        yield


def accumulate_grads(model: nn.Module, chunk_loss: Callable[[int], torch.Tensor], k: int = 1,
                     mesh=None) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The mean of `chunk_loss(c)` over c < k (detached) and the mean of
    their gradients for every parameter of `model`, in `model.parameters()`
    order: one backward per chunk, accumulated in `.grad`, which is cleared
    before and after. Under DistributedDataParallel or FSDP2 the last
    backward averages the gradients over the ranks (FSDP2's whole leaves
    too); the others do not communicate. A pipeline stage or the expert
    axis's module reduces its gradients after the backward
    (`reduce_grads`)."""
    if _is_fsdp(model):
        model.reshard()  # a forward without backward (sampling) leaves it gathered
    params = list(model.parameters())
    for p in params:
        p.grad = None
    loss_sum = None
    for c in range(k):
        with _grad_sync(model, c == k - 1):
            loss = chunk_loss(c)
            loss.backward()
        loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
    if _is_fsdp(model):
        reduce_replicated_grads(mesh, params)
    sync_whole_grads(mesh, params)
    if hasattr(model, "reduce_grads"):  # a pipeline stage, the expert axis: by hand
        model.reduce_grads()
    grads = [p.grad for p in params]
    for p in params:
        p.grad = None
    if k > 1:
        loss_sum = loss_sum / k
        torch._foreach_div_([local(g) for g in grads], float(k))
    return loss_sum, grads


def mesh_metrics(mesh, metrics, sums: tuple[str, ...] = ()):
    """A step's metrics (a tensor or a dict of tensors) reduced over the
    mesh in one all-reduce: the mean over the ranks (over "data" alone on a
    model axis, whose ranks hold the same loss), or the sum for the keys in
    `sums`. mesh=None, or one rank, returns them as they are."""
    if mesh is None or mesh.size() == 1:
        return metrics
    import torch.distributed as dist

    group, n = replica_group(mesh)
    items = metrics if isinstance(metrics, dict) else {"": metrics}
    flat = torch.cat([v.reshape(-1).float() for v in items.values()])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, i = {}, 0
    for k, v in items.items():
        part = flat[i:i + v.numel()].reshape(v.shape)
        out[k] = part if k in sums else part / n
        i += v.numel()
    return out if isinstance(metrics, dict) else out[""]


def _rows_generator(mesh, generator, local_rows: int, local_height: int | None = None):
    """On a mesh, a plain generator becomes the `RowGenerator` of this
    rank's rows of the global batch (and of the image height)."""
    if mesh is None or generator is None or isinstance(generator, RowGenerator):
        return generator
    return row_generator(mesh, generator, local_rows, local_height)


def sde_loss_and_grads(model: nn.Module, sde: VPSDE, x0, y_cat, y_cont, t, eps,
                       parameterization: str = "eps", min_snr_gamma: float = 0.0,
                       grad_accum: int = 1, mesh=None) -> tuple[torch.Tensor,
                                                                list[torch.Tensor]]:
    """Loss at the given (t, eps) and its gradient for every parameter of
    `model`, in `model.parameters()` order. grad_accum k > 1 runs k chunks of
    the batch one after the other and averages, which equals the unsplit
    batch (mean of equal-sized chunk means) at 1/k of the activations. On a
    mesh the rows are this rank's (and, with a space axis, its rows of the
    image height), the loss is this rank's mean and the gradients are
    averaged over the ranks (`accumulate_grads`); the forwards and backwards
    run in the mesh's dispatch scope."""
    b, k = x0.shape[0], max(int(grad_accum), 1)
    if b % k:
        raise ValueError(f"batch {b} not divisible by grad_accum {k}")
    m = b // k

    def chunk_loss(c: int) -> torch.Tensor:
        sl = slice(c * m, (c + 1) * m)
        return diffusion_loss_eps_given(model, sde, x0[sl], y_cat[sl], y_cont[sl], t[sl],
                                        eps[sl], parameterization, min_snr_gamma)

    with spatial.dispatch_scope(mesh):
        return accumulate_grads(model, chunk_loss, k, mesh)


def make_sde_train_step(model: nn.Module, tx: Optimizer, sde: VPSDE, n_types: int,
                        p_uncond: float, t_power: float, ema_decay: float,
                        parameterization: str = "eps", grad_accum: int = 1,
                        t_shift: float = 1.0, min_snr_gamma: float = 0.0,
                        mesh=None) -> Callable:
    """Returns step(state, x0, y_cat, y_cont, generator=None, noise=None) ->
    (state, loss). `state` (of `create_train_state(model, tx, ...)`) is
    updated in place and returned; `loss` is a 0-d tensor on the device.

    The step draws (t, eps) and the conditioning dropout from `generator`
    (on x0's device). noise=(t, eps) replaces the draw; the conditioning is
    then taken as given (tests inject JAX's draws). On a step the optimizer
    skips as non-finite, neither the parameters nor the EMA move. On a
    `mesh` the batch and `noise` are this rank's rows (and, with a space axis,
    its rows of the image height: x0 and eps [b, H / S, W, 1]), the
    generator's draws are the global batch's (module docstring) and `loss`
    is the global mean.
    """
    check_placed(model, mesh, space=True, tp=True)

    def step(state: TrainState, x0, y_cat, y_cont, generator: torch.Generator | None = None,
             noise=None):
        if noise is not None:
            t, eps = noise
        elif generator is None:
            raise ValueError("pass a torch.Generator (or noise=(t, eps)); the step never "
                             "draws from the global generator")
        else:
            t, eps, y_cat, y_cont = draw_diffusion_loss_noise(
                x0, y_cat, y_cont, _rows_generator(mesh, generator, *x0.shape[:2]), n_types,
                p_uncond, t_power, t_shift)
        loss, grads = sde_loss_and_grads(model, sde, x0, y_cat, y_cont, t, eps,
                                         parameterization, min_snr_gamma, grad_accum, mesh)
        applied = tx.update(list(state.params.values()), grads, state.opt_state)
        if applied and state.ema_params is not None:
            ema_update(state.ema_params, state.params, ema_decay)
        state.step += 1
        return state, mesh_metrics(mesh, loss)

    return step


def make_vae_train_step(model: nn.Module, tx: Optimizer, free_bits: float,
                        uncond: bool = False, mesh=None) -> Callable:
    """Returns step(state, x, y_cat, y_cont, beta_eff, generator=None,
    noise=None) -> (state, metrics): `state` (of `create_train_state(model,
    tx)`) updated in place, metrics 0-d device tensors `loss`, `recon`, `kl`
    (the free-bits KL in the loss) and `kl_raw`. beta_eff is the warmed-up KL
    weight beta * min(1, (epoch + 1) / 5) that the caller passes per epoch.

    The step draws the reparameterisation's eps and then (CondVAE, cond_drop
    > 0) the cond-drop mask from `generator`; noise=(eps [B, z_dim], keep
    [B, 1] or None) replaces the draws (tests inject JAX's). On a `mesh`, as
    `make_sde_train_step` says; the metrics are the global batch's."""
    check_placed(model, mesh, tp=True)

    def step(state: TrainState, x, y_cat, y_cont, beta_eff: float,
             generator: torch.Generator | None = None, noise=None):
        if noise is None and generator is None:
            raise ValueError("pass a torch.Generator (or noise=(eps, keep)); the step never "
                             "draws from the global generator")
        metrics, grads = vae_loss_and_grads(model, x, y_cat, y_cont, beta_eff, free_bits,
                                            uncond, _rows_generator(mesh, generator, x.shape[0]),
                                            noise, mesh)
        tx.update(list(state.params.values()), grads, state.opt_state)
        state.step += 1
        return state, mesh_metrics(mesh, metrics)

    return step


def vae_loss_and_grads(model: nn.Module, x, y_cat, y_cont, beta_eff: float, free_bits: float,
                       uncond: bool = False, generator: torch.Generator | None = None,
                       noise=None, mesh=None) -> tuple[dict[str, torch.Tensor],
                                                      list[torch.Tensor]]:
    """The VAE step's metrics (`loss`, `recon`, `kl`, `kl_raw`, detached, of
    this rank's rows) and the loss's gradient for every parameter of
    `model`, in `model.parameters()` order; the draws as
    `make_vae_train_step` says."""
    eps, keep = (None, None) if noise is None else noise
    out = {}

    def loss_fn(_c: int) -> torch.Tensor:
        if uncond:
            x_hat, mu, logvar = model(x, generator=generator, noise=eps)
        else:
            x_hat, mu, logvar = model(x, y_cat, y_cont, train=True, generator=generator,
                                      noise=eps, keep=keep)
        recon = ((x_hat - x) ** 2).mean()
        kl_used, kl_raw = kl_stats(mu, logvar, free_bits)
        out.update(recon=recon.detach(), kl=kl_used.detach(), kl_raw=kl_raw.detach())
        return recon + float(beta_eff) * kl_used

    with spatial.dispatch_scope(mesh):
        loss, grads = accumulate_grads(model, loss_fn, 1, mesh)
    return {"loss": loss, **out}, grads


def prior_loss_and_grads(model: nn.Module, sched, z0n, y_cat, y_cont, t, eps,
                         aux_weight: float = 0.0, mesh=None) -> tuple[dict[str, torch.Tensor],
                                                                      list[torch.Tensor]]:
    """The prior step's metrics at the given (t [B] int, eps [B, z]) and the
    loss's gradient for every parameter of `model`, in `model.parameters()`
    order. aux_weight > 0 (the MoE prior) adds aux_weight x the mean over
    blocks of the returned `moe_aux` terms; on a mesh those are formed from
    the global batch's route statistics (models/moe_prior.py)."""
    z_t = sched.q_sample(z0n, t, eps)
    out = {"aux": torch.zeros((), device=z0n.device)}

    def loss_fn(_c: int) -> torch.Tensor:
        if aux_weight:
            eps_pred, stats = model(z_t, t, y_cat, y_cont, return_stats=True, mesh=mesh)
            if stats["moe_aux"]:
                out["aux"] = torch.stack(stats["moe_aux"]).mean()
        else:
            eps_pred = model(z_t, t, y_cat, y_cont)
        out["per"] = ((eps_pred - eps) ** 2).mean(dim=1)  # [B]
        return out["per"].mean() + aux_weight * out["aux"]

    with spatial.dispatch_scope(mesh):
        loss, grads = accumulate_grads(model, loss_fn, 1, mesh)
    aux, per = out["aux"].detach(), out["per"].detach()
    q = ((t.to(torch.float32) / sched.T * 4).to(torch.int64)).clamp(0, 3)
    return ({"loss": loss, "aux": aux,
             "bucket_sum": torch.zeros(4, device=per.device).index_add_(0, q, per),
             "bucket_n": torch.zeros(4, device=per.device).index_add_(
                 0, q, torch.ones_like(per))}, grads)


def draw_prior_noise(z0n: torch.Tensor, T: int, generator: torch.Generator):
    """The prior step's draws from `generator`: u [B] then eps [B, z];
    t = clamp(int(u^2 T), 0, T - 1)."""
    u = rand((z0n.shape[0],), generator, z0n.device)
    t = (u * u * T).to(torch.int32).clamp(0, T - 1)
    return t, randn(z0n.shape, generator, z0n.device)


def make_prior_train_step(model: nn.Module, tx: Optimizer, T: int,
                          aux_weight: float = 0.0, mesh=None) -> Callable:
    """Returns step(state, sched, z0n, y_cat, y_cont, generator=None,
    noise=None) -> (state, metrics): `state` (of `create_train_state(model,
    tx)`) updated in place, metrics 0-d `loss` and `aux` and [4] `bucket_sum`
    / `bucket_n` on the device. The step draws (t, eps) from `generator`
    (`draw_prior_noise`); noise=(t, eps) replaces the draw (tests inject
    JAX's). aux_weight > 0 needs the MoE prior. On a `mesh`, as
    `make_sde_train_step` says; `loss` and `aux` are the global batch's and
    the buckets sum over the ranks. A ("data", "pipe") mesh trains the
    FiLM prior's pipeline stage, a ("data", "expert") one the MoE prior's
    experts over ranks (`parallel.place_state`); their ranks of a data
    coordinate hold the same rows and the same draws."""
    check_placed(model, mesh, tp=True, pipe=True, expert=True)

    def step(state: TrainState, sched, z0n, y_cat, y_cont,
             generator: torch.Generator | None = None, noise=None):
        if noise is None:
            if generator is None:
                raise ValueError("pass a torch.Generator (or noise=(t, eps)); the step never "
                                 "draws from the global generator")
            noise = draw_prior_noise(z0n, T, _rows_generator(mesh, generator, z0n.shape[0]))
        metrics, grads = prior_loss_and_grads(model, sched, z0n, y_cat, y_cont, *noise,
                                              aux_weight=aux_weight, mesh=mesh)
        tx.update(list(state.params.values()), grads, state.opt_state)
        state.step += 1
        return state, mesh_metrics(mesh, metrics, sums=("bucket_sum", "bucket_n"))

    return step


def make_prior_train_epoch(model: nn.Module, tx: Optimizer, T: int, batch_size: int,
                           latents: tuple, mesh=None, aux_weight: float = 0.0) -> Callable:
    """A whole prior epoch over the resident latent cache: `_make_epoch`'s
    shuffle (drop-last) and per-step gathers of `latents` = (z0_norm [N, z]
    f32, y_cat [N] i32, y_cont [N, 4] f32, on the model's device) around
    `make_prior_train_step`. Returns epoch_fn(state, sched, generator) ->
    (state, {"loss": mean, "aux": mean, "bucket_sum": [4] sum, "bucket_n":
    [4] sum}); `generator` drives the shuffle and every step's draws. On a
    `mesh` (`model` placed by `parallel.place_state`, `batch_size` global)
    each rank gathers and trains its rows of every batch."""
    z0n, y_cat_all, y_cont_all = latents
    device = next(model.parameters()).device
    step_fn = make_prior_train_step(model, tx, T, aux_weight, mesh)

    def run_batch(state, z, yc, yv, sched, generator):
        return step_fn(state, sched, z, yc, yv, generator)

    run_epoch = _make_epoch(run_batch, lambda idx: (z0n[idx], y_cat_all[idx], y_cont_all[idx]),
                            int(z0n.shape[0]), batch_size, device, lambda stacked: stacked,
                            mesh)

    def epoch_fn(state: TrainState, sched, generator: torch.Generator):
        state, ms = run_epoch(state, generator, 0, sched)
        return state, {"loss": ms["loss"].mean(), "aux": ms["aux"].mean(),
                       "bucket_sum": ms["bucket_sum"].sum(0), "bucket_n": ms["bucket_n"].sum(0)}

    return epoch_fn


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

    On a `mesh` (`model` placed by `parallel.place_state`, `batch_size`
    global) each rank renders or gathers only its rows of every batch: one
    rasterizer launch per step per rank on the procedural source. With a
    space axis it renders its rows' whole images and keeps its rows of the
    image height.
    """
    if fresh_data and lattice_cfg is None:
        raise ValueError("fresh_data needs the procedural (lattice_cfg) source: a resident "
                         "archive has only n items")
    device = next(model.parameters()).device
    step_fn = make_sde_train_step(model, tx, sde, n_types, p_uncond, t_power, ema_decay,
                                  parameterization, grad_accum, t_shift, min_snr_gamma, mesh)
    get_batch = _batch_source(lattice_cfg, dataset_seed, resident, device)
    run_epoch = _make_epoch(step_fn, get_batch, n_items, batch_size, device,
                            torch.nanmean if nan_safe_metrics else torch.mean, mesh)

    def epoch_fn(state: TrainState, generator: torch.Generator, offset: int = 0):
        if offset and not fresh_data:
            raise ValueError("an index offset needs fresh_data=True")
        return run_epoch(state, generator, offset)

    return epoch_fn


def make_vae_train_epoch(model: nn.Module, tx: Optimizer, free_bits: float, batch_size: int,
                         n_items: int, uncond: bool = False, lattice_cfg=None,
                         dataset_seed: int = 0, resident: tuple | None = None,
                         mesh=None) -> Callable:
    """A whole VAE training epoch: the SDE epoch's shuffle and batch source
    (`_batch_source`, `_make_epoch`) around `make_vae_train_step`. Returns
    epoch_fn(state, beta_eff, generator) -> (state, {metric: mean over the
    epoch's steps}); `generator` (on the model's device) drives the shuffle
    and every step's draws; on a `mesh`, as `make_sde_train_epoch` says."""
    device = next(model.parameters()).device
    step_fn = make_vae_train_step(model, tx, free_bits, uncond, mesh)
    get_batch = _batch_source(lattice_cfg, dataset_seed, resident, device)
    run_epoch = _make_epoch(step_fn, get_batch, n_items, batch_size, device, torch.mean, mesh)

    def epoch_fn(state: TrainState, beta_eff: float, generator: torch.Generator):
        return run_epoch(state, generator, 0, float(beta_eff))

    return epoch_fn


def _make_epoch(step_fn: Callable, get_batch: Callable, n_items: int, batch_size: int, device,
                reduce: Callable, mesh=None) -> Callable:
    """epoch(state, generator, offset=0, *extra) -> (state, reduced): shuffle
    [0, n_items) with `generator` (drop-last), then one `step_fn(state, x0,
    y_cat, y_cont, *extra, generator)` per batch of `get_batch(idx +
    offset)`. A step's metric is a tensor or a dict of them; `reduce` runs
    over the steps' stack of each. On a mesh every rank draws the same
    shuffle and takes its rows of each batch, and with a space axis (only the
    SDE step takes one) its rows of the image height of x0 (`space_rows`)."""
    n_steps = n_items // batch_size
    if n_steps == 0:
        raise ValueError(f"n_items {n_items} < batch_size {batch_size}")
    mine = data_sharding(mesh, batch_size)
    space = mesh is not None and axis_size(mesh, SPACE) > 1

    def epoch_fn(state: TrainState, generator: torch.Generator, offset: int = 0, *extra):
        order = torch.randperm(n_items, generator=generator, device=device)
        order = order[: n_steps * batch_size].reshape(n_steps, batch_size)[:, mine]
        metrics = []
        for idx in order:
            x0, y_cat, y_cont = get_batch(idx + offset)
            if space:
                x0 = x0[:, spatial.space_rows(mesh, x0.shape[1])]
            state, m = step_fn(state, x0, y_cat, y_cont, *extra, generator)
            metrics.append(m)
        if isinstance(metrics[0], dict):
            return state, {k: reduce(torch.stack([m[k] for m in metrics])) for k in metrics[0]}
        return state, reduce(torch.stack(metrics))

    return epoch_fn
