"""Train state and optimizer of the port.

Counterpart of toycrystals_tpu/train/state.py and of the optax chain that
scripts/train_sde_score_model.py builds: Adam (b1 0.9, b2 0.999, eps 1e-8)
under a constant, linear-warmup or warmup-cosine rate, with optional
global-norm clipping before Adam and an optional skip of non-finite steps.

Unlike the JAX state, which is a pytree replaced at every step, the state
here is updated in place: `TrainState.params` are the model's own parameters
(f32), and the moments and the EMA are f32 tensors beside them. That saves a
copy of every tensor per step.

On a data mesh (parallel/) the parameters are those of the module that
DistributedDataParallel wraps, replicated on every rank, FSDP2's sharded
DTensors, or on a "model" axis each rank's blocks (parallel/tensor.py); the
moments and the EMA are laid out as their parameters, and the updates act on
each rank's shard. Global-norm clipping and the non-finite check then reduce
over the axes that hold each leaf's pieces (under HSDP the "data" group:
each shard is held by every space rank, and summing over all of them would
count it S times; a model block over "model"; a block that FSDP2 shards
over both; a pipeline stage's blocks over "pipe" and the expert axis's
blocks over "expert", the leaves those axes replicate once: JAX's
`clip_by_global_norm` over sharded leaves), so every rank takes the decision
the single-device step takes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from toycrystals_torch.parallel.fsdp import local, shard_axes

Schedule = Callable[[int], float]


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """init -> end over `transition_steps` optimizer updates, then end."""
    if transition_steps <= 0:
        return lambda count: float(init_value)

    def rate(count: int) -> float:
        frac = min(max(count, 0), transition_steps) / transition_steps
        return init_value + (end_value - init_value) * frac

    return rate


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """Linear warmup init -> peak over `warmup_steps`, then cosine decay to
    `end_value` at update `decay_steps` (counted from 0, warmup included)."""
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")
    alpha = end_value / peak_value

    def rate(count: int) -> float:
        if count < warmup_steps:
            return warm(count)
        c = min(count - warmup_steps, span)
        return peak_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / span)) + alpha)

    return rate


@dataclasses.dataclass
class OptState:
    """Adam's state. `count` is the number of updates applied (it drives the
    bias correction and the rate schedule); `notfinite_count` counts the
    consecutive skipped steps and `total_notfinite` all of them."""

    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    notfinite_count: int = 0
    total_notfinite: int = 0


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """clip_by_global_norm -> Adam -> -rate, optionally under apply_if_finite.

    lr: a float or a schedule of the update count. clip_grad_norm > 0 scales
    the gradients by max_norm / norm only when norm >= max_norm (no epsilon
    in the quotient), before Adam, so the moments see the clipped gradients.
    skip_nonfinite = n > 0 rejects a step whose gradients hold a NaN or Inf:
    parameters, moments and `count` stay untouched; after more than n such
    steps in a row the update is applied all the same. The check reads one
    flag from the device per step.
    """

    lr: float | Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip_grad_norm: float = 0.0
    skip_nonfinite: int = 0

    def init(self, params: list[torch.Tensor]) -> OptState:
        return OptState(0, [torch.zeros_like(p) for p in params],
                        [torch.zeros_like(p) for p in params])

    def rate(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               state: OptState) -> bool:
        """One update of `params` and `state` in place from `grads`; returns
        False when the step was skipped as non-finite. Sharded gradients (of
        DTensors or model blocks) take the norm and the finiteness over all
        their shards."""
        axes = [shard_axes(p) or shard_axes(g) for p, g in zip(params, grads)]
        groups = {name: group for ax in axes for name, group in ax}  # this rank's, per axis
        kinds = [tuple(sorted(name for name, _ in ax)) for ax in axes]
        params, grads = [local(p) for p in params], [local(g) for g in grads]
        mu, nu = [local(m) for m in state.mu], [local(v) for v in state.nu]
        if self.skip_nonfinite > 0:
            flag = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            if groups:
                flag = flag.to(torch.int32)
                for name in sorted(groups):  # over each axis in turn: over the whole mesh
                    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=groups[name])
            finite = bool(flag)
            state.notfinite_count = 0 if finite else state.notfinite_count + 1
            if not finite:
                state.total_notfinite += 1
                if state.notfinite_count <= self.skip_nonfinite:
                    return False
        if self.clip_grad_norm > 0.0:
            norms = torch.stack(torch._foreach_norm(grads))
            if not groups:
                norm = torch.linalg.vector_norm(norms)
            else:
                # each kind of leaf summed over the axes its pieces spread
                # over: every element once (a 2-D leaf over "data" and "model")
                sq = None
                for kind in sorted(set(kinds) - {()}):
                    mask = torch.tensor([k == kind for k in kinds], device=norms.device)
                    part = (norms[mask] ** 2).sum()
                    for name in kind:
                        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=groups[name])
                    sq = part if sq is None else sq + part
                whole = torch.tensor([not k for k in kinds], device=norms.device)
                norm = torch.sqrt(sq + (norms[whole] ** 2).sum())
            scale = torch.where(norm < self.clip_grad_norm, torch.ones_like(norm),
                                self.clip_grad_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        count = state.count + 1
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - self.b2 ** count))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(params, mu, denom,
                                value=-self.rate(state.count) / (1.0 - self.b1 ** count))
        state.count = count
        return True


@dataclasses.dataclass
class TrainState:
    """step, the model's live parameters by name, Adam's state, and the EMA
    copy (None when the EMA is off)."""

    step: int
    params: dict[str, torch.Tensor]
    opt_state: OptState
    ema_params: dict[str, torch.Tensor] | None

    @property
    def sample_params(self) -> dict[str, torch.Tensor]:
        """Parameters to sample with: the EMA when enabled, else the live ones."""
        return self.params if self.ema_params is None else self.ema_params


def create_train_state(model: nn.Module, tx: Optimizer, ema: bool = False) -> TrainState:
    params = dict(model.named_parameters())
    for name, p in params.items():
        if p.dtype != torch.float32:
            raise TypeError(f"parameters stay float32; {name} is {p.dtype}")
    ema_params = {k: p.detach().clone() for k, p in params.items()} if ema else None
    return TrainState(0, params, tx.init(list(params.values())), ema_params)


@torch.no_grad()
def ema_update(ema_params: dict[str, torch.Tensor], params: dict[str, torch.Tensor],
               decay: float) -> None:
    """p_ema <- d p_ema + (1 - d) p, in place (on each rank's shard)."""
    ema = [local(t) for t in ema_params.values()]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [local(params[k]) for k in ema_params], alpha=1.0 - decay)
