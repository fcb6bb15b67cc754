"""Fully sharded data parallelism (ZeRO-3 placement over the "data" axis).

Counterpart of toycrystals_tpu/parallel/fsdp.py, on FSDP2 (`fully_shard`):
every parameter, its Adam moments and its EMA live 1/N on each rank, the
weights are all-gathered for each forward and backward and the gradients
reduce-scattered.

The placement is JAX's `fsdp_sharding` rule: shard the leaf's largest dim
that divides by N (ties go to the later dim), and keep a leaf with no such
dim whole on every rank. The rule reads the dims in the flax layout of the
same logical tensor, so each leaf is split along the axis JAX splits:
a conv weight OIHW is HWIO there (on a tie between I and O, JAX's later dim
is O, dim 0 here), a linear (out, in) is (in, out), and embeddings, norms,
biases and the MoE prior's stacked expert weights keep their layout.
Whole leaves are given to FSDP2 as `ignored_params`, and their gradients are
averaged over the ranks after the backward (`reduce_replicated_grads`), as
GSPMD does for a replicated leaf; nothing is padded.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch
import torch.distributed as dist
from torch import nn

from toycrystals_torch.parallel.mesh import (
    DEFERRED,
    SPACE,
    check_data_mesh,
    mesh_axes,
    mesh_group,
    replicate,
)


def flax_order(module: nn.Module, name: str, p: torch.Tensor) -> tuple[int, ...]:
    """The torch dims of parameter `name` of `module`, in the order of the
    flax layout's dims (flax dim i is torch dim order[i])."""
    if p.dim() == 4 and name == "weight":
        # ConvTranspose [in, out, kh, kw] <-> [kh, kw, in, out]; conv OIHW <-> HWIO
        return (2, 3, 0, 1) if "ConvTranspose" in type(module).__name__ else (2, 3, 1, 0)
    if p.dim() == 2 and name == "weight" and not isinstance(module, nn.Embedding):
        return (1, 0)
    return tuple(range(p.dim()))


def fsdp_sharding(n: int, shape: tuple[int, ...], order: tuple[int, ...] | None = None):
    """The torch dim that JAX's rule shards over n ranks, or None (whole).

    The rule runs on the flax layout (`order`, default the identity): the
    largest dim evenly divisible by n, ties to the later flax dim."""
    order = tuple(range(len(shape))) if order is None else tuple(order)
    logical = [int(shape[d]) for d in order]
    cands = [i for i, d in enumerate(logical) if d % n == 0 and d >= n]
    if not cands:
        return None
    return order[max(cands, key=lambda i: (logical[i], i))]


def param_layouts(model: nn.Module) -> list[tuple[str, nn.Parameter, tuple[int, ...]]]:
    """(name, parameter, flax order) for every parameter of `model`."""
    out = []
    for mod_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            out.append((full, p, flax_order(module, name, p)))
    return out


def fsdp_coverage(n: int, model: nn.Module) -> float:
    """The share of parameter elements that the rule shards over n ranks:
    print it when --fsdp is on, so that indivisible configs show."""
    tot = sh = 0
    for _, p, order in param_layouts(model):
        tot += p.numel()
        if fsdp_sharding(n, tuple(p.shape), order) is not None:
            sh += p.numel()
    return sh / max(tot, 1)


def shard_params_fsdp(mesh, model: nn.Module) -> nn.Module:
    """ZeRO-3 placement of `model`, in place, with FSDP2 over `mesh`: each
    leaf sharded along the dim of `fsdp_sharding`, leaves with none kept
    whole (FSDP2's `ignored_params`). The model's parameters must already
    agree on every rank. Returns the model (now an FSDPModule)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n = mesh.size()
    dims = {id(p): fsdp_sharding(n, tuple(p.shape), order)
            for _, p, order in param_layouts(model)}
    whole = {p for p in model.parameters() if dims[id(p)] is None}
    fully_shard(model, mesh=mesh, shard_placement_fn=lambda p: Shard(dims[id(p)]),
                ignored_params=whole or None)
    return model


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (the same storage); a tensor itself."""
    return t._local_tensor if is_sharded(t) else t


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole value of a DTensor sharded evenly on a 1-D mesh (a
    collective: every rank calls it); a tensor itself. One c10d all_gather
    of the shards, concatenated along the sharded dim: DTensor's own
    `full_tensor` goes through functional collectives, which crash on gloo
    with CUDA tensors (torch 2.11)."""
    if not is_sharded(t):
        return t
    (placement,) = t.placements
    shard = local(t).detach().contiguous()
    if not placement.is_shard():
        return shard
    group = t.device_mesh.get_group()
    parts = [torch.empty_like(shard) for _ in range(t.device_mesh.size())]
    dist.all_gather(parts, shard, group=group)
    return torch.cat(parts, dim=placement.dim)


def like(template: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """`value` (the whole tensor, on every rank) laid out as `template`: the
    rank's shard as a DTensor when the template is one (no communication),
    else a copy."""
    if not is_sharded(template):
        return value.detach().clone()
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(value.detach(), template.device_mesh, template.placements,
                             src_data_rank=None)


def copy_full_(target: torch.Tensor, value: torch.Tensor) -> None:
    """Copy the whole `value` into `target` in place: into the rank's shard
    when `target` is a DTensor."""
    with torch.no_grad():
        if is_sharded(target):
            local(target).copy_(local(like(target, value.to(target.device))))
        else:
            target.copy_(value)


def reduce_replicated_grads(mesh, params: Iterable[torch.Tensor]) -> None:
    """Average over the mesh the gradients of the parameters that FSDP2
    leaves whole (plain tensors among DTensors), in place."""
    if mesh is None or mesh.size() == 1:
        return
    group = mesh_group(mesh)
    for p in params:
        if not is_sharded(p) and p.grad is not None:
            dist.all_reduce(p.grad, op=dist.ReduceOp.SUM, group=group)
            p.grad.div_(mesh.size())


def place_state(mesh, model: nn.Module, state, fsdp: bool = False):
    """Place `model` and its `TrainState` on a data mesh, or a ("data",
    "space") one; returns (the module to train through, the state).
    mesh=None passes both through.

    Every rank first takes rank 0's parameters, moments and EMA. Then
    without `fsdp` the model is wrapped in DistributedDataParallel over every
    rank of the mesh (the gradients averaged over all of them: the weights
    are replicated over "space" too) and the state keeps the model's own
    parameters; with `fsdp` the model is sharded in place
    (`shard_params_fsdp`) and the state is rebuilt on its DTensor
    parameters, with the moments and the EMA on the same shards. FSDP2 on a
    space axis (JAX: each weight sharded over "data" and replicated over
    "space", HSDP) is not ported yet and raises."""
    if mesh is None:
        return model, state
    check_data_mesh(mesh, space=True)
    if fsdp and SPACE in mesh_axes(mesh):
        raise NotImplementedError(f"FSDP2 on a ('data', 'space') mesh is not ported yet "
                                  f"({DEFERRED})")
    names = list(state.params)
    opt = state.opt_state
    replicate(mesh, [*model.parameters(), *model.buffers(), *opt.mu, *opt.nu,
                     *(state.ema_params or {}).values()])
    if not fsdp:
        from torch.nn.parallel import DistributedDataParallel

        dev = next(model.parameters()).device
        ddp = DistributedDataParallel(model, device_ids=[dev] if dev.type == "cuda" else None,
                                      process_group=mesh_group(mesh))
        return ddp, state
    shard_params_fsdp(mesh, model)
    params = dict(model.named_parameters())
    if list(params) != names:
        raise ValueError("the state's parameters are not the model's")
    mu = [like(params[k], m) for k, m in zip(names, opt.mu)]
    nu = [like(params[k], v) for k, v in zip(names, opt.nu)]
    ema = (None if state.ema_params is None
           else {k: like(params[k], v) for k, v in state.ema_params.items()})
    return model, dataclasses.replace(state, params=params,
                                      opt_state=dataclasses.replace(opt, mu=mu, nu=nu),
                                      ema_params=ema)
