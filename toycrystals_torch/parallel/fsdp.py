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

On a ("data", "space") mesh FSDP2 runs as HSDP, as JAX places it: each leaf
sharded over "data" by the same rule and replicated over "space". FSDP2
takes a 2-D mesh as (replicate, shard), the transpose of the mesh's rank
order d S + s, so `fsdp_mesh` builds it from arange(D S).reshape(D, S).T
with the names ("space", "data"); the gradients are averaged over all D S
ranks, as DDP does there, and the clip norm and the finite check of
train/state.py sum over the "data" shards only (each is held S times).

On a ("data", "model") mesh (parallel/tensor.py) each rank holds its model
block of the sharded leaves, and DDP averages the gradients over the "data"
group of the rank's model coordinate. With `fsdp` there (JAX's 2-D weight
sharding) the rule runs with the leaf's "model" dim excluded, as JAX's does
where the trailing-dim rule shards the leaf, and FSDP2 shards each rank's
blocks over the "data" sub-mesh of its model coordinate: a leaf may then be
both a model block and a "data" shard, and the clip norm sums it over both
axes. `full`, `like` and `copy_full_` read every layout: a DTensor, a
tensor tagged with its model `Block`, or a DTensor so tagged.

On JAX's 3-D ("data", "space", "model") mesh the two compose: DDP averages
over the D S ranks of the rank's model coordinate, and with `fsdp` FSDP2
runs HSDP on each rank's blocks over the ("space", "data") mesh of that
coordinate (replicate "space", shard "data", the model dim excluded from the
rule), so a leaf is summed over "data" and "model" by the clip norm, never
over "space", whose ranks hold copies.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch
import torch.distributed as dist
from torch import nn

from toycrystals_torch.parallel.mesh import (
    AXIS,
    EXPERT,
    MODEL,
    PIPE,
    SPACE,
    axis_size,
    check_data_mesh,
    mesh_axes,
    mesh_group,
    replica_group,
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


def fsdp_sharding(n: int, shape: tuple[int, ...], order: tuple[int, ...] | None = None,
                  model: int = 1):
    """The torch dim that JAX's rule shards over n ranks, or None (whole).

    The rule runs on the flax layout (`order`, default the identity) of the
    whole leaf: the largest dim evenly divisible by n, ties to the later
    flax dim. On a mesh with a "model" axis of `model` > 1 ranks the last
    flax dim is excluded where the model rule shards it (it divides by
    `model`), as JAX's `fsdp_sharding` excludes it."""
    order = tuple(range(len(shape))) if order is None else tuple(order)
    logical = [int(shape[d]) for d in order]
    taken = len(logical) - 1 if model > 1 and logical and logical[-1] % model == 0 \
        and logical[-1] >= model else None
    cands = [i for i, d in enumerate(logical) if d % n == 0 and d >= n and i != taken]
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


def fsdp_coverage(n: int, model: nn.Module, m: int = 1) -> float:
    """The share of parameter elements that the rule shards over n ranks
    (on a mesh with a "model" axis of m ranks, the 2-D rule) of the whole
    model: print it when --fsdp is on, so that indivisible configs show."""
    tot = sh = 0
    for _, p, order in param_layouts(model):
        tot += p.numel()
        if fsdp_sharding(n, tuple(p.shape), order, m) is not None:
            sh += p.numel()
    return sh / max(tot, 1)


# the HSDP meshes of a 3-D mesh (their ranks) -> the group of the D M ranks
# that hold one copy of every piece: the space coordinate's (`write_group`)
_WRITE_GROUPS: dict[tuple[int, ...], object] = {}


def fsdp_mesh(mesh):
    """The mesh FSDP2 shards over: a ("data",) mesh itself; on ("data",
    "model"), the "data" sub-mesh of this rank's model coordinate; on
    ("data", "space"), the 2-D mesh (replicate "space", shard "data") of
    the same ranks, and on ("data", "space", "model") that 2-D mesh of this
    rank's model coordinate, each built anew (a collective: every rank
    calls it)."""
    axes = mesh_axes(mesh)
    if MODEL in axes and SPACE not in axes:
        return mesh[AXIS]
    if SPACE not in axes:
        return mesh
    from torch.distributed.device_mesh import DeviceMesh

    d, s, m = axis_size(mesh, AXIS), axis_size(mesh, SPACE), axis_size(mesh, MODEL)
    ranks = torch.arange(d * s * m).reshape(d, s, m)
    if m == 1:
        return DeviceMesh(mesh.device_type, ranks[..., 0].T, mesh_dim_names=(SPACE, AXIS))
    root = DeviceMesh(mesh.device_type, ranks.permute(2, 1, 0),
                      mesh_dim_names=(MODEL, SPACE, AXIS))
    hsdp = root[SPACE, AXIS]
    for j in range(s):  # every rank makes every group, in the same order
        group = dist.new_group(ranks[:, j].flatten().tolist())
        if j == mesh.get_local_rank(SPACE):
            _WRITE_GROUPS[tuple(hsdp.mesh.flatten().tolist())] = group
    return hsdp


def write_group(t) -> object | None:
    """For a DTensor on the HSDP mesh of a 3-D mesh's model coordinate, the
    group of the ranks of this rank's space coordinate, which hold each
    (data, model) piece of a leaf once; None (the whole process group) for
    any other DTensor."""
    return _WRITE_GROUPS.get(tuple(t.device_mesh.mesh.flatten().tolist()))


def shard_params_fsdp(mesh, model: nn.Module) -> nn.Module:
    """ZeRO-3 placement of `model`, in place, with FSDP2 over `mesh`: each
    leaf sharded along the dim of `fsdp_sharding`, leaves with none kept
    whole (FSDP2's `ignored_params`); on a ("data", "space") mesh, HSDP
    (`fsdp_mesh`). On a ("data", "model") mesh the model holds its blocks
    already (parallel/tensor.py `shard_params`): the rule runs on each whole
    leaf with its "model" dim excluded, FSDP2 shards the rank's block over
    the "data" sub-mesh, and each sharded parameter keeps its `Block` tag.
    The model's parameters must already agree on every rank of the "data"
    group. Returns the model (now an FSDPModule)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from toycrystals_torch.parallel.tensor import param_block, tag, whole_shape

    n, m = axis_size(mesh, AXIS), axis_size(mesh, MODEL)
    dims = {}
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            shape = whole_shape(p, param_block(module, name))
            dims[id(p)] = fsdp_sharding(n, shape, flax_order(module, name, p), m)
    whole = {p for p in model.parameters() if dims[id(p)] is None}
    fully_shard(model, mesh=fsdp_mesh(mesh), shard_placement_fn=lambda p: Shard(dims[id(p)]),
                ignored_params=whole or None)
    for module in model.modules():  # the DTensors that replaced the blocks
        for name, p in module.named_parameters(recurse=False):
            tag(p, param_block(module, name))
    return model


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (the same storage); a tensor itself."""
    return t._local_tensor if is_sharded(t) else t


def _shard_dim(t) -> tuple[int, object] | None:
    """(mesh dim, placement) of the one dim a DTensor is sharded along, or
    None when it is replicated on every mesh dim."""
    return next(((i, pl) for i, pl in enumerate(t.placements) if pl.is_shard()), None)


def data_shard(t: torch.Tensor) -> tuple[int, int, int] | None:
    """(tensor dim, this rank's index along it, the number of shards) of a
    DTensor's shard over its mesh's sharded dim; None for a tensor that is
    no DTensor or is replicated."""
    if not is_sharded(t):
        return None
    sd = _shard_dim(t)
    if sd is None:
        return None
    i, placement = sd
    return placement.dim, t.device_mesh.get_local_rank(i), t.device_mesh.size(i)


def shard_axes(t: torch.Tensor) -> tuple[tuple[str, object], ...]:
    """(axis name, process group) of each mesh axis over whose ranks the
    pieces of `t` are spread: a DTensor's shard dim of its mesh ("data"),
    a block's axis ("model", or "expert": parallel/expert.py), both for a
    block that FSDP2 shards, and "pipe" for a pipeline stage's block
    (parallel/pipeline.py); () for a whole tensor."""
    from toycrystals_torch.parallel.pipeline import stage_of
    from toycrystals_torch.parallel.tensor import block_of

    axes = []
    if is_sharded(t):
        sd = _shard_dim(t)
        if sd is not None:
            axes.append((t.device_mesh.mesh_dim_names[sd[0]], t.device_mesh.get_group(sd[0])))
    blk = block_of(t)
    if blk is not None:
        axes.append((blk.axis, blk.group))
    stage = stage_of(t)
    if stage is not None:
        axes.append((PIPE, stage.group))
    return tuple(axes)


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole value of a DTensor sharded evenly along one dim (over the
    "data" dim of an HSDP mesh too), of a model block (parallel/tensor.py),
    or of a block that FSDP2 shards (gathered over "data", then over
    "model"); a collective that every rank calls. A whole tensor is
    returned itself. One c10d all_gather of the shards, concatenated along
    the sharded dim: DTensor's own `full_tensor` goes through functional
    collectives, which crash on gloo with CUDA tensors (torch 2.11)."""
    from toycrystals_torch.parallel.tensor import block_of, gather_block

    blk = block_of(t)
    if is_sharded(t):
        shard = local(t).detach().contiguous()
        sd = _shard_dim(t)
        if sd is None:
            t = shard
        else:
            i, placement = sd
            parts = [torch.empty_like(shard) for _ in range(t.device_mesh.size(i))]
            dist.all_gather(parts, shard, group=t.device_mesh.get_group(i))
            t = torch.cat(parts, dim=placement.dim)
    return t if blk is None else gather_block(t, blk)


def like(template: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """`value` (the whole tensor, on every rank) laid out as `template`: the
    rank's model block where the template holds one, then its shard as a
    DTensor where the template is one (no communication), else a copy;
    tagged with the template's `Block`."""
    from toycrystals_torch.parallel.tensor import block_of, tag, take_block

    blk = block_of(template)
    value = value.detach() if blk is None else take_block(value.detach(), blk)
    if not is_sharded(template):
        return tag(value.clone() if blk is None else value, blk)
    from torch.distributed.tensor import distribute_tensor

    return tag(distribute_tensor(value, template.device_mesh, template.placements,
                                 src_data_rank=None), blk)


def copy_full_(target: torch.Tensor, value: torch.Tensor) -> None:
    """Copy the whole `value` into `target` in place: into the rank's shard
    when `target` is a DTensor, its block when it holds a model block."""
    from toycrystals_torch.parallel.tensor import block_of

    with torch.no_grad():
        if is_sharded(target) or block_of(target) is not None:
            local(target).copy_(local(like(target, value.to(target.device))))
        else:
            target.copy_(value)


def reduce_replicated_grads(mesh, params: Iterable[torch.Tensor]) -> None:
    """Average the gradients of the parameters that FSDP2 leaves whole (plain
    tensors among DTensors) in place over `replica_group`: the mesh, or
    with a "model" axis its "data" ranks (and "space" ones) of the rank's
    model coordinate (the model ranks hold different blocks)."""
    if mesh is None or mesh.size() == 1:
        return
    group, n = replica_group(mesh)
    for p in params:
        if not is_sharded(p) and p.grad is not None:
            dist.all_reduce(p.grad, op=dist.ReduceOp.SUM, group=group)
            p.grad.div_(n)


def full_tensors(tensors: dict, tags: dict | None = None) -> dict:
    """`full` of every tensor of a state's dict (parameters, moments, EMA or,
    with their parameters as `tags`, gradients), and on a ("data", "pipe")
    mesh every stage's blocks as well, in the whole model's order
    (parallel/pipeline.py `gather_stages`); a collective."""
    from toycrystals_torch.parallel.pipeline import gather_stages
    from toycrystals_torch.parallel.tensor import block_of, gather_block

    tags = tensors if tags is None else tags
    whole = {}
    for k, v in tensors.items():
        whole[k] = full(v)
        blk = block_of(tags[k])
        if blk is not None and block_of(v) is None:  # a gradient of a block
            whole[k] = gather_block(whole[k], blk)
    return gather_stages(whole, tags)


def place_state(mesh, model: nn.Module, state, fsdp: bool = False, n_micro: int = 1):
    """Place `model` and its `TrainState` on a ("data",), ("data", "space"),
    ("data", "model"), ("data", "space", "model"), ("data", "pipe") or
    ("data", "expert") mesh; returns (the module to train through, the
    state). mesh=None passes both through.

    Every rank first takes rank 0's parameters, moments and EMA. Then:

    - without `fsdp`, the model is wrapped in DistributedDataParallel over
      every rank of the mesh (the gradients averaged over all of them: the
      weights are replicated over "space" too) and the state keeps the
      model's own parameters;
    - with `fsdp` the model is sharded in place (`shard_params_fsdp`; HSDP
      on a space axis) and the state is rebuilt on its DTensor parameters,
      with the moments and the EMA on the same shards;
    - on a ("data", "model") mesh each rank keeps its block of every leaf
      that parallel/tensor.py's rule shards (`shard_params`), the moments and
      the EMA are rebuilt on the blocks, and DDP averages over the "data"
      group of the rank's model coordinate; with `fsdp` (JAX's 2-D weight
      sharding) FSDP2 then shards those blocks over the "data" sub-mesh
      instead, and the moments and the EMA sit on the same 2-D shards;
    - on a ("data", "space", "model") mesh, as on ("data", "model"), with
      DDP over the D S ranks of the rank's model coordinate, or with `fsdp`
      HSDP on the blocks over that coordinate's ("space", "data") mesh;
    - on a ("data", "pipe") mesh the FiLM prior runs as a pipeline of
      `n_micro` microbatches, each rank one stage with its blocks, their
      moments and EMA (parallel/pipeline.py `place_pipeline_state`); on a
      ("data", "expert") mesh the MoE prior keeps its block of every leaf
      JAX's expert rule shards (parallel/expert.py `place_expert_state`).
      Both average the gradients over "data" by hand after the backward.
      `fsdp` changes neither placement, as in JAX."""
    if mesh is None:
        return model, state
    check_data_mesh(mesh, space=True, model=True, pipe=True, expert=True)
    if PIPE in mesh_axes(mesh):
        from toycrystals_torch.parallel.pipeline import place_pipeline_state

        return place_pipeline_state(mesh, model, state, n_micro)
    if EXPERT in mesh_axes(mesh):
        from toycrystals_torch.parallel.expert import place_expert_state

        return place_expert_state(mesh, model, state)
    model_axis = MODEL in mesh_axes(mesh)
    names = list(state.params)
    opt = state.opt_state
    replicate(mesh, [*model.parameters(), *model.buffers(), *opt.mu, *opt.nu,
                     *(state.ema_params or {}).values()])
    if model_axis:
        from toycrystals_torch.parallel.tensor import shard_params

        shard_params(model, mesh)
    if fsdp:
        shard_params_fsdp(mesh, model)
    elif not model_axis:
        return _ddp(model, mesh_group(mesh)), state
    params = dict(model.named_parameters())
    if list(params) != names:
        raise ValueError("the state's parameters are not the model's")
    mu = [like(params[k], m) for k, m in zip(names, opt.mu)]
    nu = [like(params[k], v) for k, v in zip(names, opt.nu)]
    ema = (None if state.ema_params is None
           else {k: like(params[k], v) for k, v in state.ema_params.items()})
    state = dataclasses.replace(state, params=params,
                                opt_state=dataclasses.replace(opt, mu=mu, nu=nu),
                                ema_params=ema)
    return (_ddp(model, replica_group(mesh)[0]) if model_axis and not fsdp else model), state


def _ddp(model: nn.Module, group):
    from torch.nn.parallel import DistributedDataParallel

    dev = next(model.parameters()).device
    return DistributedDataParallel(model, device_ids=[dev] if dev.type == "cuda" else None,
                                   process_group=group)
