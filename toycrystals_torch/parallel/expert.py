"""The expert axis: the MoE prior's experts split over the ranks of a mesh.

Counterpart of toycrystals_tpu/parallel/expert.py. JAX places each leaf of the
state by one rule on a ("data", "expert") mesh and lets GSPMD turn the
combine's contraction over E into one psum over "expert"; here each rank of
the mesh (parallel/mesh.py `make_mesh_ep`) holds its block of every leaf the
same rule shards, and the collectives are placed by hand:

- the rule (`expert_sharding`): a leaf whose leading dim, in the flax layout,
  equals n_experts, when n_experts divides by N, is split on that dim;
  everything else stays whole. On the MoE prior that is each block's expert
  stacks `w1`, `b1`, `w2`, `b2` and, at the CLI's defaults (n_types 4,
  y_cont_dim 4) with 4 experts, three more leaves: the y_cat embedding
  `Embed_0` [4, 64], `Dense_2`'s kernel [4, 64] (the y_cont MLP's input
  layer: dim 1 of the torch weight) and every block's router bias [4]. The
  port follows JAX leaf by leaf: the leaf, its size per rank and the coverage
  (`ep_coverage`) are JAX's;
- each block's experts: every rank runs its E / N experts on all of its rows
  (dense dispatch) and weights them by its columns of `combine`
  (models/moe_prior.py); the partial outputs are summed over "expert"
  (`reduce_from_expert`);
- the other sharded leaves are gathered whole where they are consumed
  (`ExpertPlaced`: before the forward, so before the lookup, the y_cont layer
  and the router's softmax);
- the route statistics stay the global batch's, averaged over "data" only.

Each collective is a `torch.autograd.Function` whose backward is its adjoint.
The loss is computed on every expert rank from the same, replicated output,
so each rank's backward brings the same cotangent:

- `reduce_from_expert` (forward all-reduce, backward identity): summing the
  cotangents over "expert" again would make every gradient N times too large;
- `copy_to_expert` (forward identity, backward all-reduce sum) marks the
  inputs h and `combine` entering the expert ranks: each rank's experts give
  only their share of their gradient;
- `gather_expert` (a block -> the whole leaf; backward the rank's slice of
  the whole's gradient, which every rank computes the same).

After the backward the whole leaves' gradients are broadcast from expert rank
0 (as parallel/tensor.py's `sync_whole_grads` does over "model") and every
gradient is averaged over "data" (`ExpertPlaced.reduce_grads`). The sharded
leaves carry a `tensor.Block` of axis "expert", so the optimizer's clip norm
and finite check, `fsdp.full` / `like` / `copy_full_` and the checkpoints
read them as they read the model axis's blocks.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from toycrystals_torch.parallel.fsdp import flax_order, like, local, param_layouts
from toycrystals_torch.parallel.mesh import (
    AXIS,
    EXPERT,
    axis_group,
    axis_rank,
    axis_size,
    check_data_mesh,
    replicate,
)
from toycrystals_torch.parallel.tensor import Block, block_of, tag, take_block

EXPERT_LEAVES = ("w1", "b1", "w2", "b2")  # a MoE block's stacks, used where they lie


def expert_sharding(n: int, shape: tuple[int, ...], n_experts: int) -> bool:
    """JAX's leading-dim rule on a leaf's flax shape: sharded over n expert
    ranks when its dim 0 equals n_experts and n_experts divides by n."""
    return bool(len(shape)) and shape[0] == n_experts and n_experts % n == 0


def expert_dim(n: int, shape: tuple[int, ...], order: tuple[int, ...] | None,
               n_experts: int) -> int | None:
    """The torch dim that the rule shards (the flax layout's dim 0, `order`
    as `fsdp.flax_order` gives it), or None (whole)."""
    order = tuple(range(len(shape))) if order is None else tuple(order)
    flax_shape = tuple(int(shape[d]) for d in order)
    return order[0] if n > 1 and expert_sharding(n, flax_shape, n_experts) else None


def ep_coverage(n: int, model: nn.Module, n_experts: int) -> float:
    """The share of parameter elements that the rule shards over n expert
    ranks: printed under --shard-expert, so a config whose experts do not
    divide the axis shows."""
    tot = sh = 0
    for _, p, order in param_layouts(model):
        tot += p.numel()
        if expert_dim(n, tuple(p.shape), order, n_experts) is not None:
            sh += p.numel()
    return sh / max(tot, 1)


def ep_report(n: int, model: nn.Module, n_experts: int) -> str:
    """JAX's line under --shard-expert."""
    return (f"expert parallelism: {ep_coverage(n, model, n_experts):.0%} of param elements "
            f"sharded over 'expert'")


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


class _CopyToExpert(torch.autograd.Function):
    """Identity; the backward sums the gradient over "expert" (the input of
    the rank's experts, each of which gives its share)."""

    @staticmethod
    def forward(ctx, x, blk):
        ctx.group = blk.group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _ReduceFromExpert(torch.autograd.Function):
    """The sum over "expert"; the backward is the identity (every rank's
    loss, and so its cotangent, is the replicated output's: module
    docstring)."""

    @staticmethod
    def forward(ctx, x, blk):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=blk.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherExpert(torch.autograd.Function):
    """Every expert rank's block along the block's dim, in rank order; the
    backward keeps the rank's slice of the whole's gradient."""

    @staticmethod
    def forward(ctx, x, blk):
        ctx.blk = blk
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(blk.size)]
        dist.all_gather(parts, x.contiguous(), group=blk.group)
        return torch.cat(parts, dim=blk.dim)

    @staticmethod
    def backward(ctx, g):
        return take_block(g, ctx.blk), None


def copy_to_expert(x: torch.Tensor, blk: Block) -> torch.Tensor:
    """x as the input of the rank's experts; differentiable."""
    return _CopyToExpert.apply(x, blk)


def reduce_from_expert(x: torch.Tensor, blk: Block) -> torch.Tensor:
    """The sum of every expert rank's partial x; differentiable."""
    return _ReduceFromExpert.apply(x, blk)


def gather_expert(x: torch.Tensor, blk: Block) -> torch.Tensor:
    """The whole leaf of which x is the block `blk`; differentiable."""
    return _GatherExpert.apply(x, blk)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def shard_experts(model: nn.Module, mesh) -> dict[str, Block]:
    """Give this rank its block of every leaf of `model` (the MoE prior) that
    the rule shards over the mesh's "expert" axis, in place: each such
    parameter becomes its block (a new `nn.Parameter` tagged with its
    `Block`), and a MoE block whose stacks are split records their Block
    (`expert_block`). Returns name -> Block of the sharded leaves that are
    not expert stacks (gathered before each forward)."""
    from toycrystals_torch.models.moe_prior import MoEFiLMResBlock

    n, rank, group = axis_size(mesh, EXPERT), axis_rank(mesh, EXPERT), axis_group(mesh, EXPERT)
    gathered = {}
    for mod_name, module in model.named_modules():
        for name, p in list(module.named_parameters(recurse=False)):
            dim = expert_dim(n, tuple(p.shape), flax_order(module, name, p), model.n_experts)
            if dim is None:
                continue
            blk = Block(group, n, rank, dim, axis=EXPERT)
            block = nn.Parameter(take_block(p.detach(), blk), requires_grad=p.requires_grad)
            module._parameters[name] = tag(block, blk)
            if isinstance(module, MoEFiLMResBlock) and name in EXPERT_LEAVES:
                module.expert_block = blk
            else:
                gathered[f"{mod_name}.{name}" if mod_name else name] = blk
    return gathered


class ExpertPlaced(nn.Module):
    """The MoE prior placed on a ("data", "expert") mesh (`module`): each
    forward gathers the sharded leaves that are not expert stacks and runs
    the prior on them (`torch.func.functional_call`), its blocks' experts on
    the rank's own stacks. forward(...) takes the prior's arguments."""

    def __init__(self, module: nn.Module, gathered: dict[str, Block], data_group,
                 n_data: int, expert_group):
        super().__init__()
        self.module, self.gathered = module, gathered
        self.data_group, self.n_data, self.expert_group = data_group, int(n_data), expert_group

    def forward(self, *args, **kwargs):
        params = dict(self.module.named_parameters())
        whole = {k: gather_expert(params[k], blk) for k, blk in self.gathered.items()}
        return torch.func.functional_call(self.module, whole, args, kwargs)

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """After the backward: the whole leaves' gradients broadcast from
        expert rank 0 (each rank computed them from the same tensors), then
        every gradient averaged over "data"."""
        params = list(self.module.parameters())
        whole = [local(p.grad) for p in params if p.grad is not None and block_of(p) is None]
        if whole:
            flat = torch.cat([g.reshape(-1) for g in whole])
            dist.broadcast(flat, src=dist.get_global_rank(self.expert_group, 0),
                           group=self.expert_group)
            torch._foreach_copy_(whole, [f.view_as(g) for f, g in
                                         zip(flat.split([g.numel() for g in whole]), whole)])
        grads = [p.grad for p in params if p.grad is not None]
        if self.data_group is not None and self.n_data > 1 and grads:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.data_group)
            flat /= self.n_data
            torch._foreach_copy_(grads, [f.view_as(g) for f, g in
                                         zip(flat.split([g.numel() for g in grads]), grads)])


def place_expert_state(mesh, model: nn.Module, state):
    """Place the MoE prior and its `TrainState` on a ("data", "expert") mesh:
    every rank takes rank 0's parameters, moments and EMA, then keeps its
    block of every leaf the rule shards (`shard_experts`), with the moments
    and the EMA on the same blocks (each rank holds its E / N experts' Adam
    state). Returns (the `ExpertPlaced` module to train and sample through,
    the state)."""
    check_data_mesh(mesh, expert=True)
    opt = state.opt_state
    names = list(state.params)
    replicate(mesh, [*model.parameters(), *model.buffers(), *opt.mu, *opt.nu,
                     *(state.ema_params or {}).values()])
    gathered = shard_experts(model, mesh)
    params = dict(model.named_parameters())
    if list(params) != names:
        raise ValueError("the state's parameters are not the model's")
    mu = [like(params[k], m) for k, m in zip(names, opt.mu)]
    nu = [like(params[k], v) for k, v in zip(names, opt.nu)]
    ema = (None if state.ema_params is None
           else {k: like(params[k], v) for k, v in state.ema_params.items()})
    n_data = axis_size(mesh, AXIS)
    placed = ExpertPlaced(model, gathered, axis_group(mesh, AXIS) if n_data > 1 else None,
                          n_data, axis_group(mesh, EXPERT))
    return placed, dataclasses.replace(state, params=params,
                                       opt_state=dataclasses.replace(opt, mu=mu, nu=nu),
                                       ema_params=ema)
