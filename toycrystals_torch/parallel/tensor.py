"""The "model" axis: every weight's output channels split over the ranks of a mesh.

Counterpart of toycrystals_tpu/parallel/tensor.py. JAX lays a ("data",
"model") mesh, places each weight by its trailing-dim rule and lets GSPMD
insert the channel collectives; here each rank holds its block of every
weight that the same rule shards (`shard_params`) and the ops of the U-Net
place the collectives themselves, reading the model group from the dispatch
scope (parallel/spatial.py `dispatch_scope`, `current_model`):

- a conv or linear layer whose weight is sharded computes the rank's block of
  output channels from the whole input; an input that arrives as a block is
  gathered over "model" first (`whole`). A layer whose weight the rule keeps
  whole (the 1-channel `out` conv, `refine2`) computes every channel;
- GroupNorm+SiLU runs on the rank's channel block where the block holds whole
  groups (the U-Net's 8 groups over M = 2, 4 or 8), else on the gathered
  whole, keeping the block (ops/groupnorm.py);
- attention gives each rank its heads, where they split (ops/attention.py);
- every concat gathers its operands first, so the channel order is JAX's.

The rule (`tp_sharding`) is JAX's, read on the flax layout of each leaf
(parallel/fsdp.py `flax_order`): a leaf is split along its last flax dim when
that divides by M, so a conv OIHW splits its O, a linear (out, in) its out,
and embeddings, biases and norms their last dim. One deliberate difference:
the attention's `qkv` leaves (3C output columns, JAX: a contiguous block of
them) are placed by head where the heads split, each rank holding the q, k
and v columns of its heads (`Block.parts` = 3). The leaf, its size per rank
and the coverage are JAX's; `full_params` and `gather_block` undo the
permutation. Each module records the `Block` of each of its sharded
parameters (`param_block`), which the ops read: FSDP2 swaps a module's
parameters for DTensors and, inside each forward and backward, for unsharded
copies, and neither carries an attribute of the parameter it replaces. The
state's tensors (parameters, moments, EMA) carry their `Block` too
(`block_of`), which the optimizer's clip norm and finite check, the
checkpoints and the EMA read.

The VAE and the latent priors take the same rule (models/vae.py,
models/diffusion_prior.py, models/moe_prior.py): each sharded layer computes
its block from the whole input (`apply`; `dense` gathers the output too), a
consumer that needs every channel or feature gathers them (`whole`), and a
LayerNorm whose affine is sharded gathers its weights (`layer_norm`). Under
--fsdp on the same mesh FSDP2 shards each rank's blocks over "data" as well
(parallel/fsdp.py, JAX's 2-D weight sharding).

The collectives are `torch.autograd.Function`s whose backward is the
adjoint, so training differentiates through them (an all-reduce where
spatial.py's `_GatherSpace` would reduce-scatter: gloo has no reduce-scatter
for CUDA tensors). Each rank's backward produces the whole gradient of every
tensor it holds whole and its block's gradient of every block:

- `gather_model` (a block -> the whole): the backward takes the rank's slice
  of the whole's gradient as it is;
- `copy_to_model` (identity) sits in front of every sharded consumer of a
  whole tensor: that consumer gives each rank only its output block's share
  of the input's gradient, and the backward sums the shares over "model";
- `take_model` (the whole -> the rank's block): the backward gathers the
  blocks' gradients.

A tensor read by both kinds of consumer (the s2dr stem's `out`, read by
`refine1`, which is sharded, and by the final add, which is not) so gets the
sum of its sharded consumers' shares plus its replicated consumers' whole
gradient, once. The loss is computed on the replicated output and is not
summed over "model".
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.distributed as dist
from torch import nn

from toycrystals_torch.parallel import spatial
from toycrystals_torch.parallel.fsdp import flax_order, param_layouts
from toycrystals_torch.parallel.mesh import MODEL, axis_group, axis_rank, axis_size


def tp_sharding(n: int, shape: tuple[int, ...], order: tuple[int, ...] | None = None):
    """The torch dim that JAX's trailing-dim rule shards over n ranks, or
    None (whole): the last dim of the flax layout (`order`, default the
    identity), when it divides by n. Scalars stay whole."""
    if not len(shape):
        return None
    d = (tuple(range(len(shape))) if order is None else tuple(order))[-1]
    return d if shape[d] % n == 0 and shape[d] >= n else None


def tp_coverage(n: int, model: nn.Module) -> float:
    """The share of parameter elements that the rule shards over n ranks:
    printed under --shard-model, so that a config whose channels do not
    divide the axis shows."""
    tot = sh = 0
    for _, p, order in param_layouts(model):
        tot += p.numel()
        if tp_sharding(n, tuple(p.shape), order) is not None:
            sh += p.numel()
    return sh / max(tot, 1)


@dataclasses.dataclass(frozen=True)
class Block:
    """Where a rank's block lies in the whole leaf: `dim` is cut into `parts`
    equal pieces (1, or 3 for a qkv placed by head), each piece into `size`
    blocks, and this rank holds block `rank` of each piece, in piece order.
    `group` is the group of the mesh axis `axis` that holds the other blocks:
    "model" here, "expert" for the MoE prior's leaves that parallel/expert.py
    shards."""

    group: object
    size: int
    rank: int
    dim: int
    parts: int = 1
    axis: str = MODEL


def block_of(t: torch.Tensor) -> Block | None:
    """The `Block` a tensor of a model-sharded state holds, or None (whole)."""
    return getattr(t, "tp_block", None)


def param_block(module: nn.Module, name: str) -> Block | None:
    """The `Block` that parameter `name` of `module` holds, or None (whole):
    recorded on the module by `shard_params`, where FSDP2's swaps of the
    parameter cannot drop it."""
    return getattr(module, "tp_blocks", {}).get(name)


def tag(t: torch.Tensor, blk: Block | None) -> torch.Tensor:
    """`t`, marked as holding `blk`."""
    if blk is not None:
        t.tp_block = blk
    return t


def take_block(whole: torch.Tensor, blk: Block) -> torch.Tensor:
    """The rank's block of the whole leaf (a contiguous copy)."""
    n = whole.shape[blk.dim]
    w = whole.unflatten(blk.dim, (blk.parts, blk.size, n // (blk.parts * blk.size)))
    return w.select(blk.dim + 1, blk.rank).flatten(blk.dim, blk.dim + 1).contiguous()


def assemble_blocks(blocks: list[torch.Tensor], blk: Block) -> torch.Tensor:
    """The whole leaf from the blocks of model ranks 0 .. M - 1 (the inverse
    of `take_block`)."""
    k = blocks[0].shape[blk.dim] // blk.parts
    stacked = torch.stack([b.unflatten(blk.dim, (blk.parts, k)) for b in blocks],
                          dim=blk.dim + 1)
    return stacked.flatten(blk.dim, blk.dim + 2)


def gather_block(t: torch.Tensor, blk: Block) -> torch.Tensor:
    """The whole leaf from every rank's block (a collective over the model
    group; not differentiable)."""
    blocks = [torch.empty_like(t, memory_format=torch.contiguous_format)
              for _ in range(blk.size)]
    dist.all_gather(blocks, t.detach().contiguous(), group=blk.group)
    return assemble_blocks(blocks, blk)


def _heads(model: nn.Module) -> dict[int, int]:
    """id(qkv linear) -> its attention's head count, for every attention
    block of `model`."""
    return {id(m.qkv): int(m.num_heads) for m in model.modules()
            if isinstance(getattr(m, "qkv", None), nn.Linear) and hasattr(m, "num_heads")}


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Give this rank its block of every leaf of `model` that the rule shards
    over the mesh's "model" axis, in place: each such parameter is replaced
    by its block (a new `nn.Parameter`, tagged with its `Block`). A qkv
    whose heads divide by M is placed by head. `model` holds the whole
    weights on entry (utils/params.py `load_flax_params`); returns it."""
    n, rank, group = axis_size(mesh, MODEL), axis_rank(mesh, MODEL), axis_group(mesh, MODEL)
    heads = _heads(model)
    for module in model.modules():
        for name, p in list(module.named_parameters(recurse=False)):
            dim = tp_sharding(n, tuple(p.shape), flax_order(module, name, p))
            if dim is None or n == 1:
                continue
            parts = 3 if id(module) in heads and heads[id(module)] % n == 0 else 1
            blk = Block(group, n, rank, dim, parts)
            block = nn.Parameter(take_block(p.detach(), blk), requires_grad=p.requires_grad)
            module._parameters[name] = tag(block, blk)
            module.tp_blocks = {**getattr(module, "tp_blocks", {}), name: blk}
    return model


def whole_shape(p: torch.Tensor, blk: Block | None) -> tuple[int, ...]:
    """The shape of the whole leaf of which `p` is the block `blk`."""
    shape = list(p.shape)
    if blk is not None:
        shape[blk.dim] *= blk.size
    return tuple(shape)


def full_params(model: nn.Module) -> dict:
    """The flax param tree of a model sharded by `shard_params` (numpy
    leaves; a collective over the model group): what one process's model
    gives, bit for bit."""
    from toycrystals_torch.utils.params import flax_from_torch_state_dict

    whole = {}
    for k, p in model.named_parameters():
        blk = block_of(p)
        whole[k] = (p.detach() if blk is None else gather_block(p, blk)).cpu().numpy()
    return flax_from_torch_state_dict(whole)


def sharded_tensor(t: torch.Tensor, blk: Block, host: bool = False):
    """This rank's block `t` as a ShardedTensor of the whole leaf, one local
    shard (a view of `t`, or with `host` of a copy on the host) per piece,
    for torch.distributed.checkpoint: DCP writes each piece at its offset in
    the whole leaf (once, whichever data ranks hold it) and loads into the
    views in place. Where `t` is also an FSDP2 DTensor (2-D weight sharding)
    the pieces are its local shard's, each at its offset along the "data"
    dim too, and the ShardedTensor spans every rank, or on a 3-D mesh the
    ranks of this rank's space coordinate (`fsdp.write_group`: the space
    ranks hold copies, and a ShardedTensor's pieces may not overlap)."""
    from torch.distributed._shard.sharded_tensor import (
        Shard,
        ShardMetadata,
        init_from_local_shards,
    )

    from toycrystals_torch.parallel.fsdp import data_shard, local, write_group

    loc = local(t).detach()
    if host:
        loc = loc.to("cpu", copy=True)
    size = list(whole_shape(loc, blk))
    offsets0, group = [0] * loc.dim(), blk.group
    cut = data_shard(t)
    if cut is not None:  # the local shard's place over "data"
        d, r, n = cut
        size[d] *= n
        offsets0[d], group = r * loc.shape[d], write_group(t)  # None: the whole group
    k = loc.shape[blk.dim] // blk.parts
    piece = size[blk.dim] // blk.parts
    place = f"rank:{dist.get_rank()}/{loc.device}"
    shards = []
    for j in range(blk.parts):
        offsets, sizes = list(offsets0), list(loc.shape)
        offsets[blk.dim], sizes[blk.dim] = j * piece + blk.rank * k, k
        shards.append(Shard(loc.narrow(blk.dim, j * k, k), ShardMetadata(offsets, sizes, place)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the ShardedTensor API warns of its successor
        return init_from_local_shards(shards, *size, process_group=group)


def sync_whole_grads(mesh, params) -> None:
    """Broadcast the gradients of the leaves that the rule keeps whole from
    model rank 0 to the other model ranks, in place: each rank computes them
    from the same whole tensors, and this keeps them the same bits where a
    library's backward does not repeat its bits."""
    if mesh is None or axis_size(mesh, MODEL) == 1:
        return
    from toycrystals_torch.parallel.fsdp import local

    # under FSDP2 a whole leaf's gradient is its "data" shard, the same shard
    # on every model rank of a data coordinate
    grads = [local(p.grad) for p in params if p.grad is not None and block_of(p) is None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    group = axis_group(mesh, MODEL)
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


class _GatherModel(torch.autograd.Function):
    """Every model rank's block along `dim`, in rank order; the backward keeps
    the rank's slice of the whole's gradient (the consumers of the whole have
    made it whole: module docstring)."""

    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(shard.model)]
        dist.all_gather(parts, x.contiguous(), group=shard.model_group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.shard.model, dim=ctx.dim)[ctx.shard.model_rank].contiguous(), \
            None, None


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model ranks (the
    input of a sharded consumer)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.shard.model_group)
        return g, None


class _TakeModel(torch.autograd.Function):
    """The rank's block along `dim` of a whole tensor; the backward gathers
    every rank's block gradient back into the whole's."""

    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return x.chunk(shard.model, dim=dim)[shard.model_rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        parts = [torch.empty_like(g, memory_format=torch.contiguous_format)
                 for _ in range(ctx.shard.model)]
        dist.all_gather(parts, g.contiguous(), group=ctx.shard.model_group)
        return torch.cat(parts, dim=ctx.dim), None, None


def gather_model(x: torch.Tensor, shard: spatial.Shard, dim: int) -> torch.Tensor:
    """Every model rank's block of x concatenated along `dim`; differentiable."""
    return _GatherModel.apply(x, shard, dim)


def copy_to_model(x: torch.Tensor, shard: spatial.Shard) -> torch.Tensor:
    """x as the input of a consumer sharded over "model"; differentiable."""
    return _CopyToModel.apply(x, shard)


def take_model(x: torch.Tensor, shard: spatial.Shard, dim: int) -> torch.Tensor:
    """The rank's block of a whole x along `dim`; differentiable."""
    return _TakeModel.apply(x, shard, dim)


def whole(x: torch.Tensor, ch: int, dim: int = 1) -> torch.Tensor:
    """x with all `ch` channels along `dim`: gathered over "model" in a
    dispatch that shards the channels and where x holds a block of them,
    else x itself."""
    shard = spatial.current_model()
    if shard is None or x.shape[dim] == ch:
        return x
    if x.shape[dim] * shard.model != ch:
        raise ValueError(f"a block of {x.shape[dim]} channels is no 1/{shard.model} of {ch}")
    return gather_model(x, shard, dim)


def sharded_input(x: torch.Tensor, blk: Block | None, in_ch: int,
                  dim: int = 1) -> torch.Tensor:
    """The input of a layer with `in_ch` input channels along `dim` whose
    weight holds `blk` (`param_block`): whole, and where the weight is a
    block, marked as the input of a sharded consumer (`copy_to_model`). No
    model axis: x itself."""
    shard = spatial.current_model()
    if shard is None:
        return x
    x = whole(x, in_ch, dim)
    return copy_to_model(x, shard) if blk is not None else x


def apply(layer: nn.Module, x: torch.Tensor, in_ch: int, dim: int = 1) -> torch.Tensor:
    """`layer(x)` (a conv or linear layer with `in_ch` input channels along
    `dim`) in a dispatch that may shard its weight: x gathered whole, and
    this rank's block of the output where the weight is a block."""
    return layer(sharded_input(x, param_block(layer, "weight"), in_ch, dim))


def dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`layer(x)` on the last dim, its output whole (gathered over "model"
    where the weight is a block)."""
    return whole(apply(layer, x, layer.in_features, -1), layer.out_features, -1)


def whole_param(module: nn.Module, name: str) -> torch.Tensor:
    """Parameter `name` of `module`, whole: gathered over "model" in a
    dispatch that shards it (differentiable: the rank keeps its block's
    gradient), else the parameter itself."""
    p, blk = getattr(module, name), param_block(module, name)
    shard = spatial.current_model()
    if blk is None or shard is None:
        return p
    return gather_model(p, shard, blk.dim)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """`ln(x)` on a whole x, its affine gathered where the dispatch shards it:
    the statistics are the whole width's."""
    return torch.nn.functional.layer_norm(x, ln.normalized_shape, whole_param(ln, "weight"),
                                          whole_param(ln, "bias"), ln.eps)


def shard_report(n: int, model: nn.Module, what: str = "channel counts") -> str:
    """The line the CLIs print under --shard-model (JAX's wording; the prior's
    trainer names --width)."""
    cov = tp_coverage(n, model)
    return (f"tensor parallelism: {cov:.0%} of param elements sharded"
            + (f" — check {what} divide --shard-model" if cov < 0.5 else ""))

