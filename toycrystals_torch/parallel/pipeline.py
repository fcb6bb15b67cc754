"""The pipeline axis: the FiLM prior's blocks in stages over the ranks of a mesh (GPipe).

Counterpart of toycrystals_tpu/parallel/pipeline.py. JAX stacks the blocks
[S, L / S, ...], shards the stack over "pipe" and runs one `shard_map` +
`lax.scan` over M + S - 1 ticks, handing each stage's activation to the next
with `ppermute`. Here every rank of a ("data", "pipe") mesh (parallel/mesh.py
`make_mesh_pp`) is one stage and the schedule is written out:

- `PipelineStage` holds the prior's stem (t, y -> cond, `in_proj`) and head
  (`out_norm`, `out_proj`), replicated on every stage, and its own L / S
  consecutive `FiLMResBlock`s under their global names (`blocks.{i}`), so its
  parameters, their Adam moments and its EMA are the whole prior's leaves of
  the same names, less the other stages' blocks;
- the forward (`pipeline_apply`; the stage itself is the apply function
  that JAX's `make_pipeline_apply` builds, for the train step and DDIM)
  computes the stem once for all of this
  rank's rows, splits them into M microbatches as JAX does (z_t.reshape(m,
  mb, ...)), and runs M + S - 1 ticks: at tick k stage s applies its blocks
  to microbatch k - s (stage 0 from h0, every other stage from the previous
  tick's hop), the last stage applies the head, and each stage hands its
  activation one hop on (`_hop`, paired isend/irecv over the "pipe" group).
  Every rank runs every tick and every hop, bubbles included (a bubble sends
  zeros), so the hops pair up in the same order on every rank;
- eps is the sum over "pipe" of the last stage's output and zeros elsewhere
  (JAX's masked `psum`), so every stage holds it;
- `_Pipeline` is the autograd Function of the whole schedule: its backward
  runs the ticks in reverse, each stage back-propagating its blocks for one
  microbatch and handing the input's gradient one hop back, the adjoint of
  the forward hop.

Checkpoints keep the flax layout: `stack_pipeline_params` /
`unstack_pipeline_params` are JAX's regrouping of a flax tree (numpy), and
`gather_stages` assembles the whole prior's tensors, in its order, from every
stage's blocks (the msgpack save, and the one-device fallback of the DDIM
grid). Numerics are the single-device model's up to the order of the
gradient's sums over microbatches.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from toycrystals_torch.parallel.mesh import (
    AXIS,
    PIPE,
    axis_group,
    axis_rank,
    axis_size,
    replicate,
)

HEAD_KEYS = ("out_norm", "out_proj")


def _tree_map(fn: Callable, *trees):
    if isinstance(trees[0], Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_pipeline_params(params: Mapping[str, Any], n_stages: int) -> dict:
    """A flax DiffusionPriorFiLM tree {block_0..block_{L-1}, <stem>, <head>}
    -> {"stem", "blocks", "head"}: each "blocks" leaf the L per-block leaves
    stacked and reshaped to [S, L / S, ...], stage-major (JAX's layout;
    numpy leaves). 8 blocks do not split 3 ways: ValueError."""
    blocks = sorted((k for k in params if k.startswith("block_")),
                    key=lambda k: int(k.split("_")[1]))
    n = len(blocks)
    if n == 0 or n % n_stages:
        raise ValueError(f"{n} blocks not divisible into {n_stages} stages")
    stacked = _tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]).reshape(
        (n_stages, n // n_stages) + np.shape(xs[0])), *(params[k] for k in blocks))
    return {"stem": {k: params[k] for k in params
                     if not k.startswith("block_") and k not in HEAD_KEYS},
            "blocks": stacked,
            "head": {k: params[k] for k in HEAD_KEYS}}


def unstack_pipeline_params(stacked: Mapping[str, Any]) -> dict:
    """The inverse of `stack_pipeline_params`: the flax (checkpoint) tree."""
    flat = _tree_map(lambda x: np.asarray(x).reshape((-1,) + np.shape(x)[2:]), stacked["blocks"])
    n = np.shape(next(iter(_leaves(flat))))[0]
    out = dict(stacked["stem"]) | dict(stacked["head"])
    for i in range(n):
        out[f"block_{i}"] = _tree_map(lambda x: x[i], flat)
    return out


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@dataclasses.dataclass(frozen=True)
class Stage:
    """This rank's place in the pipeline: stage `rank` of `size` over the
    "pipe" `group` (gloo or nccl: `backend`), holding blocks [rank per_stage,
    (rank + 1) per_stage)."""

    group: object
    size: int
    rank: int
    per_stage: int
    backend: str

    def peer(self, stage: int) -> int:
        """The global rank of `stage` on this rank's pipe line."""
        return dist.get_global_rank(self.group, stage)

    @property
    def first(self) -> int:
        return self.rank * self.per_stage

    @property
    def last(self) -> bool:
        return self.rank == self.size - 1


def stage_of(t: torch.Tensor) -> Stage | None:
    """The `Stage` whose block a tensor of a pipelined state belongs to, or
    None (a leaf of the stem or the head, replicated over "pipe")."""
    return getattr(t, "pipe_stage", None)


def _tag(t: torch.Tensor, stage: Stage | None) -> torch.Tensor:
    if stage is not None:
        t.pipe_stage = stage
    return t


def _block_key(key: str) -> tuple[int, str] | None:
    """'blocks.5.fc1.weight' -> (5, 'fc1.weight'); None for other keys."""
    parts = key.split(".", 2)
    if len(parts) == 3 and parts[0] == "blocks" and parts[1].isdigit():
        return int(parts[1]), parts[2]
    return None


class PipelineStage(nn.Module):
    """One stage of the pipelined FiLM prior: the stem and the head of
    `prior` and its blocks [first, first + per_stage), under the prior's own
    names, in the prior's order. forward(z_t, t, y_cat, y_cont) -> eps [b,
    z_dim] of this rank's b rows, the same on every stage (`pipeline_apply`).
    The module holds the prior's own submodules (no copy)."""

    def __init__(self, prior: nn.Module, stage: Stage, n_micro: int, data_group=None,
                 n_data: int = 1):
        super().__init__()
        from toycrystals_torch.models.diffusion_prior import DiffusionPriorFiLM
        from toycrystals_torch.models.moe_prior import DiffusionPriorMoE

        if not isinstance(prior, DiffusionPriorFiLM) or isinstance(prior, DiffusionPriorMoE):
            raise ValueError("the pipelined forward is the dense FiLM prior")
        if n_micro < 1:
            raise ValueError(f"n_micro must be >= 1, got {n_micro}")
        self.stage, self.n_micro = stage, int(n_micro)
        self.data_group, self.n_data = data_group, int(n_data)
        self.z_dim, self.t_emb_dim = prior.z_dim, prior.t_emb_dim
        self.register_buffer("t_freqs", prior.t_freqs, persistent=False)
        self.t_mlp, self.y_cat_emb, self.y_cont_mlp = prior.t_mlp, prior.y_cat_emb, prior.y_cont_mlp
        self.y_fuse, self.in_proj = prior.y_fuse, prior.in_proj
        self.blocks = nn.ModuleDict({str(i): prior.blocks[i] for i in
                                     range(stage.first, stage.first + stage.per_stage)})
        self.out_norm, self.out_proj = prior.out_norm, prior.out_proj
        for p in self.blocks.parameters():
            _tag(p, stage)
        self.hop_seconds, self.hops = 0.0, 0  # time spent in `_hop`, and its calls

    def run_blocks(self, h: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        for block in self.blocks.values():
            h = block(h, cond)
        return h

    def schedule_params(self) -> list[nn.Parameter]:
        """The parameters inside the schedule: the blocks', and the head's on
        the last stage."""
        ps = list(self.blocks.parameters())
        if self.stage.last:
            ps += [*self.out_norm.parameters(), *self.out_proj.parameters()]
        return ps

    def forward(self, z_t, t, y_cat, y_cont) -> torch.Tensor:
        return pipeline_apply(self, z_t, t, y_cat, y_cont)

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """After the backward: the stem's and the head's gradients summed over
        "pipe" (each stage holds its part: cond feeds every stage's blocks,
        h0 only stage 0's, the head only the last stage's; JAX's transpose of
        a replicated input), then every gradient averaged over "data". Not
        a mean over "pipe": every stage's share is a different part of the
        one-device gradient."""
        params = list(self.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _all_reduce_flat([p.grad for p in params if stage_of(p) is None], self.stage.group)
        if self.data_group is not None and self.n_data > 1:
            grads = [p.grad for p in params]
            _all_reduce_flat(grads, self.data_group)
            torch._foreach_div_(grads, float(self.n_data))


def _all_reduce_flat(tensors: list[torch.Tensor], group) -> None:
    """Sum each tensor over `group` in place, in one all-reduce."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    torch._foreach_copy_(tensors, [f.view_as(t) for f, t in
                                   zip(flat.split([t.numel() for t in tensors]), tensors)])


def _hop(mod: PipelineStage, x: torch.Tensor, forward: bool) -> torch.Tensor | None:
    """One hop along the pipe line: send `x` to the next stage (the previous
    one when not `forward`) and return what the other neighbour sent (None
    at the line's end). Paired isend/irecv over the "pipe" group; gloo's
    send and recv take CPU tensors only, so under gloo a CUDA tensor goes by
    the host. The backward's hop (forward=False) is the adjoint of the
    forward's: the gradient of what a stage received goes back to its
    sender."""
    st = mod.stage
    dst, src = (st.rank + 1, st.rank - 1) if forward else (st.rank - 1, st.rank + 1)
    host = st.backend == "gloo" and x.device.type != "cpu"
    ops, got = [], None
    t0 = time.perf_counter()
    if 0 <= dst < st.size:
        buf = x.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, buf.cpu() if host else buf, st.peer(dst), st.group))
    if 0 <= src < st.size:
        got = torch.empty(x.shape, dtype=x.dtype, device="cpu" if host else x.device)
        ops.append(dist.P2POp(dist.irecv, got, st.peer(src), st.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if got is not None and host:
        got = got.to(x.device)
    mod.hop_seconds += time.perf_counter() - t0
    mod.hops += 1
    return got


def _split(mod: PipelineStage, a: torch.Tensor) -> torch.Tensor:
    b, m = a.shape[0], mod.n_micro
    if b % m:
        raise ValueError(f"batch {b} of this rank must divide by n_micro {m}")
    return a.reshape((m, b // m) + a.shape[1:])


def _run_schedule(mod: PipelineStage, h0: torch.Tensor, cond: torch.Tensor,
                  graphs: dict | None) -> torch.Tensor:
    """The forward ticks (module docstring); with `graphs`, each microbatch's
    blocks (and head) run on leaves that require grad, and graphs[mi] keeps
    (input, cond, output) for the backward. Returns eps [b, z_dim], summed
    over "pipe" from the last stage's outputs."""
    from toycrystals_torch.models.diffusion_prior import film_head

    st, m = mod.stage, mod.n_micro
    h0s, conds = _split(mod, h0), _split(mod, cond)
    outs: list[torch.Tensor | None] = [None] * m
    recv = None
    for k in range(m + st.size - 1):
        mi = k - st.rank
        y = None
        if 0 <= mi < m:
            x, c = (h0s[mi] if st.rank == 0 else recv), conds[mi]
            with torch.enable_grad() if graphs is not None else torch.no_grad():
                if graphs is not None:
                    x, c = x.detach().requires_grad_(True), c.detach().requires_grad_(True)
                y = mod.run_blocks(x, c)
                if st.last:
                    outs[mi] = film_head(mod, y)
            if graphs is not None:
                graphs[mi] = (x, c, outs[mi] if st.last else y)
        # every tick, bubbles included: a bubble hands on zeros
        recv = _hop(mod, (y if y is not None else h0s[0].new_zeros(h0s[0].shape)).detach(),
                    forward=True)
    b = h0.shape[0]
    out = (torch.cat([o.detach() for o in outs]) if st.last
           else h0.new_zeros((b, mod.z_dim)))
    # the masked psum over "pipe": every stage gets the last stage's eps
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=st.group)
    return out


class _Pipeline(torch.autograd.Function):
    """The whole schedule as one differentiable call: (h0, cond, the
    schedule's parameters) -> eps, the same on every stage.

    The adjoint of a replicated output: eps is the sum over "pipe" of the last
    stage's output, and every stage computes the loss from it, so every stage
    receives the same cotangent. Summing those over "pipe" again (an
    all-reduce's usual adjoint) would make every gradient S times too large;
    as under JAX's `shard_map`, the cotangent reaches the last stage once:
    the backward uses this rank's own cotangent (identity), and only on the
    last stage, the one whose output the sum carried."""

    @staticmethod
    def forward(ctx, mod, h0, cond, *params):
        graphs: dict = {}
        eps = _run_schedule(mod, h0, cond, graphs)
        ctx.mod, ctx.graphs, ctx.params = mod, graphs, params
        ctx.h0_like, ctx.cond_like = h0.detach(), cond.detach()
        return eps

    @staticmethod
    def backward(ctx, g_eps):
        mod, graphs, params = ctx.mod, ctx.graphs, ctx.params
        st, m = mod.stage, mod.n_micro
        g_eps = _split(mod, g_eps)
        g_h0 = torch.zeros_like(ctx.h0_like) if st.rank == 0 else None
        g_cond = torch.zeros_like(ctx.cond_like)
        g_h0s = None if g_h0 is None else _split(mod, g_h0)
        g_conds = _split(mod, g_cond)
        g_params: list[torch.Tensor | None] = [None] * len(params)
        zeros = torch.zeros_like(_split(mod, ctx.h0_like)[0])
        recv = None  # the gradient of this stage's output, from the next stage
        for k in reversed(range(m + st.size - 1)):
            mi = k - st.rank
            g_x = None
            if 0 <= mi < m:
                x, c, o = graphs.pop(mi)
                g_o = g_eps[mi] if st.last else recv
                grads = torch.autograd.grad(o, [x, c, *params], g_o, allow_unused=True)
                g_x = grads[0]
                g_conds[mi] += grads[1]
                for i, g in enumerate(grads[2:]):
                    if g is not None:
                        g_params[i] = g if g_params[i] is None else g_params[i] + g
                if g_h0s is not None:
                    g_h0s[mi] = g_x
            recv = _hop(mod, g_x if g_x is not None and st.rank > 0 else zeros, forward=False)
        return (None, g_h0, g_cond, *g_params)


def pipeline_apply(mod: PipelineStage, z_t, t, y_cat, y_cont) -> torch.Tensor:
    """The pipelined DiffusionPriorFiLM forward on this rank's rows: eps [b,
    z_dim], the same on every stage of the rank's pipe line. The stem runs
    once for all microbatches on every stage; differentiable (`_Pipeline`),
    so the same call trains and samples. b must divide by the stage's
    n_micro (the global batch by data x n_micro, as in JAX)."""
    from toycrystals_torch.models.diffusion_prior import film_stem

    h0, cond = film_stem(mod, z_t, t, y_cat, y_cont)
    if torch.is_grad_enabled():
        return _Pipeline.apply(mod, h0, cond, *mod.schedule_params())
    return _run_schedule(mod, h0, cond, None)


def make_stage(mesh, prior: nn.Module, n_micro: int) -> PipelineStage:
    """This rank's `PipelineStage` of `prior` on a ("data", "pipe") mesh; the
    prior's blocks must split evenly over the stages."""
    n_pipe = axis_size(mesh, PIPE)
    if prior.n_blocks % n_pipe:
        raise ValueError(f"{prior.n_blocks} blocks not divisible into {n_pipe} stages")
    group = axis_group(mesh, PIPE)
    stage = Stage(group, n_pipe, axis_rank(mesh, PIPE), prior.n_blocks // n_pipe,
                  dist.get_backend(group))
    n_data = axis_size(mesh, AXIS)
    return PipelineStage(prior, stage, n_micro, axis_group(mesh, AXIS) if n_data > 1 else None,
                         n_data)


def place_pipeline_state(mesh, prior: nn.Module, state, n_micro: int = 1):
    """Place the FiLM prior and its `TrainState` on a ("data", "pipe") mesh:
    every rank takes rank 0's whole prior, moments and EMA, then keeps the
    stem, the head and its stage's blocks (`make_stage`), with the moments and
    the EMA of those leaves only, each block's tagged with its `Stage`.
    Returns (the stage, to train and sample through, the state)."""
    opt = state.opt_state
    replicate(mesh, [*prior.parameters(), *prior.buffers(), *opt.mu, *opt.nu,
                     *(state.ema_params or {}).values()])
    names = list(state.params)
    if names != [k for k, _ in prior.named_parameters()]:
        raise ValueError("the state's parameters are not the model's")
    mod = make_stage(mesh, prior, n_micro)
    params = dict(mod.named_parameters())
    keep = [i for i, k in enumerate(names) if k in params]
    mu = [_tag(opt.mu[i], stage_of(params[names[i]])) for i in keep]
    nu = [_tag(opt.nu[i], stage_of(params[names[i]])) for i in keep]
    ema = (None if state.ema_params is None else
           {k: _tag(v, stage_of(params[k])) for k, v in state.ema_params.items() if k in params})
    return mod, dataclasses.replace(state, params=params,
                                    opt_state=dataclasses.replace(opt, mu=mu, nu=nu),
                                    ema_params=ema)


def gather_stages(tensors: Mapping[str, torch.Tensor],
                  tags: Mapping[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
    """The whole prior's tensors, in its order, from every stage's (a
    collective over "pipe"; the stem's and head's are this rank's own). A
    tensor is a stage's block where it, or `tags[key]` (its parameter, for a
    gradient), carries a `Stage`; with none, `tensors` come back as they
    are."""
    def stage(k):
        return stage_of(tensors[k] if tags is None else tags[k])

    local = [k for k in tensors if stage(k) is not None]
    if not local:
        return dict(tensors)
    st = stage(local[0])
    blocks: dict[int, list[tuple[str, torch.Tensor]]] = {}
    for k in local:
        i, rest = _block_key(k)
        t = tensors[k].detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(st.size)]
        dist.all_gather(parts, t, group=st.group)
        for r, part in enumerate(parts):
            blocks.setdefault(i - st.first + r * st.per_stage, []).append((rest, part))
    out = {}
    for k, t in tensors.items():
        if stage(k) is None:
            out[k] = t
        elif k == local[0]:
            for i in sorted(blocks):
                for rest, part in blocks[i]:
                    out[f"blocks.{i}.{rest}"] = part
    return out
