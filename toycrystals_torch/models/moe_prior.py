"""The mixture-of-experts latent diffusion prior.

Counterpart of toycrystals_tpu/models/moe_prior.py. `DiffusionPriorMoE` is
`DiffusionPriorFiLM` (models/diffusion_prior.py) with each block's MLP
replaced by `n_experts` switch-routed expert MLPs (`MoEFiLMResBlock`):

- the router is switch top-1 on the FiLM conditioning vector: an f32
  `Linear` (`router`) on the f32 cond, softmax, argmax (ties go to the first
  expert, as in JAX); combine = onehot * p_top, the straight-through path
  that gives the router its gradient;
- dispatch is dense: every expert computes every row, and the combine
  selects. The stacked weights keep the flax layout and names: `w1` [E, d,
  f], `b1` [E, f], `w2` [E, f, d], `b2` [E, d];
- the load-balancing term E * sum_e f_e p_e (f_e the share of rows routed to
  expert e, p_e the mean router probability) and `route_fraction` f_e, which
  the JAX module sows into its `losses` and `intermediates` collections, are
  returned here: `forward(..., return_stats=True)` gives (eps, {"moe_aux":
  [one 0-d tensor per block], "route_fraction": [one [E] tensor per
  block]}). The module keeps no state between calls;
- on a data mesh (`forward(..., mesh=)`, each rank holding its rows of the
  batch) f_e and p_e are the global batch's, as under JAX's GSPMD: both means
  are averaged over the ranks of the "data" axis (the model ranks of a data
  coordinate hold the same rows), p_e by a differentiable all-reduce, so the
  term and its gradient are those of the unsharded batch;
- under a "model" axis (parallel/tensor.py) the FiLM stem and head run as
  models/diffusion_prior.py says, the router's E logits are gathered before
  the softmax and the argmax, and the experts' weights are sharded on their
  trailing dims: each rank computes its block of the f hidden features, the
  second layer gathers them and gives its block of the d outputs, which the
  combine gathers;
- under an "expert" axis (parallel/expert.py) each rank holds E / N experts
  of every block (`expert_block`, this rank's `Block` of the stacks): it
  runs them on all of its rows, weights them by its columns of `combine`,
  and the partial outputs are summed over "expert".
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from toycrystals_torch.models.diffusion_prior import (
    LN_EPS,
    DiffusionPriorFiLM,
    film_head,
    film_stem,
)
from toycrystals_torch.parallel import spatial
from toycrystals_torch.parallel import tensor as tp
from toycrystals_torch.parallel.expert import copy_to_expert, reduce_from_expert
from toycrystals_torch.parallel.mesh import replica_group


class MoEFiLMResBlock(nn.Module):
    """LayerNorm -> FiLM -> switch-routed expert MLPs -> residual.
    forward(x, cond) -> (x + out, moe_aux, route_fraction)."""

    def __init__(self, width: int, cond_dim: int, n_experts: int, mult: int = 4):
        super().__init__()
        d, f, e = width, mult * width, n_experts
        self.n_experts, self.width, self.hidden = e, d, f
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.cond = nn.Linear(cond_dim, 2 * d)
        self.router = nn.Linear(cond_dim, e)
        self.w1 = nn.Parameter(torch.zeros(e, d, f))
        self.b1 = nn.Parameter(torch.zeros(e, f))
        self.w2 = nn.Parameter(torch.zeros(e, f, d))
        self.b2 = nn.Parameter(torch.zeros(e, d))

    def forward(self, x: torch.Tensor, cond: torch.Tensor, mesh=None):
        gamma, beta = tp.dense(self.cond, cond).chunk(2, dim=-1)
        h = tp.layer_norm(self.norm, x) * (1.0 + gamma) + beta
        probs = torch.softmax(tp.dense(self.router, cond.float()), dim=-1)  # [B, E]
        onehot = F.one_hot(probs.argmax(dim=-1), self.n_experts).to(probs.dtype)
        combine = onehot * (probs * onehot).sum(dim=-1, keepdim=True)
        f_e, p_e = onehot.mean(dim=0), probs.mean(dim=0)
        if mesh is not None and mesh.size() > 1:
            import torch.distributed as dist
            from torch.distributed.nn.functional import all_reduce

            group, n = replica_group(mesh)
            f_e = f_e.clone()
            dist.all_reduce(f_e, group=group)
            f_e, p_e = f_e / n, all_reduce(p_e, group=group) / n
        aux = self.n_experts * (f_e * p_e).sum()
        d, f, shard = self.width, self.hidden, spatial.current_model()
        ep = getattr(self, "expert_block", None)  # this rank's experts (parallel/expert.py)
        if ep is not None:
            # h and combine enter the rank's experts, each of which gives only
            # its share of their gradients: summed over "expert" in the backward
            k = self.n_experts // ep.size
            h = copy_to_expert(h, ep)
            combine = copy_to_expert(combine, ep)[:, ep.rank * k:(ep.rank + 1) * k]
        h = tp.sharded_input(h, tp.param_block(self, "w1"), d, -1)
        he = torch.einsum("bd,edf->ebf", h, self.w1) + self.b1[:, None, :]   # [E, B, f]
        second = tp.param_block(self, "w2")
        he = tp.sharded_input(F.silu(he), second, f, -1)
        he = torch.einsum("ebf,efd->ebd", he, self.w2) + self.b2[:, None, :]
        if second is not None and shard is not None:  # the combine's share of each block
            combine = tp.copy_to_model(combine, shard)
        out = torch.einsum("ebd,be->bd", he, combine)
        if ep is not None:
            # the sum over "expert" of the experts' partial outputs; its adjoint
            # is the identity, since every expert rank's loss is the same
            out = reduce_from_expert(out, ep)
        return x + tp.whole(out, d, -1), aux, f_e


class DiffusionPriorMoE(DiffusionPriorFiLM):
    """The FiLM prior's stem and head around `n_blocks` MoE blocks.
    forward(z_t, t, y_cat, y_cont, return_stats=False, mesh=None) -> eps, or
    (eps, {"moe_aux": [...], "route_fraction": [...]}) with one entry per
    block; on a `mesh` the statistics are the global batch's."""

    def __init__(self, z_dim: int, n_types: int, y_cont_dim: int, n_experts: int = 4,
                 t_emb_dim: int = 64, width: int = 256, n_blocks: int = 6,
                 y_cat_emb_dim: int = 64):
        self.n_experts = n_experts
        super().__init__(z_dim, n_types, y_cont_dim, t_emb_dim, width, n_blocks, y_cat_emb_dim)

    def _block(self, i: int) -> nn.Module:
        return MoEFiLMResBlock(self.width, 2 * self.width, self.n_experts)

    def forward(self, z_t, t, y_cat, y_cont, return_stats: bool = False, mesh=None):
        h, cond = film_stem(self, z_t, t, y_cat, y_cont)
        stats: dict[str, list[torch.Tensor]] = {"moe_aux": [], "route_fraction": []}
        for block in self.blocks:
            h, aux, frac = block(h, cond, mesh)
            stats["moe_aux"].append(aux)
            stats["route_fraction"].append(frac)
        eps = film_head(self, h)
        return (eps, stats) if return_stats else eps
