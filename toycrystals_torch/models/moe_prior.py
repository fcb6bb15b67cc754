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
  are averaged over the ranks, p_e by a differentiable all-reduce, so the
  term and its gradient are those of the unsharded batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from toycrystals_torch.models.diffusion_prior import LN_EPS, DiffusionPriorFiLM
from toycrystals_torch.parallel.mesh import all_reduce_sum


class MoEFiLMResBlock(nn.Module):
    """LayerNorm -> FiLM -> switch-routed expert MLPs -> residual.
    forward(x, cond) -> (x + out, moe_aux, route_fraction)."""

    def __init__(self, width: int, cond_dim: int, n_experts: int, mult: int = 4):
        super().__init__()
        d, f, e = width, mult * width, n_experts
        self.n_experts = e
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.cond = nn.Linear(cond_dim, 2 * d)
        self.router = nn.Linear(cond_dim, e)
        self.w1 = nn.Parameter(torch.zeros(e, d, f))
        self.b1 = nn.Parameter(torch.zeros(e, f))
        self.w2 = nn.Parameter(torch.zeros(e, f, d))
        self.b2 = nn.Parameter(torch.zeros(e, d))

    def forward(self, x: torch.Tensor, cond: torch.Tensor, mesh=None):
        gamma, beta = self.cond(cond).chunk(2, dim=-1)
        h = self.norm(x) * (1.0 + gamma) + beta
        probs = torch.softmax(self.router(cond.float()), dim=-1)        # [B, E]
        onehot = F.one_hot(probs.argmax(dim=-1), self.n_experts).to(probs.dtype)
        combine = onehot * (probs * onehot).sum(dim=-1, keepdim=True)
        f_e, p_e = onehot.mean(dim=0), probs.mean(dim=0)
        if mesh is not None and mesh.size() > 1:
            from torch.distributed.nn.functional import all_reduce

            f_e = all_reduce_sum(mesh, f_e) / mesh.size()
            p_e = all_reduce(p_e, group=mesh.get_group()) / mesh.size()
        aux = self.n_experts * (f_e * p_e).sum()
        he = torch.einsum("bd,edf->ebf", h, self.w1) + self.b1[:, None, :]   # [E, B, f]
        he = torch.einsum("ebf,efd->ebd", F.silu(he), self.w2) + self.b2[:, None, :]
        return x + torch.einsum("ebd,be->bd", he, combine), aux, f_e


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
        cond = self.cond(t, y_cat, y_cont)
        h = self.in_proj(z_t.float())
        stats: dict[str, list[torch.Tensor]] = {"moe_aux": [], "route_fraction": []}
        for block in self.blocks:
            h, aux, frac = block(h, cond, mesh)
            stats["moe_aux"].append(aux)
            stats["route_fraction"].append(frac)
        eps = self.out_proj(self.out_norm(h))
        return (eps, stats) if return_stats else eps
