"""The latent diffusion prior: the FiLM eps-MLP, the DDPM schedule and DDIM.

Counterpart of toycrystals_tpu/models/diffusion_prior.py:

- `timestep_embedding_discrete`: the sinusoidal embedding of integer t,
  sin first (the score model's continuous embedding is cos first). Its
  frequencies (`discrete_freqs`) are exp(-linspace(0, ln 1e4, half)), the
  linspace taken in f64 and rounded to f32, which gives JAX's f32 values; the
  priors keep them as a buffer, since a host-to-device copy per forward
  would make every step wait for the card.
- `FiLMResBlock` / `DiffusionPriorFiLM`: the trained prior. The submodules
  carry the names of the original torch implementation's state_dict
  (`t_mlp.0/2`, `y_cat_emb`, `y_cont_mlp.0/2`, `y_fuse.0/2`, `in_proj`,
  `blocks.i.{norm,cond,fc1,fc2}`, `out_norm`, `out_proj`), so its
  `diffusion_prior_*.pt` loads with `load_state_dict` as it is;
  utils/params.py maps them onto the flax tree.
- `DiffusionPrior`: the plain 4-layer ReLU MLP, kept for API parity.
- `DiffusionSchedule`: the linear-beta DDPM constants on an explicit device,
  with `q_sample`; `from_arrays` builds it from given betas and alpha_bars.
- `ddim_timesteps` (numpy, on the host) and `ddim_sample`: deterministic
  DDIM (eta 0; any other eta raises, as in JAX), a Python loop over the
  deduplicated timesteps that returns the last step's z0 prediction.

LayerNorms use flax's epsilon 1e-6; torch computes the variance in two
passes where flax takes E[x^2] - E[x]^2, a difference of rounding only. The
math is f32: the JAX module's `dtype` knob is not ported.

Under a "model" axis (parallel/tensor.py; the train step's dispatch scope)
every dense layer and embedding whose weight the trailing-dim rule shards
gives the rank's block of its output features from the whole input, and the
residual stream, the conditioning vector and every concat are whole: each
block is gathered where it is consumed. Two consumers need the whole first:
a block's FiLM chunk of its `cond` output (JAX's contiguous block puts all
of gamma on one rank and all of beta on the other at M = 2), and the
LayerNorms, which normalise over the whole width and gather their sharded
affine (`tp.layer_norm`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from toycrystals_torch.parallel import tensor as tp
from toycrystals_torch.utils.rng import randn

LN_EPS = 1e-6  # flax.linen.LayerNorm's epsilon


def discrete_freqs(dim: int) -> torch.Tensor:
    """exp(-linspace(0, ln 1e4, dim // 2)), f32 on the CPU."""
    return torch.exp(-torch.from_numpy(
        np.linspace(0.0, math.log(10_000.0), dim // 2).astype(np.float32)))


def timestep_embedding_discrete(t: torch.Tensor, dim: int,
                                freqs: torch.Tensor | None = None) -> torch.Tensor:
    """[sin(t f), cos(t f)] for integer t [B], f = `freqs` (default
    `discrete_freqs(dim)`, copied to t's device); a zero column is appended
    when dim is odd."""
    if freqs is None:
        freqs = discrete_freqs(dim).to(t.device)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def y_vec(y_cat: torch.Tensor, y_cont: torch.Tensor, n_types: int) -> torch.Tensor:
    """one_hot(y_cat) ++ y_cont, f32."""
    return torch.cat([F.one_hot(y_cat.long(), n_types).float(), y_cont.float()], dim=1)


def _mlp(d_in: int, d_hidden: int, d_out: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(d_in, d_hidden), nn.SiLU(), nn.Linear(d_hidden, d_out))


def silu_mlp(first: nn.Linear, second: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """second(silu(first(x))), its output whole: under a model axis the SiLU
    runs on the hidden layer's block, which the second layer gathers."""
    return tp.dense(second, F.silu(tp.apply(first, x, first.in_features, -1)))


class FiLMResBlock(nn.Module):
    """LayerNorm -> FiLM (gamma, beta from the cond vector) -> MLP (mult x
    width, SiLU) -> residual."""

    def __init__(self, width: int, cond_dim: int, mult: int = 4):
        super().__init__()
        self.norm = nn.LayerNorm(width, eps=LN_EPS)
        self.cond = nn.Linear(cond_dim, 2 * width)
        self.fc1 = nn.Linear(width, mult * width)
        self.fc2 = nn.Linear(mult * width, width)

    def film(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        gamma, beta = tp.dense(self.cond, cond).chunk(2, dim=-1)  # whole before the chunk
        return tp.layer_norm(self.norm, x) * (1.0 + gamma) + beta

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return x + silu_mlp(self.fc1, self.fc2, self.film(x, cond))


class DiffusionPriorFiLM(nn.Module):
    """eps-prediction residual MLP, FiLM-conditioned on (t, y).
    forward(z_t [B, z_dim], t [B] int, y_cat [B], y_cont [B, y_cont_dim]) ->
    eps [B, z_dim] f32."""

    def __init__(self, z_dim: int, n_types: int, y_cont_dim: int, t_emb_dim: int = 64,
                 width: int = 256, n_blocks: int = 6, y_cat_emb_dim: int = 64):
        super().__init__()
        self.z_dim, self.n_types, self.y_cont_dim = z_dim, n_types, y_cont_dim
        self.t_emb_dim, self.width, self.n_blocks = t_emb_dim, width, n_blocks
        self.register_buffer("t_freqs", discrete_freqs(t_emb_dim), persistent=False)
        self.t_mlp = _mlp(t_emb_dim, width, width)
        self.y_cat_emb = nn.Embedding(n_types, y_cat_emb_dim)
        self.y_cont_mlp = _mlp(y_cont_dim, y_cat_emb_dim, y_cat_emb_dim)
        self.y_fuse = _mlp(2 * y_cat_emb_dim, width, width)
        self.in_proj = nn.Linear(z_dim, width)
        self.blocks = nn.ModuleList(self._block(i) for i in range(n_blocks))
        self.out_norm = nn.LayerNorm(width, eps=LN_EPS)
        self.out_proj = nn.Linear(width, z_dim)

    def _block(self, i: int) -> nn.Module:
        return FiLMResBlock(self.width, 2 * self.width)

    def cond(self, t: torch.Tensor, y_cat: torch.Tensor, y_cont: torch.Tensor) -> torch.Tensor:
        """The FiLM conditioning vector [B, 2 width]: t features ++ y features."""
        return film_cond(self, t, y_cat, y_cont)

    def forward(self, z_t, t, y_cat, y_cont) -> torch.Tensor:
        h, cond = film_stem(self, z_t, t, y_cat, y_cont)
        for block in self.blocks:
            h = block(h, cond)
        return film_head(self, h)


# The stem and the head as calls on any module that holds their layers under
# the prior's names: the prior itself, or a pipeline stage
# (parallel/pipeline.py), which holds them beside its share of the blocks.


def film_cond(m: nn.Module, t: torch.Tensor, y_cat: torch.Tensor,
              y_cont: torch.Tensor) -> torch.Tensor:
    """The FiLM conditioning vector [B, 2 width] of `m`'s t_mlp, y_cat_emb,
    y_cont_mlp and y_fuse: t features ++ y features."""
    t_feat = silu_mlp(m.t_mlp[0], m.t_mlp[2],
                      timestep_embedding_discrete(t, m.t_emb_dim, m.t_freqs))
    emb = tp.whole(m.y_cat_emb(y_cat.long()), m.y_cat_emb.embedding_dim, -1)
    cont = silu_mlp(m.y_cont_mlp[0], m.y_cont_mlp[2], y_cont.float())
    y_feat = torch.cat([emb, cont], dim=-1)
    return torch.cat([t_feat, silu_mlp(m.y_fuse[0], m.y_fuse[2], y_feat)], dim=-1)


def film_stem(m: nn.Module, z_t, t, y_cat, y_cont) -> tuple[torch.Tensor, torch.Tensor]:
    """(h0 = in_proj(z_t) [B, width], cond [B, 2 width]): what the blocks
    start from."""
    cond = film_cond(m, t, y_cat, y_cont)
    return tp.dense(m.in_proj, z_t.float()), cond


def film_head(m: nn.Module, h: torch.Tensor) -> torch.Tensor:
    """eps [B, z_dim] = out_proj(out_norm(h))."""
    return tp.dense(m.out_proj, tp.layer_norm(m.out_norm, h))


class DiffusionPrior(nn.Module):
    """The plain variant: [z_t, one_hot(y_cat), y_cont, temb] -> 3 x (Linear,
    ReLU) -> Linear. `net.0/2/4/6` are the flax `Dense_0..3`."""

    def __init__(self, z_dim: int, n_types: int, y_cont_dim: int, t_emb_dim: int = 64,
                 width: int = 256):
        super().__init__()
        self.n_types, self.t_emb_dim = n_types, t_emb_dim
        self.register_buffer("t_freqs", discrete_freqs(t_emb_dim), persistent=False)
        d_in = z_dim + n_types + y_cont_dim + t_emb_dim
        self.net = nn.Sequential(nn.Linear(d_in, width), nn.ReLU(), nn.Linear(width, width),
                                 nn.ReLU(), nn.Linear(width, width), nn.ReLU(),
                                 nn.Linear(width, z_dim))

    def forward(self, z_t, t, y_cat, y_cont) -> torch.Tensor:
        h = torch.cat([z_t.float(), y_vec(y_cat, y_cont, self.n_types),
                       timestep_embedding_discrete(t, self.t_emb_dim, self.t_freqs)], dim=1)
        return self.net(h)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The DDPM constants of a beta schedule, f32 tensors on one device."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alpha_bars: torch.Tensor
    sqrt_alpha_bars: torch.Tensor
    sqrt_one_minus_alpha_bars: torch.Tensor

    @staticmethod
    def from_arrays(betas, alpha_bars, device=None) -> "DiffusionSchedule":
        """The schedule of the given betas and alpha_bars (numpy or tensors);
        alphas and the square roots are derived, in f32."""
        betas = torch.as_tensor(betas, dtype=torch.float32, device=device)
        alpha_bars = torch.as_tensor(alpha_bars, dtype=torch.float32, device=device)
        return DiffusionSchedule(betas, 1.0 - betas, alpha_bars, torch.sqrt(alpha_bars),
                                 torch.sqrt(1.0 - alpha_bars))

    @staticmethod
    def linear(T: int, beta_start: float, beta_end: float, device=None) -> "DiffusionSchedule":
        """Betas linear from beta_start to beta_end over T steps, alpha_bars
        their cumulative product, in f32 (within 2e-6 relative of JAX's
        bits: XLA's cumprod associates differently)."""
        betas = torch.linspace(beta_start, beta_end, T, dtype=torch.float32, device=device)
        return DiffusionSchedule.from_arrays(betas, torch.cumprod(1.0 - betas, dim=0), device)

    @property
    def T(self) -> int:
        return int(self.betas.shape[0])

    def q_sample(self, z0: torch.Tensor, t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """z_t = sqrt(abar_t) z0 + sqrt(1 - abar_t) eps."""
        t = t.long()
        a, b = self.sqrt_alpha_bars[t][:, None], self.sqrt_one_minus_alpha_bars[t][:, None]
        return a * z0 + b * eps


def ddim_timesteps(T: int, n_steps: int) -> np.ndarray:
    """Descending timesteps: round(linspace(T - 1, 0, n_steps)), consecutive
    duplicates dropped."""
    ts = np.round(np.linspace(T - 1, 0, n_steps)).astype(np.int64)
    keep = np.ones(len(ts), bool)
    keep[1:] = ts[1:] != ts[:-1]
    return ts[keep]


@torch.no_grad()
def ddim_sample(model, sched: DiffusionSchedule, y_cat: torch.Tensor, y_cont: torch.Tensor,
                n_steps: int, z_dim: int, generator: torch.Generator | None = None,
                z: torch.Tensor | None = None, eta: float = 0.0) -> torch.Tensor:
    """Deterministic DDIM over `ddim_timesteps(sched.T, n_steps)`.

    `model(z_t, t, y_cat, y_cont) -> eps`. The start noise is `z` [B, z_dim]
    when given, else drawn from `generator` on the conditions' device.
    Returns the last step's z0 prediction [B, z_dim]."""
    if eta != 0.0:
        raise NotImplementedError("eta != 0 not implemented (parity with the reference)")
    b, device = y_cat.shape[0], y_cat.device
    if z is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or the start noise z; DDIM never draws "
                             "from the global generator")
        z = randn((b, z_dim), generator, device)
    z = z.to(device=device, dtype=torch.float32)
    ts = ddim_timesteps(sched.T, n_steps)
    for i, t in enumerate(ts):
        tb = torch.full((b,), int(t), dtype=torch.int32, device=device)
        eps = model(z, tb, y_cat, y_cont)
        abar = sched.alpha_bars[int(t)]
        z0 = (z - torch.sqrt(1.0 - abar) * eps) / (torch.sqrt(abar) + 1e-8)
        if i == len(ts) - 1:
            return z0
        abar_prev = sched.alpha_bars[int(ts[i + 1])]
        z = torch.sqrt(abar_prev) * z0 + torch.sqrt(1.0 - abar_prev) * eps
    raise ValueError("n_steps must be >= 1")
