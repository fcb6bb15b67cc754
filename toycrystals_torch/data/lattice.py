"""Procedural toy-crystal lattice geometry, batched over items, in PyTorch.

Counterpart of toycrystals_tpu/data/lattice.py. Shapes are static: the index
grid is a padded buffer sized for the worst case over the parameter ranges,
and invalid, vacated or cropped points get weight 0 instead of being removed.
Where the JAX module handles one item and is vmapped, every function here
takes a leading batch axis B.

Random draws. JAX derives an item's draws from `fold_in(key(seed), idx)`,
which torch cannot reproduce. Here every draw is a counter-based hash of
(seed, idx, stream, counter) computed in tensor ops, so an item is
deterministic per (seed, idx) whatever batch it sits in and whatever device
renders it: the integer hash is exact on both, and only the float functions
after it (log, cos, sin) may differ in the last bit between CPU and GPU. The
distributions are JAX's; the numbers are not. Every function that draws also
takes its draws as an argument, so tests can feed JAX's own.

Lattice types: 0 = square, 1 = rectangular (random aspect), 2 = triangular,
3 = honeycomb (triangular with a 2-atom basis).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

_M32 = 0xFFFFFFFF
# Streams of the per-item hash: the six parameter draws, then the per-point ones.
_PARAM_STREAMS = ("lattice_type", "a", "theta", "vacancy", "jitter", "aspect")
_S_VACANCY, _S_JITTER_R, _S_JITTER_PHI = 6, 7, 8


@dataclasses.dataclass(frozen=True)
class LatticeConfig:
    """Static dataset configuration.

    Ranges: spacing a ~ U(6, 14) px, rotation theta ~ U(0, pi/3), vacancy ~
    U(0, 0.25), jitter std ~ U(0, 0.6) px, rectangular aspect ~ U(0.75, 1.35).
    `simple` fixes a=10, theta=0, vacancy=0, jitter=0; `rot_only` fixes a=10,
    vacancy=0, jitter=0 and keeps theta.
    """

    img_size: int = 64
    n_types: int = 4
    simple: bool = False
    rot_only: bool = False
    a_min: float = 6.0
    a_max: float = 14.0
    theta_max: float = math.pi / 3.0
    vacancy_max: float = 0.25
    jitter_max: float = 0.6
    aspect_min: float = 0.75
    aspect_max: float = 1.35


@dataclasses.dataclass(frozen=True)
class PointBudget:
    """Static worst-case index-grid extents for a LatticeConfig: n1s/n2s bound
    the per-item n1/n2 over the whole parameter range; p is the padded flat
    point count, a multiple of 128 (the rasterizer's contraction length)."""

    n1s: int
    n2s: int
    k_max: int
    p: int


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def static_point_budget(cfg: LatticeConfig) -> PointBudget:
    """Worst-case grid extents covering every (a, aspect, type) draw: margin
    = 2a, extent = img_size + margin, n_i = ceil(extent / ||v_i||) + 2, which
    is largest at the smallest spacing (and aspect_min for the rectangular v2)."""
    a_lo = 10.0 if (cfg.simple or cfg.rot_only) else cfg.a_min
    extent = float(cfg.img_size) + 2.0 * a_lo
    n1s = int(math.ceil(extent / a_lo)) + 2
    min_v2 = a_lo * min(1.0, cfg.aspect_min)
    n2s = int(math.ceil(extent / min_v2)) + 2
    k_max = 2 if cfg.n_types >= 4 else 1  # honeycomb basis
    raw = (2 * n1s + 1) * (2 * n2s + 1) * k_max
    return PointBudget(n1s=n1s, n2s=n2s, k_max=k_max, p=_round_up(raw, 128))


def _index_grid(budget: PointBudget) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Static (I, J, K, pad_valid) flat index arrays of length budget.p."""
    i = np.arange(-budget.n1s, budget.n1s + 1)
    j = np.arange(-budget.n2s, budget.n2s + 1)
    k = np.arange(budget.k_max)
    ii, jj, kk = np.meshgrid(i, j, k, indexing="ij")
    flat_i = ii.reshape(-1).astype(np.float32)
    flat_j = jj.reshape(-1).astype(np.float32)
    flat_k = kk.reshape(-1).astype(np.int32)
    n = flat_i.shape[0]
    pad = budget.p - n
    pad_valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    flat_i = np.concatenate([flat_i, np.zeros(pad, np.float32)])
    flat_j = np.concatenate([flat_j, np.zeros(pad, np.float32)])
    flat_k = np.concatenate([flat_k, np.zeros(pad, np.int32)])
    return flat_i, flat_j, flat_k, pad_valid


# ---------------------------------------------------------------------------
# Counter-based draws
# ---------------------------------------------------------------------------


def _mix(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (xor-shift-multiply) on int64 tensors holding
    values in [0, 2^32). torch's int64 right shift is arithmetic, so every
    product is masked back to 32 bits before the next shift; the low 32 bits
    of a wrapped int64 product are those of the true product."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & _M32
    return h ^ (h >> 16)


def _item_hash(seed: int, idx: torch.Tensor) -> torch.Tensor:
    """[B] int64 in [0, 2^32): the per-(seed, idx) root of every draw."""
    root = _mix(torch.tensor((int(seed) & _M32) ^ 0x9E3779B9, dtype=torch.int64,
                             device=idx.device))
    return _mix(root ^ (idx & _M32))


def _bits(item: torch.Tensor, stream: int, n: int | None = None) -> torch.Tensor:
    """32 random bits per (item, stream[, counter 0..n-1]) -> [B] or [B, n]."""
    h = _mix(item ^ ((stream * 0x85EBCA6B + 1) & _M32))
    if n is None:
        return _mix(h ^ 0x5BD1E995)
    counter = torch.arange(n, dtype=torch.int64, device=item.device)
    return _mix(_mix(h[:, None] ^ counter[None, :]) ^ 0x5BD1E995)


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """U[0, 1) f32 from the top 24 bits (exact in f32)."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _as_idx(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, device=device).to(torch.int64).reshape(-1)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v), device=device).to(torch.float32)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def sample_params(cfg: LatticeConfig, seed: int, idx, draws: Mapping | None = None,
                  device="cuda") -> dict[str, torch.Tensor]:
    """Per-item lattice parameters for the items `idx` [B]: lattice_type i32,
    a, theta, vacancy, jitter, aspect (all [B]; aspect is used by type 1 only
    but always drawn).

    draws: optional mapping with those six names holding the values as drawn
    over the config's ranges, before the `simple` / `rot_only` overrides (the
    tests pass JAX's); then `seed` and `idx` are not read."""
    if draws is not None:
        p = {k: _f32(draws[k], device) for k in _PARAM_STREAMS[1:]}
        p["lattice_type"] = torch.as_tensor(np.asarray(draws["lattice_type"]),
                                            device=device).to(torch.int32)
    else:
        item = _item_hash(seed, _as_idx(idx, device))
        u = {k: _uniform(_bits(item, s)) for s, k in enumerate(_PARAM_STREAMS) if s}
        p = {
            "lattice_type": (_bits(item, 0) % cfg.n_types).to(torch.int32),
            "a": cfg.a_min + u["a"] * (cfg.a_max - cfg.a_min),
            "theta": u["theta"] * cfg.theta_max,
            "vacancy": u["vacancy"] * cfg.vacancy_max,
            "jitter": u["jitter"] * cfg.jitter_max,
            "aspect": cfg.aspect_min + u["aspect"] * (cfg.aspect_max - cfg.aspect_min),
        }
    if cfg.simple or cfg.rot_only:
        p["a"] = torch.full_like(p["a"], 10.0)
        p["vacancy"] = torch.zeros_like(p["vacancy"])
        p["jitter"] = torch.zeros_like(p["jitter"])
        if cfg.simple:
            p["theta"] = torch.zeros_like(p["theta"])
    return p


def _lattice_vectors(lattice_type: torch.Tensor, a: torch.Tensor, aspect: torch.Tensor):
    """Branch-free lattice definition for [B] items: (v1 [B, 2], v2 [B, 2],
    basis2 [B, 2], n_basis [B]). basis2 is the honeycomb second-atom offset
    (zero for the other types); n_basis is 1 or 2."""
    s3 = math.sqrt(3.0)
    zero = torch.zeros_like(a)
    v1 = torch.stack([a, zero], dim=1)
    tri = torch.stack([0.5 * a, (s3 / 2.0) * a], dim=1)
    v2_opts = torch.stack([torch.stack([zero, a], dim=1),            # 0 square
                           torch.stack([zero, a * aspect], dim=1),   # 1 rectangular
                           tri, tri], dim=1)                          # 2, 3  -> [B, 4, 2]
    t = lattice_type.clamp(0, 3).long()
    v2 = v2_opts[torch.arange(a.shape[0], device=a.device), t]
    is_honey = lattice_type == 3
    basis2 = torch.stack([0.5 * a, (s3 / 6.0) * a], dim=1) * is_honey.to(a.dtype)[:, None]
    return v1, v2, basis2, 1 + is_honey.to(torch.int32)


def make_points(cfg: LatticeConfig, budget: PointBudget, params: Mapping[str, torch.Tensor],
                seed: int = 0, idx=None, draws=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Lattice points of [B] items: (points [B, P, 2] f32 in (x, y) pixel
    coordinates, weights [B, P] f32 in {0, 1}).

    draws: optional (vacancy uniforms [B, P], jitter normals [B, P, 2])
    replacing the hashed draws of (seed, idx)."""
    a, theta = params["a"], params["theta"]
    dev = a.device
    h = w = cfg.img_size
    v1, v2, basis2, n_basis = _lattice_vectors(params["lattice_type"], a, params["aspect"])
    fi, fj, fk, pv = (torch.as_tensor(v, device=dev) for v in _index_grid(budget))

    # Per-item grid extents: margin = 2a, n_i = ceil(extent / ||v_i||) + 2.
    margin = 2.0 * a
    extent = float(max(h, w)) + margin
    n1 = torch.ceil(extent / torch.sqrt((v1 * v1).sum(dim=1))) + 2.0
    n2 = torch.ceil(extent / torch.sqrt((v2 * v2).sum(dim=1))) + 2.0
    in_grid = ((fi.abs()[None] <= n1[:, None]) & (fj.abs()[None] <= n2[:, None])
               & (fk[None] < n_basis[:, None]) & pv[None])

    # pts = i v1 + j v2 + basis_k about the image centre, then rotated by theta.
    rel = fi[None, :, None] * v1[:, None, :] + fj[None, :, None] * v2[:, None, :]
    rel = rel + torch.where((fk == 1)[None, :, None], basis2[:, None, :],
                            torch.zeros((), device=dev))
    centre = torch.tensor([w / 2.0, h / 2.0], dtype=torch.float32, device=dev)
    rel = (rel + centre) - centre  # the same roundings as the JAX function
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    pts = torch.stack([rel[..., 0] * c - rel[..., 1] * s,
                       rel[..., 0] * s + rel[..., 1] * c], dim=2) + centre

    if draws is not None:
        vac_u, jit_n = _f32(draws[0], dev), _f32(draws[1], dev)
    elif idx is None:
        raise ValueError("make_points needs the items' idx or injected draws")
    else:
        item = _item_hash(seed, _as_idx(idx, dev))
        vac_u = _uniform(_bits(item, _S_VACANCY, budget.p))
        # Box-Muller, one (radius, angle) pair per coordinate; u1 in (0, 1].
        u1 = _uniform(_bits(item, _S_JITTER_R, 2 * budget.p)) + (1.0 / 16777216.0)
        u2 = _uniform(_bits(item, _S_JITTER_PHI, 2 * budget.p))
        jit_n = (torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2))
        jit_n = jit_n.reshape(-1, budget.p, 2)
    keep = vac_u > params["vacancy"][:, None]
    pts = pts + jit_n * params["jitter"][:, None, None]

    # Crop to +-margin beyond the image bounds.
    x, y, m = pts[..., 0], pts[..., 1], margin[:, None]
    in_crop = (x > -m) & (x < w + m) & (y > -m) & (y < h + m)
    return pts.contiguous(), (in_grid & keep & in_crop).to(torch.float32)


def item_labels(cfg: LatticeConfig, params: Mapping[str, torch.Tensor]):
    """(y_cat [B] int32, y_cont [B, 4] f32): zeros for `simple`, [0, theta, 0,
    0] for `rot_only`, else [a, theta, vacancy, jitter]."""
    y_cat = params["lattice_type"].to(torch.int32)
    zero = torch.zeros_like(params["theta"])
    if cfg.simple:
        cols = [zero, zero, zero, zero]
    elif cfg.rot_only:
        cols = [zero, params["theta"], zero, zero]
    else:
        cols = [params[k] for k in ("a", "theta", "vacancy", "jitter")]
    return y_cat, torch.stack(cols, dim=1).to(torch.float32)


def generate_item(cfg: LatticeConfig, budget: PointBudget, seed: int, idx, device="cuda"):
    """Geometry of the items `idx` [B] of dataset `seed`: (points [B, P, 2],
    weights [B, P], sigma [B], y_cat [B], y_cont [B, 4], lattice_type [B]).
    sigma is the atom blur tied to the spacing, max(0.6, 0.12 a). Rendering
    is separate (rasterize.py)."""
    idx = _as_idx(idx, device)
    params = sample_params(cfg, seed, idx, device=device)
    points, weights = make_points(cfg, budget, params, seed, idx)
    sigma = (0.12 * params["a"]).clamp(min=0.6)
    y_cat, y_cont = item_labels(cfg, params)
    return points, weights, sigma, y_cat, y_cont, params["lattice_type"]
