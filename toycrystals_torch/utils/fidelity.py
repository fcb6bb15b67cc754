"""Lattice-fidelity scores of sampled crystal images, in PyTorch.

Counterpart of toycrystals_tpu/utils/fidelity.py. A clean lattice at a
conditioning (type, theta) can be rendered again with the dataset's own
geometry and rasterizer, so each sample is scored in Fourier space against
its ground-truth template:

1. `spectrum`: unit-norm magnitude FFT, fftshifted, with the DC
   neighbourhood masked (the sample's origin is arbitrary; its Bragg peaks
   are not).
2. `template_bank`: spectra over (lattice type, theta grid, rect aspect
   grid), rendered by data/lattice.py:make_points (a = 10, no vacancies, no
   jitter) and data/rasterize.py:rasterize_batch. On a CUDA device that is
   one launch of the rasterizer kernel per bank (610 templates at 64x64).
3. `score_lattice_fidelity`: per sample, cond_corr (cosine similarity with
   the template at the conditioned type and nearest theta, max over
   aspects), pred_type (argmax over types of the best in-type correlation)
   and theta_hat / theta_err_deg (error modulo the type's rotational
   symmetry); type_acc_merged01 merges types 0 and 1, since a rect lattice
   of aspect ~ 1 is a square one.

`extract_grid_tiles` and `score_grid_png` recover and score the tiles of a
saved figure grid; the PNG is decoded by utils/figures.py:read_png and each
tile resized as `jax.image.resize(..., "bilinear")` does (antialiased: a
triangle kernel widened by the scale when downsampling).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from toycrystals_torch.data.lattice import LatticeConfig, make_points, static_point_budget
from toycrystals_torch.data.rasterize import rasterize_batch
from toycrystals_torch.utils.figures import read_png

# rotational symmetry period (radians) of each lattice type's spectrum
_SYMMETRY = np.array([math.pi / 2, math.pi, math.pi / 3, math.pi / 3])
_RECT_ASPECTS = (0.75, 0.85, 0.95, 1.05, 1.15, 1.25, 1.35)


def spectrum(x: torch.Tensor, dc_radius: int = 2) -> torch.Tensor:
    """[..., H, W] image -> unit-L2 magnitude FFT, fftshifted, DC masked (f32)."""
    x = x.float()
    x = x - x.mean(dim=(-2, -1), keepdim=True)
    p = torch.fft.fftshift(torch.fft.fft2(x.to(torch.complex64)), dim=(-2, -1)).abs()
    h, w = x.shape[-2], x.shape[-1]
    fy = torch.arange(h, device=x.device) - h // 2
    fx = torch.arange(w, device=x.device) - w // 2
    dc = (fy[:, None] ** 2 + fx[None, :] ** 2) <= dc_radius ** 2
    p = torch.where(dc, torch.zeros((), device=x.device), p)
    return p / torch.linalg.vector_norm(p, dim=(-2, -1), keepdim=True).clamp(min=1e-12)


def _render_templates(img_size: int, types: np.ndarray, thetas: np.ndarray,
                      aspects: np.ndarray, device) -> torch.Tensor:
    """Clean rot_only lattices at explicit (type, theta, aspect): [M, H, W]."""
    cfg = LatticeConfig(img_size=img_size, rot_only=True)
    budget = static_point_budget(cfg)
    a = 10.0
    m = len(types)
    params = {
        "lattice_type": torch.as_tensor(types, dtype=torch.int32, device=device),
        "a": torch.full((m,), a, dtype=torch.float32, device=device),
        "theta": torch.as_tensor(thetas, dtype=torch.float32, device=device),
        "vacancy": torch.zeros((m,), dtype=torch.float32, device=device),
        "jitter": torch.zeros((m,), dtype=torch.float32, device=device),
        "aspect": torch.as_tensor(aspects, dtype=torch.float32, device=device),
    }
    # vacancy 0 keeps every point whose uniform draw is above 0; jitter 0
    # ignores the normals
    draws = (np.ones((m, budget.p), np.float32), np.zeros((m, budget.p, 2), np.float32))
    pts, wts = make_points(cfg, budget, params, draws=draws)
    sig = torch.full((m,), max(0.6, 0.12 * a), dtype=torch.float32, device=device)
    return rasterize_batch(pts, wts, sig, img_size, img_size)


def template_bank(img_size: int, n_types: int = 4, n_theta: int = 61,
                  theta_max: float = math.pi / 3, device="cuda"):
    """(spectra [M, H, W] f32 on `device`, type [M], theta [M] numpy) for the
    matching grid. Types 0, 2 and 3 render at one aspect; type 1 fans out
    over `_RECT_ASPECTS`. Cached per (arguments, device)."""
    return _template_bank(int(img_size), int(n_types), int(n_theta), float(theta_max),
                          str(torch.device(device)))


@functools.lru_cache(maxsize=8)
def _template_bank(img_size: int, n_types: int, n_theta: int, theta_max: float, device: str):
    theta_grid = np.linspace(0.0, theta_max, n_theta)
    rows: list[tuple[int, float, float]] = []
    for t in range(n_types):
        for asp in (_RECT_ASPECTS if t == 1 else (1.0,)):
            rows.extend((t, th, asp) for th in theta_grid)
    types = np.array([r[0] for r in rows], np.int32)
    thetas = np.array([r[1] for r in rows], np.float32)
    aspects = np.array([r[2] for r in rows], np.float32)
    imgs = _render_templates(img_size, types, thetas, aspects, torch.device(device))
    return spectrum(imgs), types, thetas


def _theta_err(theta_hat: np.ndarray, theta: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Angular error modulo each type's rotational symmetry, in radians."""
    period = _SYMMETRY[np.clip(types, 0, 3)]
    d = np.abs(theta_hat - theta) % period
    return np.minimum(d, period - d)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] f32 weights of `jax.image.resize(..., "bilinear")` along
    one axis (antialias on): a triangle kernel widened by 1 / scale when
    downsampling, each output's weights normalised to sum 1."""
    scale = n_out / n_in
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale \
        - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    wts = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = wts.sum(axis=0, keepdims=True)
    wts = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                   wts / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], wts, 0).astype(np.float32)


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[H, W] f32 -> [out_h, out_w] as `jax.image.resize(img, (out_h, out_w),
    "bilinear")`; an axis whose size does not change is left as it is."""
    img = np.asarray(img, np.float32)
    if img.shape[0] != out_h:
        img = _resize_weights(img.shape[0], out_h).T @ img
    if img.shape[1] != out_w:
        img = img @ _resize_weights(img.shape[1], out_w)
    return img


def extract_grid_tiles(path, nrows: int = 6, ncols: int = 6, out_size: int = 64) -> np.ndarray:
    """Recover the [n, out_size, out_size] sample tiles of a saved figure
    grid (mostly-dark tiles on a white canvas): rows and columns crossing
    tiles form `nrows` / `ncols` long dark bands of the darkness projected on
    each axis (thin text rows are dropped by run length). Each tile is
    resized to out_size and clipped to [0, 1]."""
    img = read_png(path)
    if img.ndim == 3:
        img = img[..., :3].mean(axis=-1)
    dark = img < 0.85

    def bands(mass: np.ndarray, n: int, extent: int) -> list[tuple[int, int]]:
        on = mass > 0.05
        runs, start = [], None
        for i, v in enumerate(np.append(on, False)):
            if v and start is None:
                start = i
            elif not v and start is not None:
                runs.append((start, i))
                start = None
        min_len = extent // (3 * n)  # text rows are thin; tiles are not
        runs = [r for r in runs if r[1] - r[0] >= min_len]
        if len(runs) < n:
            raise ValueError(f"found {len(runs)} tile bands, expected {n}: {path}")
        return sorted(sorted(runs, key=lambda r: r[0] - r[1])[:n])

    rows = bands(dark.mean(axis=1), nrows, img.shape[0])
    cols = bands(dark.mean(axis=0), ncols, img.shape[1])
    tiles = [resize_bilinear(img[r0:r1, c0:c1], out_size, out_size)
             for r0, r1 in rows for c0, c1 in cols]
    return np.clip(np.stack(tiles), 0.0, 1.0)


def score_grid_png(path, nrows: int = 6, ncols: int = 6, n_types: int = 4,
                   theta_max: float = math.pi / 3, out_size: int = 64,
                   device="cuda") -> dict:
    """Extract a saved figure grid and score it against the canonical grid
    conditions (type = i % n_types, theta = linspace(0, theta_max, n))."""
    tiles = extract_grid_tiles(path, nrows, ncols, out_size)
    n = tiles.shape[0]
    y_cat = np.arange(n, dtype=np.int32) % n_types
    theta = np.linspace(0.0, theta_max, n).astype(np.float32)
    return score_lattice_fidelity(tiles, y_cat, theta, theta_max=theta_max, n_types=n_types,
                                  device=device)


def score_lattice_fidelity(x, y_cat, theta, *, n_theta: int = 61,
                           theta_max: float = math.pi / 3, n_types: int = 4,
                           device="cuda") -> dict:
    """Score sampled images against their conditioning.

    x: [B, H, W, 1] or [B, H, W] in [0, 1] (numpy); y_cat: [B]
    lattice types; theta: [B] conditioned rotations (radians, the y_cont[:, 1]
    convention). The spectra and correlations run on `device`.

    Returns per-sample arrays (pred_type, type_correct, theta_hat,
    theta_err_deg, cond_corr) and float aggregates (type_acc,
    type_acc_merged01, theta_mae_deg, cond_fidelity)."""
    xt = torch.tensor(np.asarray(x, np.float32))
    if xt.ndim == 4:
        xt = xt[..., 0]
    y_cat = np.asarray(y_cat).astype(np.int32)
    theta = np.asarray(theta).astype(np.float32)
    bank_spec, bank_type, bank_theta = template_bank(xt.shape[-1], n_types, n_theta,
                                                     theta_max, device)
    s = spectrum(xt.to(bank_spec.device))
    # [B, M] cosine similarities (both operands unit-norm, nonnegative)
    corr = torch.einsum("bhw,mhw->bm", s, bank_spec).cpu().numpy()

    b = xt.shape[0]
    per_type = np.full((b, n_types), -1.0)
    for t in range(n_types):
        per_type[:, t] = corr[:, bank_type == t].max(axis=1)
    pred_type = per_type.argmax(axis=1).astype(np.int32)
    type_correct = pred_type == y_cat
    merged = np.where(np.isin(pred_type, (0, 1)) & np.isin(y_cat, (0, 1)), True, type_correct)

    theta_hat = np.zeros(b, np.float32)
    cond_corr = np.zeros(b, np.float32)
    for i in range(b):
        in_type = bank_type == y_cat[i]
        c = corr[i, in_type]
        th = bank_theta[in_type]
        theta_hat[i] = th[c.argmax()]
        # the nearest bank theta to the conditioning (symmetry-aware), max
        # over the type's aspect fan
        d = _theta_err(th, np.full_like(th, theta[i]), np.full(th.shape, y_cat[i], np.int32))
        cond_corr[i] = c[d <= d.min() + 1e-6].max()

    theta_err = _theta_err(theta_hat, theta, y_cat)
    return {
        "pred_type": pred_type,
        "type_correct": type_correct,
        "theta_hat": theta_hat,
        "theta_err_deg": np.degrees(theta_err),
        "cond_corr": cond_corr,
        "type_acc": float(type_correct.mean()),
        "type_acc_merged01": float(merged.mean()),
        "theta_mae_deg": float(np.degrees(theta_err).mean()),
        "cond_fidelity": float(cond_corr.mean()),
    }
