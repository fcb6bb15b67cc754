"""Dataset sources: procedural batches rendered on the device, and a disk archive.

Counterpart of toycrystals_tpu/data/datasets.py. The primary path renders a
whole batch of lattices on the device per training step (no files): the
batched geometry of lattice.py, then the rasterizer. `ToyCrystalsDataset` is
the indexable form; `ToyCrystalsDiskDataset` reads a prebuilt archive.

Item layout: x float32 [H, W, 1] in [0, 1], y_cat int32, y_cont [4] float32.
"""

from __future__ import annotations

import zipfile
from pathlib import Path

import numpy as np
import torch

from toycrystals_torch.data.lattice import (
    LatticeConfig,
    PointBudget,
    generate_item,
    static_point_budget,
)
from toycrystals_torch.data.rasterize import rasterize_batch


def generate_batch(cfg: LatticeConfig, seed: int, idx, budget: PointBudget | None = None,
                   device="cuda") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render the items at dataset indices `idx` on `device`.

    Deterministic per (seed, idx), whatever the batch and the device.
    Returns (x [B, H, W, 1] in [0, 1], y_cat [B] int32, y_cont [B, 4] f32)."""
    if budget is None:
        budget = static_point_budget(cfg)
    points, weights, sigma, y_cat, y_cont, _ = generate_item(cfg, budget, int(seed), idx, device)
    x = rasterize_batch(points, weights, sigma, cfg.img_size, cfg.img_size)
    return x[..., None], y_cat, y_cont


class ToyCrystalsDataset:
    """Indexable procedural dataset; items are generated from (seed, idx).
    `__getitem__` renders one item; bulk consumers call `.batch(idx)`."""

    def __init__(self, n_samples: int = 50_000, img_size: int = 64, seed: int = 0,
                 n_types: int = 4, simple: bool = False, rot_only: bool = False,
                 device="cuda") -> None:
        self.n_samples = int(n_samples)
        self.seed = int(seed)
        self.device = device
        self.cfg = LatticeConfig(img_size=int(img_size), n_types=int(n_types),
                                 simple=bool(simple), rot_only=bool(rot_only))
        self.budget = static_point_budget(self.cfg)

    def __len__(self) -> int:
        return self.n_samples

    def batch(self, idx):
        return generate_batch(self.cfg, self.seed, idx, self.budget, self.device)

    def __getitem__(self, idx: int):
        x, y_cat, y_cont = self.batch([int(idx)])
        return x[0], y_cat[0], y_cont[0]


def load_archive(path: str | Path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load a dataset archive as (x_u8 [N, H, W, 1] NHWC, y_cat i32, y_cont f32).

    Accepts the `.npz` of scripts/build_dataset.py (NHWC u8) and the torch
    dict `{x_u8 [N, 1, H, W] u8, y_cat [N] i64, y_cont [N, 4] f32}` (NCHW).
    The format is sniffed from the file, not the extension: an npz carries an
    `x_u8.npy` member, a torch archive does not (legacy torch saves are not
    zips at all), so a damaged npz surfaces its own error."""
    p = Path(path)
    is_npz = False
    try:
        with zipfile.ZipFile(p) as zf:
            is_npz = any(n.endswith("x_u8.npy") for n in zf.namelist())
    except (zipfile.BadZipFile, OSError):
        is_npz = False
    if is_npz:
        with np.load(p) as obj:
            x_u8, y_cat, y_cont = (np.asarray(obj[k]) for k in ("x_u8", "y_cat", "y_cont"))
    else:
        obj = torch.load(str(p), map_location="cpu", weights_only=True)
        if not isinstance(obj, dict) or "x_u8" not in obj:
            raise ValueError(f"{p}: not a dataset archive (expected .npz with x_u8/y_cat/"
                             "y_cont or a torch dict with the same keys)")
        x_u8, y_cat, y_cont = (obj[k].numpy() for k in ("x_u8", "y_cat", "y_cont"))
    if x_u8.ndim == 4 and x_u8.shape[1] == 1 and x_u8.shape[-1] != 1:
        x_u8 = np.transpose(x_u8, (0, 2, 3, 1))  # NCHW -> NHWC
    elif x_u8.ndim == 3:
        x_u8 = x_u8[..., None]
    return np.ascontiguousarray(x_u8), y_cat.astype(np.int32), y_cont.astype(np.float32)


class ToyCrystalsDiskDataset:
    """A prebuilt archive (see `load_archive`). Stored images are uint8 in
    [0, 255]; returned images are float32 in [0, 1], NHWC."""

    def __init__(self, path: str | Path) -> None:
        self.x_u8, self.y_cat, self.y_cont = load_archive(path)

    def __len__(self) -> int:
        return int(self.x_u8.shape[0])

    def __getitem__(self, idx: int):
        return self.x_u8[idx].astype(np.float32) / 255.0, self.y_cat[idx], self.y_cont[idx]

    def as_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.x_u8.astype(np.float32) / 255.0, self.y_cat, self.y_cont


def batch_iterator(n: int, batch_size: int, *, rng: np.random.Generator | None = None,
                   shuffle: bool = True, drop_last: bool = True):
    """Yield index arrays covering [0, n). Shuffling happens on the host over
    indices only; the data stays on the device or in one resident array.
    Shuffling needs an explicit `rng`: there is no unseeded fallback."""
    order = np.arange(n)
    if shuffle:
        if rng is None:
            raise ValueError("batch_iterator: shuffle=True needs an explicit rng "
                             "(np.random.Generator)")
        rng.shuffle(order)
    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        yield order[start:start + batch_size]
