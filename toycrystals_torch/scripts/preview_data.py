#!/usr/bin/env python3
"""A 6x6 preview grid of the full-variability dataset, rendered on the GPU.

    python -m toycrystals_torch.scripts.preview_data [--out PATH]

Counterpart of scripts/preview_data.py: items 0-35 of the dataset with
simple=False and rot_only=False at --seed, as an 8-bit PNG of the pixels
(utils/figures.py; the JAX script draws a matplotlib figure with each
tile's type as its title). --device defaults to cuda and never falls back
to the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from toycrystals_torch.data.datasets import generate_batch
from toycrystals_torch.data.lattice import LatticeConfig
from toycrystals_torch.scripts._common import add_device_flag, select_device
from toycrystals_torch.utils.figures import save_image_grid


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_flag(p)
    p.add_argument("--out", type=str, default="results/preview_toycrystals.png")
    p.add_argument("--img-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    return p


def preview(argv: list[str] | None = None) -> tuple[str, np.ndarray]:
    """Write the grid; returns its path and the 36 images [36, H, W, 1]."""
    args = build_parser().parse_args(argv)
    device = select_device(args.device)
    cfg = LatticeConfig(img_size=args.img_size, n_types=4)
    x, _, _ = generate_batch(cfg, args.seed, torch.arange(36, device=device), device=device)
    images = x.cpu().numpy()
    save_image_grid(images, args.out)
    print(f"Saved {args.out}")
    return args.out, images


def main(argv: list[str] | None = None) -> int:
    preview(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
