#!/usr/bin/env python3
"""Write the procedural dataset to a .npz (or the reference's .pt) archive, rendered on the GPU.

    python -m toycrystals_torch.scripts.build_dataset [--out PATH] [flags]

Counterpart of scripts/build_dataset.py, with its flags and defaults (50,000
rot-only 64x64 items, seed 0, batches of 2,048). Each batch is generated and
rasterized on the device, quantised there as clip(x * 255, 0, 255) cast to
u8 (truncation, as JAX's cast), and copied to the host. Items are
deterministic per (seed, idx). --format npz (the default, or from --out's
extension) writes `np.savez_compressed` with x_u8 [N, H, W, 1] u8, y_cat
i32 and y_cont [N, 4] f32; --format pt writes the reference's torch dict
(x_u8 [N, 1, H, W] u8, y_cat i64, y_cont f32). Both packages' `load_archive`
read either. --rot-only is always on, as in the JAX CLI. --device defaults
to cuda and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from toycrystals_torch.data.datasets import generate_batch
from toycrystals_torch.data.lattice import LatticeConfig, static_point_budget
from toycrystals_torch.scripts._common import add_device_flag, select_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", type=str, default="data/toycrystals_train_rotonly.npz")
    p.add_argument("--n-samples", type=int, default=50_000)
    p.add_argument("--img-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-types", type=int, default=4)
    p.add_argument("--simple", default=False, action="store_true")
    p.add_argument("--rot-only", default=True, action="store_true")
    add_device_flag(p)
    p.add_argument("--batch-size", type=int, default=2048, help="on-device generation batch")
    p.add_argument("--format", type=str, default=None, choices=["npz", "pt"],
                   help="npz (default) or pt, the reference's torch dict; default: from "
                        "--out's extension.")
    return p


def build(argv: list[str] | None = None) -> dict:
    """Write the archive; returns {"path", "n", "seconds", "items_per_s"}."""
    args = build_parser().parse_args(argv)
    fmt = args.format or ("pt" if args.out.endswith(".pt") else "npz")
    device = select_device(args.device)
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    cfg = LatticeConfig(img_size=args.img_size, n_types=args.n_types, simple=args.simple,
                        rot_only=args.rot_only)
    budget = static_point_budget(cfg)

    n = args.n_samples
    x_u8 = np.empty((n, args.img_size, args.img_size, 1), dtype=np.uint8)
    y_cat = np.empty((n,), dtype=np.int32)
    y_cont = np.empty((n, 4), dtype=np.float32)
    t0 = time.perf_counter()
    for start in range(0, n, args.batch_size):
        stop = min(start + args.batch_size, n)
        x, yc, yv = generate_batch(cfg, args.seed, torch.arange(start, stop, device=device),
                                   budget, device)
        x_u8[start:stop] = torch.clip(x * 255.0, 0, 255).to(torch.uint8).cpu().numpy()
        y_cat[start:stop] = yc.cpu().numpy()
        y_cont[start:stop] = yv.cpu().numpy()
        print(f"{stop}/{n}")
    if fmt == "pt":
        torch.save({"x_u8": torch.from_numpy(np.ascontiguousarray(x_u8.transpose(0, 3, 1, 2))),
                    "y_cat": torch.from_numpy(y_cat.astype(np.int64)),
                    "y_cont": torch.from_numpy(y_cont)}, str(out_path))
    else:
        np.savez_compressed(out_path, x_u8=x_u8, y_cat=y_cat, y_cont=y_cont)
    dt = time.perf_counter() - t0
    print(f"saved {out_path} ({n} items in {dt:.1f}s, {n / dt:.0f} items/s)")
    return {"path": str(out_path), "n": n, "seconds": dt, "items_per_s": n / dt}


def main(argv: list[str] | None = None) -> int:
    build(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
