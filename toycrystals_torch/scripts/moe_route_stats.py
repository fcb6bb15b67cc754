#!/usr/bin/env python3
"""Expert-utilisation report of a trained MoE diffusion prior.

    python -m toycrystals_torch.scripts.moe_route_stats --ckpt PATH [--t-points 64]

Counterpart of scripts/moe_route_stats.py. Loads a --moe-experts checkpoint of
either package's train_diffusion_prior (its config carries n_experts), routes
the 6x6 grid conditions (every lattice type across a theta sweep) at
--t-points timesteps over [0, T), and prints each block's routing fractions,
their entropy normalised by ln E, and the largest share, then the same as one
JSON line (the JAX script's keys and rounding), also written to --json-out.
Routing is top-1 on the (t, y) conditioning, so the fractions are exact over
the swept conditions. --device defaults to cuda (auto means cuda too) and
never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from toycrystals_torch.models.moe_prior import DiffusionPriorMoE
from toycrystals_torch.models.sde_score_model import sample_grid_conditions
from toycrystals_torch.scripts._common import select_device
from toycrystals_torch.utils.checkpoint import load_checkpoint
from toycrystals_torch.utils.params import torch_state_dict_from_flax_prior

N_GRID = 36


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu", "auto"],
                   help="cuda (default) or auto: the GPU, and an error without one; cpu only "
                        "when asked.")
    p.add_argument("--t-points", type=int, default=64,
                   help="timesteps sampled uniformly over [0, T)")
    p.add_argument("--json-out", default=None)
    return p


@torch.no_grad()
def route_stats(argv: list[str] | None = None) -> dict:
    """Print the table and the JSON line; return the line's dict."""
    args = build_parser().parse_args(argv)
    device = select_device(args.device)
    raw = load_checkpoint(args.ckpt)
    cfg = raw["config"]
    e = int(cfg.get("n_experts", 0))
    if e < 2:
        raise SystemExit(f"{args.ckpt}: not a routed MoE prior checkpoint (config "
                         f"n_experts={e}); train with --moe-experts >= 2")
    n_types, y_cont_dim, z_dim = int(cfg["n_types"]), int(cfg["y_cont_dim"]), int(cfg["z_dim"])
    prior = DiffusionPriorMoE(z_dim=z_dim, n_types=n_types, y_cont_dim=y_cont_dim, n_experts=e,
                              t_emb_dim=int(cfg["t_emb_dim"]), width=int(cfg["width"]),
                              n_blocks=int(cfg["n_blocks"]),
                              y_cat_emb_dim=int(cfg["y_cat_emb_dim"]))
    prior.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
                           torch_state_dict_from_flax_prior(raw["params"]).items()})
    prior.to(device)

    # the grid conditions x a uniform t sweep (f32 linspace, truncated, as JAX)
    y_cat, y_cont = sample_grid_conditions(N_GRID, n_types, y_cont_dim, device=device)
    ts = np.linspace(0, int(cfg["T"]) - 1, args.t_points).astype(np.float32).astype(np.int32)
    bt = torch.from_numpy(np.repeat(ts, N_GRID)).to(device)
    by_cat, by_cont = y_cat.repeat(args.t_points), y_cont.repeat(args.t_points, 1)
    z = torch.zeros((bt.shape[0], z_dim), device=device)
    _, stats = prior(z, bt, by_cat, by_cont, return_stats=True)

    out = {"ckpt": args.ckpt, "n_experts": e, "conditions": int(bt.shape[0]), "blocks": {}}
    print(f"{args.ckpt}: {e} experts, {bt.shape[0]} (t, y) conditions")
    print(f"{'block':>8}  fractions{'':<{max(0, 7 * e - 9)}}  entropy  max-share")
    for i, frac in enumerate(stats["route_fraction"]):
        name = f"block_{i}"
        f = frac.cpu().numpy().astype(np.float64)
        f = f / f.sum()
        ent = float(-(f * np.log(np.maximum(f, 1e-12))).sum() / np.log(e))
        print(f"{name:>8}  [{' '.join(f'{x:.3f}' for x in f)}]  {ent:7.3f}  {f.max():9.3f}")
        out["blocks"][name] = {"fractions": [round(float(x), 4) for x in f],
                               "entropy_norm": round(ent, 4),
                               "max_share": round(float(f.max()), 4)}
    line = json.dumps(out)
    print(line)
    if args.json_out:
        Path(args.json_out).write_text(line + "\n")
    return out


def main(argv: list[str] | None = None) -> int:
    route_stats(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
