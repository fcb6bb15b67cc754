#!/usr/bin/env python3
"""Score a score-model checkpoint, or a saved grid, with the lattice-fidelity
metric and the latent FID, on the GPU.

    # sample the canonical grid from a checkpoint and score it in memory
    python -m toycrystals_torch.scripts.eval_sde_score_model --ckpt <run>/checkpoints/sde_score_model_last.msgpack \\
        --fid-vae assets/eval/feature_vae_z16.msgpack
    # score a saved figure grid
    python -m toycrystals_torch.scripts.eval_sde_score_model --grid assets/score_based_diffusion/score_based_diffusion_samples.png \\
        --fid-vae assets/eval/feature_vae_z16.msgpack

Counterpart of scripts/eval_sde_score_model.py, with its flags, its human
summary and its one JSON line (the same keys). --ckpt samples --n images at
the canonical grid conditions (type = i % n_types, theta = linspace(0,
theta-max, n)) through `ScoreModelService`, which resolves a distilled
student's sampler, steps and guidance and an fm checkpoint's rf sampler, and
scores the float samples (utils/fidelity.py). --grid recovers a saved
grid's tiles and scores them. --fid-vae adds the latent FID with its same-n
noise floor (utils/fid.py). --json-out also writes the per-sample arrays.

Differences from the JAX CLI: --device defaults to cuda and never falls back
to the CPU (the template bank renders through the rasterizer kernel there);
--save-grid writes utils/figures.py's 8-bit PNG of the pixels. --quantize
int8 samples --ckpt through the int8 convs of ops/conv.py.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
from typing import Any

import numpy as np

from toycrystals_torch.scripts._common import add_device_flag, select_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_flag(p)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", default=None,
                     help="Score-model checkpoint (.msgpack, or a reference .pt) to sample "
                          "from and score.")
    src.add_argument("--grid", default=None,
                     help="A saved figure-grid png to score instead (canonical-conditions "
                          "grid; the tiles are recovered from the figure).")
    # checkpoint mode; None = resolved from the checkpoint as serving does
    # (distilled: trained sampler/steps/cfg; fm: rf at 50 steps; else sde/300/1.5/0.005)
    p.add_argument("--n", type=int, default=36,
                   help="Samples to draw and score (default 36 = the 6x6 grid).")
    p.add_argument("--sampler", default=None, choices=["ode", "sde", "dpm", "ddim", "rf"])
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--cfg", type=float, default=None)
    p.add_argument("--t-end", type=float, default=None)
    p.add_argument("--use-ema", type=int, default=1, choices=[0, 1])
    p.add_argument("--clip-x0", type=int, default=0, choices=[0, 1])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--theta-max", type=float, default=math.pi / 3.0)
    p.add_argument("--grid-rows", type=int, default=6,
                   help="Grid-png mode: tile rows in the figure (default 6).")
    p.add_argument("--grid-cols", type=int, default=6,
                   help="Grid-png mode: tile columns in the figure (default 6).")
    p.add_argument("--grid-size", type=int, default=64,
                   help="Grid-png mode: tile resolution to score at (the sampled image size; "
                        "256 for the stretch grids).")
    p.add_argument("--dtype", default="auto", choices=["auto", "float32", "bfloat16"])
    p.add_argument("--attn-impl", default="auto", choices=["auto", "xla", "flash"])
    p.add_argument("--quantize", default="none", choices=["none", "int8"],
                   help="Checkpoint mode: int8 = dynamic-quantised int8 convs "
                        "(post-training; any float checkpoint serves so).")
    p.add_argument("--fid-vae", default=None,
                   help="Unconditional-VAE feature-extractor checkpoint (the committed "
                        "assets/eval/feature_vae_z16.msgpack). Adds the latent FID against "
                        "a procedural real draw, with its same-n real-vs-real floor.")
    p.add_argument("--fid-ref-n", type=int, default=4096,
                   help="Real-draw size for the FID reference stats.")
    p.add_argument("--save-grid", default=None,
                   help="Also save the sampled grid png here (ckpt mode).")
    p.add_argument("--json-out", default=None,
                   help="Write the full result (scalars + per-sample arrays) as JSON here.")
    return p


@dataclasses.dataclass
class EvalRun:
    """The printed JSON line, and in ckpt mode the scored samples ([n, H, W,
    1] f32 in [0, 1])."""

    line: dict[str, Any]
    x: np.ndarray | None


def evaluate(argv: list[str] | None = None) -> EvalRun:
    p = build_parser()
    args = p.parse_args(argv)
    device = select_device(args.device)

    from toycrystals_torch.utils.fidelity import (
        extract_grid_tiles,
        score_grid_png,
        score_lattice_fidelity,
    )

    x = None
    if args.grid is not None:
        if not os.path.exists(args.grid):
            raise FileNotFoundError(args.grid)
        res = score_grid_png(args.grid, nrows=args.grid_rows, ncols=args.grid_cols,
                             theta_max=args.theta_max, out_size=args.grid_size, device=device)
        source: dict[str, Any] = {"grid": args.grid}
        if args.fid_vae:
            fid_images = extract_grid_tiles(args.grid, args.grid_rows, args.grid_cols,
                                            64)[..., None]
    else:
        if not os.path.exists(args.ckpt):
            raise FileNotFoundError(args.ckpt)
        from toycrystals_torch.models.sde_score_model import sample_grid_conditions
        from toycrystals_torch.serve import ScoreModelService

        svc = ScoreModelService.from_checkpoint(
            args.ckpt, device=device, use_ema=bool(args.use_ema), sampler=args.sampler,
            steps=args.steps, guidance_scale=args.cfg, t_end=args.t_end,
            clip_x0=bool(args.clip_x0), dtype=args.dtype, attn_impl=args.attn_impl,
            quantize=args.quantize)
        y_cat, y_cont = (a.numpy() for a in sample_grid_conditions(
            args.n, svc.n_types, svc.y_cont_dim, args.theta_max))
        print(f"sampling {args.n} images: sampler={svc.sampler_name} steps={svc.steps} "
              f"cfg={svc.guidance_scale} t_end={svc.t_end} ema={bool(args.use_ema)}",
              file=sys.stderr)
        x = svc.sample(y_cat, y_cont, seed=args.seed)
        if args.save_grid:
            from toycrystals_torch.utils.figures import save_image_grid

            side = int(math.ceil(math.sqrt(args.n)))
            save_image_grid(x, args.save_grid, nrows=side, ncols=side)
            print(f"saved grid -> {args.save_grid}", file=sys.stderr)
        res = score_lattice_fidelity(x, y_cat, y_cont[:, 1], theta_max=args.theta_max,
                                     n_types=svc.n_types, device=device)
        source = {"ckpt": args.ckpt, "sampler": svc.sampler_name, "steps": svc.steps,
                  "cfg": svc.guidance_scale, "t_end": svc.t_end,
                  "use_ema": bool(args.use_ema), "quantize": svc.quantize,
                  "seed": args.seed, "n": args.n}
        fid_images = x

    scalars = {k: v for k, v in res.items() if isinstance(v, float)}
    if args.fid_vae:
        from toycrystals_torch.data.lattice import LatticeConfig
        from toycrystals_torch.utils.fid import (
            compute_fid,
            fid_floor,
            load_feature_extractor,
            reference_stats,
        )

        fmodel, fcfg = load_feature_extractor(args.fid_vae, device=device)
        lat_cfg = LatticeConfig(img_size=int(fcfg.get("img_size", 64)), rot_only=True)
        ref = reference_stats(fmodel, cfg=lat_cfg, n=args.fid_ref_n)
        scalars["fid"] = compute_fid(fid_images, fmodel, ref_stats=ref)
        scalars["fid_floor"] = fid_floor(fmodel, int(fid_images.shape[0]), ref, cfg=lat_cfg)
        source["fid_vae"] = args.fid_vae
        source["fid_ref_n"] = args.fid_ref_n
    print("lattice-fidelity metrics (utils/fidelity.py):")
    print(f"  cond_fidelity     {scalars['cond_fidelity']:.3f}   "
          "(conditioned spectral correlation, 1 = template-perfect)")
    print(f"  type_acc          {scalars['type_acc']:.3f}   raw 4-way")
    print(f"  type_acc_merged01 {scalars['type_acc_merged01']:.3f}   "
          "(square/rect merged: aspect~1 rects are genuinely square)")
    print(f"  theta_mae_deg     {scalars['theta_mae_deg']:.2f}   "
          "(symmetry-aware rotation recovery error)")
    if "fid" in scalars:
        print(f"  fid               {scalars['fid']:.3f}   (latent-FID, utils/fid.py; same-N "
              f"real-vs-real floor {scalars['fid_floor']:.3f})")
    line = {**source, **scalars}
    print(json.dumps(line))

    if args.json_out:
        full = {**line, **{k: np.asarray(v).tolist() for k, v in res.items()
                           if not isinstance(v, float)}}
        with open(args.json_out, "w") as f:
            json.dump(full, f, indent=1)
        print(f"wrote {args.json_out}", file=sys.stderr)
    return EvalRun(line, x)


def main(argv: list[str] | None = None) -> int:
    evaluate(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
