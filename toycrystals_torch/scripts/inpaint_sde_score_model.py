#!/usr/bin/env python3
"""Inpaint masked crystal images with a trained SDE score model, on the GPU.

    python -m toycrystals_torch.scripts.inpaint_sde_score_model --out-dir <run> \\
        --mask center --mask-frac 0.5 --steps 200 --cfg 1.5 --resample 2

Counterpart of scripts/inpaint_sde_score_model.py, with its flags: clean
rot_only lattices are rendered at the grid conditions (type = i % n_types,
theta = linspace(0, theta-max, n); a = 10, jitter 0, vacancy 0) through
data/lattice.py and the rasterizer, a region is masked out (`_mask_batch`:
center, left or bands), and `sample_inpaint_reverse_sde` regenerates it
conditioned on the rest of the crystal and on (type, theta). The source is
procedural, so the generated region is scored against the hidden truth: one
JSON line with region_mse, the region's variance about the source mean
(region_var) and their ratio (region_rel_mse). The n x 3 grid (original |
masked, gray where hidden | inpainted) goes to <out-dir>/results/.

Differences from the JAX CLI: --device defaults to cuda and never falls back
to the CPU; the grid is utils/figures.py's 8-bit PNG of the pixels, with no
title. --shard N inpaints each chunk's rows over N ranks (one process per
device, spawned here unless the cluster flags join ranks started elsewhere),
each drawing the chunk's whole noise, and rank 0 writes the grid and the
line; --shard-space S also splits every image's height (and the sources'
and masks') over S ranks (a --shard x S mesh, parallel/spatial.py);
--shard-model M splits every weight's output channels over M ranks (a
--shard x M mesh, parallel/tensor.py), each model rank inpainting its data
rank's rows with its block of the weights. Both flags together inpaint on
JAX's 3-D (data, space, model) mesh of --shard x S x M ranks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
from typing import Any

import numpy as np
import torch

from toycrystals_torch.models.sde_score_model import (
    VPSDE,
    CondUNetTiny,
    auto_chunk,
    eps_apply_from_v,
    sample_chunked,
    sample_grid_conditions,
    sample_inpaint_reverse_sde,
)
from toycrystals_torch.parallel.mesh import mesh_size
from toycrystals_torch.parallel.multihost import is_primary
from toycrystals_torch.parallel.spatial import check_stem_divisibility
from toycrystals_torch.parallel.tensor import shard_params, shard_report
from toycrystals_torch.scripts._common import (
    add_device_flag,
    add_parallel_flags,
    infer_score_ckpt_path,
    init_distributed,
    select_device,
    setup_mesh,
    spawn_shards,
)
from toycrystals_torch.utils.checkpoint import load_score_payload
from toycrystals_torch.utils.figures import save_image_grid
from toycrystals_torch.utils.fidelity import _render_templates
from toycrystals_torch.utils.params import load_flax_params


def _mask_batch(kind: str, frac: float, n: int, hw: int) -> np.ndarray:
    """(n, hw, hw, 1) float32; 1 = keep from the source, 0 = regenerate."""
    m = np.ones((n, hw, hw, 1), np.float32)
    k = max(1, min(hw - 1, int(round(hw * frac))))
    if kind == "center":  # hide a centred k x k box
        lo = (hw - k) // 2
        m[:, lo:lo + k, lo:lo + k, :] = 0.0
    elif kind == "left":  # hide the left k columns
        m[:, :, :k, :] = 0.0
    elif kind == "bands":  # hide every other band of k rows
        for r0 in range(0, hw, 2 * k):
            m[:, r0:r0 + k, :, :] = 0.0
    else:
        raise ValueError(f"mask must be center|left|bands, got {kind}")
    return m


def _render_sources(n: int, img_size: int, n_types: int, y_cont_dim: int, theta_max: float,
                    device: torch.device):
    """(x [n, H, W, 1] in [0, 1], y_cat, y_cont) on `device`: clean rot_only
    lattices at the grid conditions, each divided by its peak."""
    y_cat, y_cont = sample_grid_conditions(n, n_types, y_cont_dim, theta_max, device=device)
    x = _render_templates(img_size, y_cat.cpu().numpy(), y_cont[:, 1].cpu().numpy(),
                          np.ones(n, np.float32), device)[..., None]
    x = x / x.amax(dim=(1, 2, 3), keepdim=True).clamp(min=1e-6)
    return x, y_cat, y_cont


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_flag(p)
    p.add_argument("--out-dir", required=True, help="Training output dir containing checkpoints/")
    p.add_argument("--ckpt", default="last",
                   help="Checkpoint: last, best, or path/to/file.msgpack (or a reference .pt)")
    p.add_argument("--n", type=int, default=12)
    p.add_argument("--mask", type=str, default="center", choices=["center", "left", "bands"])
    p.add_argument("--mask-frac", type=float, default=0.5,
                   help="Masked extent as a fraction of the image side.")
    p.add_argument("--resample", type=int, default=1,
                   help="RePaint repeats per step (1 = plain replacement; 2-4 adapt the "
                        "generated region to the known boundary at resample x the model "
                        "evaluations).")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--cfg", type=float, default=0.0)
    p.add_argument("--t-end", type=float, default=1e-3)
    p.add_argument("--theta-max", type=float, default=math.pi / 3.0)
    p.add_argument("--use-ema", type=int, default=0, choices=[0, 1])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk", type=int, default=None,
                   help="Max images per sampling call; default the JAX CLI's auto_chunk "
                        "(steps x resample model evaluations), 0 disables.")
    p.add_argument("--clip-x0", type=int, default=0, choices=[0, 1])
    p.add_argument("--attn-impl", type=str, default="auto", choices=["auto", "xla", "flash"])
    p.add_argument("--out-path", default=None)
    add_parallel_flags(p, train=False)
    return p


@dataclasses.dataclass
class InpaintRun:
    """The inpainted images, their sources and masks ([n, H, W, 1] f32), the
    printed JSON line, where the grid went, and the images per call."""

    x: np.ndarray
    x_src: np.ndarray
    mask: np.ndarray
    line: dict[str, Any]
    out_path: str
    chunk: int


def inpaint(argv: list[str] | None = None) -> InpaintRun:
    p = build_parser()
    args = p.parse_args(argv)
    init_distributed(args, args.device)
    device = select_device(args.device)
    mesh = setup_mesh(args.shard, device=device, shard_space=args.shard_space,
                      shard_model=args.shard_model)
    primary = is_primary()

    ckpt_path = infer_score_ckpt_path(args.out_dir, args.ckpt)
    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(f"Checkpoint not found: {ckpt_path}")
    payload = load_score_payload(ckpt_path)
    cfg, state = payload["config"], payload["state"]
    params = state["params"]
    if args.use_ema == 1 and state.get("ema_params") is not None:
        params = state["ema_params"]
    if args.shard_space > 1:
        try:
            check_stem_divisibility(int(cfg.get("img_size", 64)), args.shard_space,
                                    str(cfg.get("stem", "none")))
        except ValueError as e:
            raise SystemExit(str(e)) from None
    param = str(cfg.get("param", "eps"))
    if param == "fm":
        raise SystemExit("inpainting runs the reverse-SDE repaint loop, which needs a VP "
                         "eps/v model; this checkpoint was trained with --param fm "
                         "(rectified flow)")
    model = CondUNetTiny(
        n_types=int(cfg["n_types"]), y_cont_dim=int(cfg["y_cont_dim"]),
        base_ch=int(cfg["base_ch"]), emb_dim=int(cfg["emb_dim"]),
        cond_ch=int(cfg.get("cond_ch", 8)), time_ch=int(cfg.get("time_ch", 8)),
        dtype=torch.bfloat16 if str(cfg.get("dtype", "float32")) == "bfloat16"
        else torch.float32,
        attn_impl=args.attn_impl, stem=str(cfg.get("stem", "none")))
    load_flax_params(model, params)
    model = model.to(device).eval().requires_grad_(False)
    if args.shard_model > 1:
        if primary:
            print(shard_report(args.shard_model, model))
        shard_params(model, mesh)
    sde = VPSDE(beta_min=float(cfg.get("beta_min", 0.1)),
                beta_max=float(cfg.get("beta_max", 30.0)),
                logsnr_shift=float(cfg.get("logsnr_shift", 0.0)))
    apply_fn = eps_apply_from_v(sde, model) if param == "v" else model

    img_size, n_types = int(cfg.get("img_size", 64)), int(cfg["n_types"])
    x_src, y_cat, y_cont = _render_sources(args.n, img_size, n_types, int(cfg["y_cont_dim"]),
                                           args.theta_max, device)
    mask = torch.from_numpy(_mask_batch(args.mask, args.mask_frac, args.n, img_size)).to(device)
    chunk = args.chunk
    if chunk is None:
        # resample multiplies the model evaluations per step
        chunk = auto_chunk(img_size, args.steps * max(1, args.resample), "sde")
    if chunk == 0:
        chunk = args.n
    with torch.inference_mode():
        x_out = sample_chunked(
            sample_inpaint_reverse_sde, apply_fn, sde, y_cat, y_cont,
            (args.n, img_size, img_size, 1), args.seed, chunk=chunk, mesh=mesh,
            batch_kw={"x_known": x_src, "mask": mask}, n_steps=args.steps,
            guidance_scale=args.cfg, t_end=args.t_end, n_types=n_types,
            resample=args.resample, clip_x0=bool(args.clip_x0))

    x_src_np, mask_np = x_src.cpu().numpy(), mask.cpu().numpy()
    # continuation error: the generated region against the hidden truth
    gen = 1.0 - mask_np
    mse = float(np.sum(gen * (x_out - x_src_np) ** 2) / max(1.0, np.sum(gen)))
    base = float(np.sum(gen * (x_src_np - x_src_np.mean()) ** 2) / max(1.0, np.sum(gen)))

    if args.out_path is None and primary:
        os.makedirs(os.path.join(args.out_dir, "results"), exist_ok=True)
        stem = os.path.splitext(os.path.basename(ckpt_path))[0]
        args.out_path = os.path.join(
            args.out_dir, "results",
            f"inpaint_ckpt-{stem}_{args.mask}{args.mask_frac:g}"
            f"_steps{args.steps}_r{args.resample}_cfg{args.cfg:.2f}.png")
    shown = x_src_np * mask_np + 0.5 * (1.0 - mask_np)  # the hidden region gray
    tri = np.stack([x_src_np, shown, x_out], axis=1).reshape(3 * args.n, img_size, img_size, 1)
    line = {"mask": args.mask, "mask_frac": args.mask_frac, "n": args.n, "steps": args.steps,
            "resample": args.resample, "cfg": args.cfg, "region_mse": round(mse, 6),
            "region_var": round(base, 6), "region_rel_mse": round(mse / max(base, 1e-12), 4)}
    if primary:
        save_image_grid(tri, args.out_path, nrows=args.n, ncols=3)
        print(f"Saved inpainting grid -> {args.out_path}")
        print(json.dumps(line))
    if mesh is not None:
        chunk = -(-min(chunk, args.n) // mesh_size(mesh)) * mesh_size(mesh)
    return InpaintRun(x_out, x_src_np, mask_np, line, args.out_path, min(chunk, args.n))


def main(argv: list[str] | None = None) -> int:
    """The CLI: `inpaint(argv)` in this process, or in --shard N spawned ranks."""
    if not spawn_shards(build_parser().parse_args(argv), inpaint, argv):
        inpaint(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
