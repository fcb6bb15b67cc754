#!/usr/bin/env python3
"""Sample a grid from an SDE score-model checkpoint on the GPU.

    python -m toycrystals_torch.scripts.sample_sde_score_model --out-dir <run> [flags]

Counterpart of scripts/sample_sde_score_model.py, with its flags: --ckpt is
a path or last/best under <out-dir>/checkpoints (msgpack of either package's
trainer, or a reference .pt); the model is rebuilt from the checkpoint's
config (the flags are the fallback); --use-ema; samplers ode, sde, dpm,
ddim and rf (--rf-solver euler or heun); v-prediction checkpoints are
wrapped to eps; an fm checkpoint samples with rf on its fm_shift grid; a
distilled checkpoint defaults to its trained steps and t_end; the grid goes
to <out-dir>/results/ under a name that encodes the settings.

Differences from the JAX CLI: --device defaults to cuda and never falls back
to the CPU, and the grid is an 8-bit PNG of the pixels themselves
(utils/figures.py). Int8 convs, meshes and orbax checkpoints are not ported
yet: those flags raise, naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
from typing import Any

import numpy as np
import torch

from toycrystals_torch.models.flow_matching import sample_rectified_flow
from toycrystals_torch.models.sde_score_model import (
    VPSDE,
    CondUNetTiny,
    auto_chunk,
    eps_apply_from_v,
    sample_chunked,
    sample_ddim,
    sample_dpmpp_2m,
    sample_grid_conditions,
    sample_probability_flow_ode,
    sample_reverse_sde_euler_maruyama,
)
from toycrystals_torch.scripts._common import (
    FAST_PATH,
    PARALLEL,
    PARALLEL_DESTS,
    add_device_flag,
    add_parallel_flags,
    infer_score_ckpt_path,
    refuse_deferred,
    select_device,
)
from toycrystals_torch.utils.checkpoint import load_score_payload
from toycrystals_torch.utils.figures import save_image_grid
from toycrystals_torch.utils.params import load_flax_params

SAMPLERS = {"ode": sample_probability_flow_ode, "sde": sample_reverse_sde_euler_maruyama,
            "dpm": sample_dpmpp_2m, "ddim": sample_ddim, "rf": sample_rectified_flow}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_flag(p)
    p.add_argument("--out-dir", required=True, help="Training output dir containing checkpoints/")
    p.add_argument("--ckpt", default="last",
                   help="Checkpoint: last, best, or path/to/file.msgpack (or a reference .pt)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--cfg", type=float, default=0.0)
    p.add_argument("--t-end", type=float, default=1e-3)
    p.add_argument("--theta-max", type=float, default=math.pi / 3.0)
    p.add_argument("--n", type=int, default=36)
    p.add_argument("--use-ema", type=int, default=0, choices=[0, 1],
                   help="If the checkpoint has EMA weights, sample with them.")
    p.add_argument("--sampler", type=str, default="ode",
                   choices=["ode", "sde", "dpm", "ddim", "rf"],
                   help="ode = probability-flow Heun, sde = reverse-SDE Euler-Maruyama, dpm = "
                        "DPM-Solver++(2M) (try --steps 30-50), ddim = deterministic DDIM, the "
                        "sampler of distilled checkpoints; rf = rectified-flow Euler, chosen "
                        "for --param fm checkpoints (try --steps 20-50)")
    p.add_argument("--rf-solver", type=str, default="euler", choices=["euler", "heun"],
                   help="--sampler rf's integrator: euler (1 evaluation per step) or heun "
                        "(2; compare N heun steps with 2N euler steps)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk", type=int, default=None,
                   help="Max images per sampling call (the last one padded and trimmed). "
                        "Default: the JAX CLI's auto_chunk from img size, steps and sampler. "
                        "0 disables chunking.")
    p.add_argument("--clip-x0", type=int, default=0, choices=[0, 1],
                   help="Static x0-thresholding inside the sampler.")
    p.add_argument("--quantize", type=str, default="none", choices=["none", "int8"],
                   help=f"int8 convs are not ported yet ({FAST_PATH})")
    p.add_argument("--attn-impl", type=str, default="auto", choices=["auto", "xla", "flash"],
                   help="Attention: auto = the flash kernel at >= 2048 tokens.")
    add_parallel_flags(p, train=False)
    # fallback model and SDE config, used only if the checkpoint has none
    p.add_argument("--n-types", type=int, default=4)
    p.add_argument("--y-cont-dim", type=int, default=4)
    p.add_argument("--base-ch", type=int, default=96)
    p.add_argument("--emb-dim", type=int, default=128)
    p.add_argument("--cond-ch", type=int, default=8)
    p.add_argument("--time-ch", type=int, default=8)
    p.add_argument("--beta-min", type=float, default=0.1)
    p.add_argument("--beta-max", type=float, default=30.0)
    p.add_argument("--logsnr-shift", type=float, default=0.0)
    p.add_argument("--param", type=str, default="eps", choices=["eps", "v", "fm"],
                   help="Prediction target fallback (only if the checkpoint has no config).")
    p.add_argument("--out-path", default=None, help="Where to save the sample grid png")
    p.add_argument("--dtype", type=str, default="auto", choices=["auto", "float32", "bfloat16"],
                   help="Computation dtype; 'auto' follows the checkpoint's training dtype.")
    return p


@dataclasses.dataclass
class SampleRun:
    """The samples ([n, H, W, 1] f32 in [0, 1]), where the grid went, and
    what was resolved to make them."""

    x: np.ndarray
    out_path: str
    sampler: str
    steps: int
    chunk: int


def sample(argv: list[str] | None = None) -> SampleRun:
    p = build_parser()
    args = p.parse_args(argv)
    refuse_deferred(p, args, {**{d: PARALLEL for d in PARALLEL_DESTS},
                              "quantize": FAST_PATH})
    device = select_device(args.device)

    ckpt_path = infer_score_ckpt_path(args.out_dir, args.ckpt)
    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(f"Checkpoint not found: {ckpt_path}")
    payload = load_score_payload(ckpt_path)
    cfg = payload.get("config") or {
        "img_ch": 1, "n_types": args.n_types, "y_cont_dim": args.y_cont_dim,
        "base_ch": args.base_ch, "emb_dim": args.emb_dim, "cond_ch": args.cond_ch,
        "time_ch": args.time_ch, "beta_min": args.beta_min, "beta_max": args.beta_max,
        "param": args.param,
    }
    ckpt_param = str(cfg.get("param", "eps"))
    dtype_name = str(cfg.get("dtype", "float32")) if args.dtype == "auto" else args.dtype
    model = CondUNetTiny(
        n_types=int(cfg["n_types"]), y_cont_dim=int(cfg["y_cont_dim"]),
        base_ch=int(cfg["base_ch"]), emb_dim=int(cfg["emb_dim"]),
        cond_ch=int(cfg["cond_ch"]), time_ch=int(cfg["time_ch"]),
        dtype=torch.bfloat16 if dtype_name == "bfloat16" else torch.float32,
        attn_impl=args.attn_impl, stem=str(cfg.get("stem", "none")))
    state = payload["state"]
    params = state["params"]
    if args.use_ema == 1 and state.get("ema_params") is not None:
        params = state["ema_params"]
    load_flax_params(model, params)
    model = model.to(device).eval().requires_grad_(False)
    sde = VPSDE(beta_min=float(cfg.get("beta_min", 0.1)),
                beta_max=float(cfg.get("beta_max", 30.0)),
                logsnr_shift=float(cfg.get("logsnr_shift", args.logsnr_shift)))

    apply_fn = model
    extra_kw: dict[str, Any] = {}
    if ckpt_param == "fm":
        # the net is a velocity field on the straight-line path: only the rf
        # integrator consumes it
        if args.sampler != "rf":
            if args.sampler != p.get_default("sampler"):
                raise SystemExit(f"--sampler {args.sampler} expects a VP eps/v model; this "
                                 "checkpoint was trained with --param fm: use --sampler rf")
            args.sampler = "rf"
            print("flow-matching checkpoint: --sampler defaulting to rf")
        # sample on the shifted grid the model was trained for (--fm-shift)
        if float(cfg.get("fm_shift", 1.0)) != 1.0:
            extra_kw["t_shift"] = float(cfg["fm_shift"])
        if args.rf_solver != "euler":
            extra_kw["solver"] = args.rf_solver
    elif args.sampler == "rf":
        raise SystemExit(f"--sampler rf integrates a rectified-flow velocity field; this "
                         f"checkpoint was trained with --param {ckpt_param}: use ode/sde/dpm "
                         "(or ddim for distilled checkpoints)")
    elif args.sampler == "ddim":
        # ddim reads the raw net output (v is its well-conditioned route)
        extra_kw["prediction"] = ckpt_param
    elif ckpt_param == "v":
        apply_fn = eps_apply_from_v(sde, model)
    if cfg.get("distilled"):
        # a distilled student is committed to its grid, with its guidance baked in
        if args.steps == p.get_default("steps"):
            args.steps = int(cfg.get("distill_steps", args.steps))
            print(f"distilled checkpoint: --steps defaulting to {args.steps}")
        if args.t_end == p.get_default("t_end"):
            args.t_end = float(cfg.get("distill_t_end", args.t_end))
        if args.sampler != "ddim":
            print(f"NOTE: checkpoint was distilled for the ddim sampler at "
                  f"{cfg.get('distill_steps')} steps; --sampler {args.sampler} will work but "
                  "wastes the distillation")
        if args.cfg > 0:
            print(f"NOTE: guidance {cfg.get('distill_cfg')} is baked into this distilled "
                  f"checkpoint; --cfg {args.cfg} applies guidance ON TOP of that (use --cfg 0 "
                  "for the trained behaviour)")
    # named after the settings are resolved, so the name tells what was run
    if args.out_path is None:
        os.makedirs(os.path.join(args.out_dir, "results"), exist_ok=True)
        base = os.path.splitext(os.path.basename(ckpt_path))[0]
        args.out_path = os.path.join(
            args.out_dir, "results",
            f"samples_ckpt-{base}_steps{args.steps}_cfg{args.cfg:.2f}"
            f"_tend{args.t_end:g}_sampler{args.sampler}_ema{args.use_ema}.png")

    n_types = int(cfg["n_types"])
    y_cat, y_cont = sample_grid_conditions(args.n, n_types, int(cfg["y_cont_dim"]),
                                           args.theta_max, device=device)
    img_size = int(cfg.get("img_size", 64))
    chunk = args.chunk
    if chunk is None:
        chunk = auto_chunk(img_size, args.steps, args.sampler)
    if chunk == 0:
        chunk = args.n
    if chunk < args.n:
        print(f"sampling {args.n} images in calls of {chunk} (--chunk 0 to disable)")
    with torch.inference_mode():
        x = sample_chunked(SAMPLERS[args.sampler], apply_fn, sde, y_cat, y_cont,
                           (args.n, img_size, img_size, 1), args.seed, chunk=chunk,
                           n_steps=args.steps, guidance_scale=args.cfg, t_end=args.t_end,
                           n_types=n_types, clip_x0=bool(args.clip_x0), **extra_kw)
    side = int(math.ceil(math.sqrt(args.n)))
    save_image_grid(x, args.out_path, nrows=side, ncols=side)
    print(f"Saved samples -> {args.out_path}")
    return SampleRun(x, args.out_path, args.sampler, args.steps, min(chunk, args.n))


def main(argv: list[str] | None = None) -> int:
    sample(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
