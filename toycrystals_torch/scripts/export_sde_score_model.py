#!/usr/bin/env python3
"""Export a score-model checkpoint's sampler as one self-contained file.

    python -m toycrystals_torch.scripts.export_sde_score_model --ckpt <ckpt> --out model.tcx

Counterpart of scripts/export_sde_score_model.py, with its flags: the
serving settings (--sampler, --steps, --cfg, --t-end, --use-ema, --clip-x0,
--dtype, --attn-impl) left unset resolve from the checkpoint as serving
does, and the dispatch at --batch is exported by toycrystals_torch/export.py
(`torch.export`, weights in the file). Consume it with

    from toycrystals_torch.export import load_exported
    fn, meta = load_exported("model.tcx")   # a CUDA artefact: import toycrystals_torch.ops
    x = fn(y_cat, y_cont, seed)            # [batch, H, W, 1] in [0, 1], on its device

--selftest reloads the artefact and checks it against the live service at
--seed (the JAX contract: atol 1e-4) and prints the largest difference it
found. Differences from the JAX CLI: --device defaults to cuda and never
falls back to the CPU; --platform takes one of cuda or cpu (one artefact per
device), and the service is built on it; the JSON line adds the export and
save seconds.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

from toycrystals_torch.scripts._common import add_device_flag, select_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_flag(p)
    p.add_argument("--ckpt", required=True,
                   help="Score-model checkpoint (.msgpack of either package, or a reference .pt).")
    p.add_argument("--out", required=True, help="Artefact path (.tcx).")
    p.add_argument("--batch", type=int, default=36,
                   help="Static batch shape to export (default 36 = the 6x6 grid). One "
                        "artefact per shape, like the serving buckets.")
    p.add_argument("--platform", action="append", default=None, metavar="PLAT",
                   choices=["cuda", "cpu"],
                   help="The device to trace for, one of cuda or cpu (default: --device). A "
                        "cuda artefact calls the port's custom ops; a cpu one needs only torch.")
    p.add_argument("--sampler", default=None, choices=["ode", "sde", "dpm", "ddim", "rf"])
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--cfg", type=float, default=None)
    p.add_argument("--t-end", type=float, default=None)
    p.add_argument("--use-ema", type=int, default=1, choices=[0, 1])
    p.add_argument("--clip-x0", type=int, default=0, choices=[0, 1])
    p.add_argument("--dtype", default="auto", choices=["auto", "float32", "bfloat16"])
    p.add_argument("--attn-impl", default="auto", choices=["auto", "xla", "flash"])
    p.add_argument("--selftest", action="store_true",
                   help="After writing, reload the artefact and check that its output matches "
                        "the live service's at --seed (atol 1e-4; one sampling dispatch).")
    p.add_argument("--seed", type=int, default=0, help="--selftest seed.")
    p.add_argument("--theta-max", type=float, default=math.pi / 3.0,
                   help="--selftest grid conditions sweep.")
    return p


def export(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns the JSON record it prints (with the selftest's
    largest difference when --selftest)."""
    args = build_parser().parse_args(argv)
    if args.platform is not None and len(args.platform) > 1:
        raise SystemExit(f"--platform given {len(args.platform)} times: one artefact is traced "
                         "for one device (multi-platform modules are the JAX package's)")
    device = select_device(args.platform[0] if args.platform else args.device)
    if not os.path.exists(args.ckpt):
        raise FileNotFoundError(args.ckpt)

    from toycrystals_torch.export import (
        export_meta,
        export_service,
        load_exported,
        save_exported,
    )
    from toycrystals_torch.serve import ScoreModelService

    service = ScoreModelService.from_checkpoint(
        args.ckpt, device=device, use_ema=bool(args.use_ema), sampler=args.sampler,
        steps=args.steps, guidance_scale=args.cfg, t_end=args.t_end,
        clip_x0=bool(args.clip_x0), dtype=args.dtype, attn_impl=args.attn_impl,
        buckets=(args.batch,))
    print(f"exporting: sampler={service.sampler_name} steps={service.steps} "
          f"cfg={service.guidance_scale} t_end={service.t_end} batch={args.batch} "
          f"platform={device.type}", file=sys.stderr)
    t0 = time.perf_counter()
    exported = export_service(service, args.batch)
    t1 = time.perf_counter()
    meta = export_meta(service, args.batch, exported)
    save_exported(args.out, exported, meta)
    rec = {"out": args.out, "size_mb": round(os.path.getsize(args.out) / 1e6, 2), **meta,
           "export_seconds": t1 - t0, "save_seconds": time.perf_counter() - t1}

    if args.selftest:
        from toycrystals_torch.models.sde_score_model import sample_grid_conditions

        fn, _ = load_exported(args.out)
        y_cat, y_cont = (t.numpy() for t in sample_grid_conditions(
            args.batch, service.n_types, service.y_cont_dim, args.theta_max))
        got = fn(y_cat, y_cont, args.seed).cpu().numpy()
        want = service.sample(y_cat, y_cont, seed=args.seed)
        diff = float(np.abs(got - want).max())
        np.testing.assert_allclose(got, want, atol=1e-4)
        rec["selftest_max_abs_diff"] = diff
        print(f"selftest: artefact == live service on {args.batch} samples (seed {args.seed}, "
              f"max abs diff {diff:.3e}, atol 1e-4)", file=sys.stderr)
    print(json.dumps(rec))
    return rec


def main(argv: list[str] | None = None) -> int:
    export(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
