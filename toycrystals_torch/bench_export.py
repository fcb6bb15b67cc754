"""Seconds and bytes of exporting a service's sampler against its step count.

    python -m toycrystals_torch.bench_export [--device cuda|cpu] [--steps 4 16 64 ...]
        [--sampler sde] [--base-ch 96] [--img-size 64] [--batch 4] [--dtype bfloat16]
        [--out-dir runs/bench_export] [--json-out PATH]

For each step count, a `ScoreModelService` of a CondUNetTiny with random
weights (flax's default init from --seed; stem none, emb_dim 128, CFG 1.5,
t_end 0.005) is exported at --batch by toycrystals_torch/export.py, and
times the host clock takes for each stage: `export_service` (the trace, its
graph's node count beside it), `save_exported` (the file's bytes beside it),
`load_exported` (reading the file and building the graph module), and the
artefact's first and second call; then the live service's request at the
same seed, and the largest difference between the two (0 when bit-equal).
On a CUDA device the graph calls the port's custom ops, and the gn_silu and
flash launches of one artefact call are counted. Prints one JSON line per
step count, with the card's name and power limit as `nvidia-smi` gives them
(on the CPU: the CPU's, no card). The sampler's Python step loop unrolls
into the graph, so every stage grows with the steps.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_one(args, steps: int, device: torch.device, out_dir: str) -> dict:
    from toycrystals_torch import export as ex
    from toycrystals_torch.models.sde_score_model import CondUNetTiny
    from toycrystals_torch.models.torch_init import flax_default_init
    from toycrystals_torch.ops import attention as at
    from toycrystals_torch.ops import groupnorm as gn
    from toycrystals_torch.serve import ScoreModelService
    from toycrystals_torch.utils.params import flax_from_torch_state_dict

    cfg = dict(n_types=4, y_cont_dim=4, base_ch=args.base_ch, emb_dim=128, cond_ch=8,
               time_ch=8, img_size=args.img_size, dtype=args.dtype)
    net = CondUNetTiny(4, 4, base_ch=args.base_ch, emb_dim=128)
    params = flax_from_torch_state_dict(
        flax_default_init(net, np.random.default_rng(args.seed)).state_dict())
    svc = ScoreModelService(cfg, params, device=device, sampler=args.sampler, steps=steps,
                            guidance_scale=1.5, t_end=0.005, buckets=(args.batch,))
    path = os.path.join(out_dir, f"bench_{steps}.tcx")
    rec = {"device": str(device), "sampler": svc.sampler_name, "steps": steps,
           "batch": args.batch, "base_ch": args.base_ch, "img_size": args.img_size,
           "dtype": args.dtype}
    t0 = time.perf_counter()
    ep = ex.export_service(svc, args.batch)
    rec["export_seconds"] = time.perf_counter() - t0
    rec["graph_nodes"] = len(ep.graph.nodes)
    rec["custom_ops"] = ex.custom_ops(ep)
    t0 = time.perf_counter()
    ex.save_exported(path, ep, ex.export_meta(svc, args.batch, ep))
    rec["save_seconds"] = time.perf_counter() - t0
    rec["bytes"] = os.path.getsize(path)
    del ep
    t0 = time.perf_counter()
    fn, _ = ex.load_exported(path)
    rec["load_seconds"] = time.perf_counter() - t0
    y_cat = np.arange(args.batch, dtype=np.int32) % 4
    y_cont = np.zeros((args.batch, 4), np.float32)
    y_cont[:, 1] = np.linspace(0.0, 1.0, args.batch)
    for key in ("first_call_seconds", "call_seconds"):
        gn.gn_silu.launches = at.flash_sdpa.launches = 0
        t0 = time.perf_counter()
        got = fn(y_cat, y_cont, args.seed)
        _sync(device)
        rec[key] = time.perf_counter() - t0
    rec["gn_silu_launches_per_call"] = gn.gn_silu.launches
    rec["flash_launches_per_call"] = at.flash_sdpa.launches
    t0 = time.perf_counter()
    want = svc.sample(y_cat, y_cont, seed=args.seed)
    rec["service_seconds"] = time.perf_counter() - t0
    rec["max_abs_diff"] = float(np.abs(got.cpu().numpy() - want).max())
    os.remove(path)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, nargs="+", default=[4, 16, 64])
    ap.add_argument("--sampler", default="sde", choices=["sde", "ode", "dpm", "ddim"])
    ap.add_argument("--base-ch", type=int, default=96)
    ap.add_argument("--img-size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=os.path.join("runs", "bench_export"),
                    help="where the artefacts are written (each is removed after its line)")
    ap.add_argument("--json-out", default=None, help="also append each line to this file")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch.cuda.is_available() is False")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card() if device.type == "cuda" else "cpu"
    os.makedirs(args.out_dir, exist_ok=True)
    for steps in args.steps:
        rec = dict(run_one(args, steps, device, args.out_dir), card=card)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.json_out:
            with open(args.json_out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
