"""Pipeline A (VAE -> latent diffusion prior) at the README's recipe on one CUDA
card, timed step by step and scored.

    python -m toycrystals_torch.bench_pipeline_a [--out-dir runs/pipeline_a]
        [--items 50000] [--vae-epochs 15] [--prior-epochs 300] [--seeds 0 1 2]
        [--json-out PATH] [--device cuda]

The README's Quickstart steps 1-3 through the port's CLIs, in one process:

1. build_dataset --n-samples ITEMS (rot-only 64x64, .npz);
2. train_vae --epochs 15 --z-dim 32 --batch-size 128 --lr 2e-3 on that archive;
3. train_diffusion_prior --T 1000 --beta-end 0.05 --width 1024 --epochs 300
   --batch-size 256 --lr 1e-4 --z-target mu on the same archive and VAE,
   without in-training grids.

Then, at each sampling seed, the prior's DDIM-50 grid (--sample-only --seed
s) and the VAE's standard-prior and mixture-of-posteriors grids (train_vae's
diagnostics at --seed s), each scored by the eval CLI's --grid with the
latent FID of assets/eval/feature_vae_z16.msgpack. Prints one JSON line: the
card, each step's wall seconds and per-epoch rates, and the scores of every
grid. The grids stay under --out-dir/grids. `--device cpu` rehearses it on
the CPU at a small --items and few epochs.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

import numpy as np
import torch

SCORES = ("type_acc", "type_acc_merged01", "theta_mae_deg", "cond_fidelity", "fid",
          "fid_floor")
EXTRACTOR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                         "eval", "feature_vae_z16.msgpack")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out-dir", default="runs/pipeline_a")
    p.add_argument("--items", type=int, default=50_000)
    p.add_argument("--vae-epochs", type=int, default=15)
    p.add_argument("--prior-epochs", type=int, default=300)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--json-out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    dev_flag = ["--device", args.device]

    from toycrystals_torch.scripts import build_dataset, eval_sde_score_model as eval_cli
    from toycrystals_torch.scripts import train_diffusion_prior as prior_cli
    from toycrystals_torch.scripts import train_vae as vae_cli
    from toycrystals_torch.scripts._common import ResidentDiskDataset

    out_dir = os.path.abspath(args.out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    grids = os.path.join(out_dir, "grids")
    os.makedirs(grids)
    archive = os.path.join(out_dir, "toycrystals_train_rotonly.npz")
    rec: dict = {"card": card() if device.type == "cuda" else "cpu",
                 "torch": torch.__version__, "items": args.items}

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        rec[f"{name}_seconds"] = time.perf_counter() - t0
        print(f"{name}: {rec[f'{name}_seconds']:.1f} s", flush=True)
        return result

    timed("build_dataset", lambda: build_dataset.build(
        [*dev_flag, "--n-samples", str(args.items), "--out", archive]))
    vae_flags = [*dev_flag, "--data-path", archive, "--epochs", str(args.vae_epochs),
                 "--z-dim", "32", "--batch-size", "128", "--lr", "2e-3", "--out-dir", out_dir]
    vae = timed("train_vae", lambda: vae_cli.train(vae_flags))
    rec["vae_img_per_s"] = vae.images_per_second
    rec["vae_loss"] = vae.hists["loss"]
    prior_flags = [*dev_flag, "--data-path", archive, "--T", "1000", "--beta-end", "0.05",
                   "--width", "1024", "--batch-size", "256", "--lr", "1e-4", "--z-target", "mu",
                   "--out-dir", out_dir]
    prior = timed("train_diffusion_prior", lambda: prior_cli.train(
        prior_flags + ["--epochs", str(args.prior_epochs), "--sample-every", "0"]))
    rec["prior_cache_seconds"] = prior.cache_seconds
    rec["prior_z_per_s"] = prior.z_per_second
    rec["prior_loss"] = prior.loss_hist
    rec["prior_buckets_last"] = prior.bucket_hist[-1]

    ds = ResidentDiskDataset(archive, device)
    vae.model.eval()
    rec["scores"] = {}
    for s in args.seeds:
        run = prior_cli.train(prior_flags + ["--sample-only", "--seed", str(s)])
        rec.setdefault("prior_ddim50_36_seconds", []).append(run.sample_seconds[-1])
        paths = {"prior_ddim50": os.path.join(grids, f"prior_ddim50_seed{s}.png")}
        shutil.copy(run.figure, paths["prior_ddim50"])
        vargs = vae_cli.build_parser().parse_args(vae_flags + ["--seed", str(s)])
        vdir = os.path.join(grids, f"vae_seed{s}")
        figs, _ = vae_cli._diagnostics(vargs, vae.model, ds.gather, len(ds),
                                       np.random.default_rng(s), device, vdir)
        paths["vae_prior"], paths["vae_mop"] = figs["samples_prior"], figs["samples_mop"]
        for name, path in paths.items():
            line = eval_cli.evaluate([*dev_flag, "--grid", path, "--fid-vae", EXTRACTOR]).line
            rec["scores"].setdefault(name, []).append({k: line[k] for k in SCORES})
    for name, per_seed in rec["scores"].items():
        print(f"{name}: " + ", ".join(f"{k} {np.mean([d[k] for d in per_seed]):.4f}"
                                      for k in ("cond_fidelity", "theta_mae_deg", "fid")))
    line = json.dumps(rec)
    print(line)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    return rec


if __name__ == "__main__":
    main()
