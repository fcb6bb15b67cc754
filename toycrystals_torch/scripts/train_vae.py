#!/usr/bin/env python3
"""Train the (conditional) VAE on the GPU and write its three diagnostic grids.

    python -m toycrystals_torch.scripts.train_vae --procedural [flags]

Counterpart of scripts/train_vae.py, with its flags and defaults (z_dim 32,
batch 128, 15 epochs, lr 2e-3, free bits 0.05, beta 3e-4 warmed up over 5
epochs, --cond / --uncond, --procedural, --data-path, --resume,
--async-ckpt, --clip-grad-norm): MSE reconstruction + beta_eff * the
free-bits KL, one checkpoint per epoch at checkpoints/vae_last.msgpack in the
JAX layout (`params`, `config`, `opt_state`, `epoch_next`, `hists`: the
bytes JAX's `save_checkpoint` writes for the same state, so the JAX latent
prior's trainer reads it), then results/vae_recon.png (16 (X, X_hat) pairs),
results/vae_samples_prior.png (36 decodes of standard-normal z on the 6x6
grid conditions) and results/vae_samples_mop.png (mixture of posteriors: a
4,096-item pool, for each grid condition the pool item of its type at the
nearest theta, encoded, sampled and decoded with the target condition).

Differences from the JAX CLI: --device defaults to cuda and never falls back
to the CPU; --out-dir (default: the working directory, where the JAX CLI
writes) holds checkpoints/ and results/; the grids are 8-bit PNGs of the
pixels without titles (utils/figures.py) and no loss-curve PNG is written
(the histories are in the checkpoint); each epoch draws from a generator
seeded by (--seed, epoch), so a resumed run repeats the draws of an
uninterrupted one.

--shard N trains over N ranks (one process per device, spawned here unless
the cluster flags --coordinator/--num-processes/--process-id join ranks
started elsewhere), each with its rows of every batch, under
DistributedDataParallel, or FSDP2 with --fsdp; the numbers are the one-device
run's up to the order of reductions, and rank 0 writes the checkpoint and the
grids. --shard-model M splits every conv's, transposed conv's and dense
layer's output channels over M ranks as well (a --shard x M ("data",
"model") mesh, parallel/tensor.py; with --fsdp each rank's blocks are
sharded over --shard too). The checkpoint is gathered to one process's
bytes, and the grids are drawn from the gathered state, as under --fsdp.
Across hosts --fsdp and --shard-model are refused, as in JAX (msgpack
checkpoints only).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Any

import numpy as np
import torch

from toycrystals_torch.data.datasets import batch_iterator, generate_batch
from toycrystals_torch.data.lattice import LatticeConfig, static_point_budget
from toycrystals_torch.models.sde_score_model import chunk_seed, sample_grid_conditions
from toycrystals_torch.models.torch_init import flax_default_init
from toycrystals_torch.models.vae import VAE, CondVAE
from toycrystals_torch.parallel.fsdp import full
from toycrystals_torch.parallel.mesh import data_sharding
from toycrystals_torch.parallel.multihost import is_primary
from toycrystals_torch.scripts._common import (
    ResidentDiskDataset,
    add_device_flag,
    add_parallel_flags,
    any_rank,
    init_distributed,
    place_state,
    select_device,
    setup_mesh,
    spawn_shards,
)
from toycrystals_torch.train.state import Optimizer, TrainState, create_train_state
from toycrystals_torch.train.steps import make_vae_train_epoch, make_vae_train_step
from toycrystals_torch.utils.checkpoint import (
    AsyncCheckpointer,
    float_list,
    load_checkpoint,
    save_checkpoint,
)
from toycrystals_torch.utils.figures import save_image_grid, save_recon_grid
from toycrystals_torch.utils.params import (
    VAE as VAE_BRIDGE,
    load_train_state_from_checkpoint,
    train_state_to_checkpoint,
    torch_state_dict_from_flax_vae,
)
from toycrystals_torch.utils.preempt import GracefulShutdown

HISTS = ("loss", "recon", "kl", "kl_raw")
N_GRID = 36
POOL_SIZE = 4096


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--img-size", type=int, default=64)
    p.add_argument("--n-samples", type=int, default=50_000)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--clip-grad-norm", type=float, default=0.0,
                   help="Clip gradients to this global L2 norm before Adam (0 = off). Changes "
                        "the optimizer-state layout: pass the same value when resuming.")
    p.add_argument("--z-dim", type=int, default=32)
    p.add_argument("--n-types", type=int, default=4)
    p.add_argument("--y-cont-dim", type=int, default=4)
    p.add_argument("--beta", type=float, default=0.0003)
    add_device_flag(p)
    p.add_argument("--data-path", type=str, default="data/toycrystals_train_rotonly.npz")
    p.add_argument("--procedural", action="store_true",
                   help="render rot-only batches on the device, no files")
    p.add_argument("--cond-drop", type=float, default=0.0)
    p.add_argument("--num-workers", type=int, default=0,
                   help="Accepted for the reference's command line; unused (batches are "
                        "rendered or gathered on the device).")
    p.add_argument("--uncond", dest="uncond", action="store_true",
                   help="Train the unconditional VAE.")
    p.add_argument("--cond", dest="uncond", action="store_false",
                   help="Train the conditional VAE (the default).")
    p.add_argument("--fused-epoch", type=int, default=1, choices=[0, 1],
                   help="1: make_vae_train_epoch (shuffle and batches on the device); 0: one "
                        "step per host batch of indices.")
    p.add_argument("--free-bits", type=float, default=0.05,
                   help="Free bits threshold in nats per latent dim (0 disables).")
    p.add_argument("--resume", action="store_true",
                   help="Resume from checkpoints/vae_last.msgpack (params, optimizer state, "
                        "epoch, loss histories).")
    p.add_argument("--async-ckpt", type=int, default=1, choices=[0, 1],
                   help="Encode and write checkpoints on a thread while the next epoch "
                        "trains; the process waits for the last write. 0 = synchronous.")
    p.add_argument("--out-dir", type=str, default=".",
                   help="Directory holding checkpoints/ and results/ (default: the working "
                        "directory, as the JAX CLI).")
    add_parallel_flags(p, space=False)
    p.set_defaults(uncond=False)
    return p


@dataclasses.dataclass
class VaeTrainRun:
    """What a run leaves in memory: the state as last saved, its pieces, the
    histories, this process's per-epoch seconds and img/s, the grids'
    paths and the images drawn into them."""

    state: TrainState
    model: torch.nn.Module
    tx: Optimizer
    config: dict[str, Any]
    hists: dict[str, list[float]]
    epoch_seconds: list[float]
    images_per_second: list[float]
    figures: dict[str, str]
    images: dict[str, np.ndarray]


def train(argv: list[str] | None = None) -> VaeTrainRun:
    p = build_parser()
    args = p.parse_args(argv)
    if init_distributed(args, args.device) and (args.fsdp or args.shard_model > 1):
        # msgpack-only checkpoints: the save gathers the whole state to one host
        raise SystemExit("multi-host --fsdp/--shard-model is unsupported in this trainer "
                         "(msgpack checkpoints gather every shard to one host); drop the flag "
                         "or train single-host")
    device = select_device(args.device)
    mesh = setup_mesh(args.shard, args.batch_size, device=device, shard_model=args.shard_model)
    primary = is_primary()
    say = print if primary else (lambda *a, **k: None)
    ckpt_path = os.path.join(args.out_dir, "checkpoints", "vae_last.msgpack")
    results_dir = os.path.join(args.out_dir, "results")
    os.makedirs(results_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    # --- data ---
    procedural = args.procedural or not args.data_path
    if procedural:
        # no data path: the full-variability set; --procedural keeps rot-only
        lattice_cfg = LatticeConfig(img_size=args.img_size, n_types=args.n_types,
                                    rot_only=args.procedural)
        n_items = args.n_samples
        budget = static_point_budget(lattice_cfg)

        def get_batch(idx):
            return generate_batch(lattice_cfg, args.seed, torch.as_tensor(idx, device=device),
                                  budget, device)
    else:
        ds = ResidentDiskDataset(args.data_path, device)
        n_items = len(ds)
        get_batch = ds.gather
    if n_items < args.batch_size:
        raise SystemExit(f"{n_items} items make no batch of {args.batch_size}")

    # --- model, optimizer, state ---
    if not args.uncond:
        say("Training conditional VAE")
    model = _build_model(args)
    flax_default_init(model, np.random.default_rng(args.seed))
    model.to(device)
    tx = Optimizer(args.lr, clip_grad_norm=args.clip_grad_norm)
    state = create_train_state(model, tx)

    start_epoch = 0
    hists: dict[str, list[float]] = {k: [] for k in HISTS}
    if args.resume and os.path.exists(ckpt_path):
        raw = load_checkpoint(ckpt_path)
        try:
            if "opt_state" in raw:
                load_train_state_from_checkpoint(
                    state, tx, {"step": 0, "params": raw["params"],
                                "opt_state": raw["opt_state"], "ema_params": None},
                    bridge=VAE_BRIDGE)
                state.step = state.opt_state.count
            else:
                model.load_state_dict({k: torch.from_numpy(v) for k, v in
                                       torch_state_dict_from_flax_vae(raw["params"]).items()})
        except (KeyError, ValueError, RuntimeError) as e:
            raise SystemExit(f"--resume from {ckpt_path}: {e}") from e
        start_epoch = int(raw.get("epoch_next", 0))
        for k in HISTS:
            hists[k] = float_list(raw.get("hists", {}).get(k, []))
        say(f"resumed from: {ckpt_path} (next epoch {start_epoch + 1})")

    module, state = place_state(mesh, model, state, fsdp=args.fsdp)
    sharded = mesh is not None and (args.fsdp or args.shard_model > 1)  # no rank holds it all
    if args.fused_epoch:
        epoch_fn = make_vae_train_epoch(
            module, tx, args.free_bits, args.batch_size, n_items, uncond=args.uncond,
            lattice_cfg=lattice_cfg if procedural else None, dataset_seed=args.seed,
            resident=None if procedural else ds.arrays, mesh=mesh)
    else:
        step = make_vae_train_step(module, tx, args.free_bits, uncond=args.uncond, mesh=mesh)
        mine = data_sharding(mesh, args.batch_size)

    config = {"z_dim": args.z_dim, "n_types": args.n_types, "y_cont_dim": args.y_cont_dim,
              "cond_drop": args.cond_drop, "uncond": args.uncond, "img_size": args.img_size}

    say("starting training loop...")
    n_batches = n_items // args.batch_size
    epoch_seconds: list[float] = []
    ips_hist: list[float] = []
    ckptr = AsyncCheckpointer()
    save_ckpt = ckptr.save if args.async_ckpt else save_checkpoint
    model.train()
    with GracefulShutdown() as stop, ckptr:
        for epoch in range(start_epoch, args.epochs):
            beta_eff = args.beta * min(1.0, (epoch + 1) / 5.0)  # the KL warm-up
            t0 = time.perf_counter()
            # one generator per epoch, seeded by (seed, epoch): the shuffle and
            # every step's draws; a resumed run repeats them
            gen = torch.Generator(device=device).manual_seed(chunk_seed(args.seed, epoch))
            if args.fused_epoch:
                state, em = epoch_fn(state, beta_eff, gen)
            else:
                ms = []
                for bidx in batch_iterator(n_items, args.batch_size,
                                           rng=np.random.default_rng([args.seed, epoch])):
                    x, y_cat, y_cont = get_batch(bidx[mine])
                    state, m = step(state, x, y_cat, y_cont, beta_eff, gen)
                    ms.append(m)
                em = {k: torch.stack([m[k] for m in ms]).mean() for k in HISTS}
            avg = {k: float(v) for k, v in em.items()}  # one host sync per epoch
            dt = time.perf_counter() - t0
            if not math.isfinite(avg["loss"]):
                # halt before the save, so the last checkpoint with a finite loss survives
                raise SystemExit(f"epoch {epoch + 1}: non-finite loss ({avg['loss']}): training "
                                 f"diverged; last good checkpoint kept at {ckpt_path}.")
            for k in HISTS:
                hists[k].append(avg[k])
            epoch_seconds.append(dt)
            ips_hist.append(n_batches * args.batch_size / dt)
            say(f"epoch {epoch + 1:02d}/{args.epochs} loss={avg['loss']:.4f} "
                f"recon={avg['recon']:.4f} kl={avg['kl']:.6f} ({ips_hist[-1]:.0f} img/s)")
            if primary or sharded:  # a collective under --fsdp and --shard-model
                ck = train_state_to_checkpoint(state, tx, bridge=VAE_BRIDGE)
            if primary:
                # `params` stays top-level, the schema the latent prior's trainer reads
                save_ckpt(ckpt_path, {"params": ck["params"], "config": config,
                                      "opt_state": ck["opt_state"], "epoch_next": epoch + 1,
                                      "hists": {k: list(hists[k]) for k in HISTS}})
            if any_rank(mesh, stop.requested, device):
                say(f"preempted ({stop.signame}) after epoch {epoch + 1}: checkpoint saved at "
                      f"{ckpt_path}; continue with --resume")
                return VaeTrainRun(state, module, tx, config, hists, epoch_seconds, ips_hist,
                                   {}, {})
    model.eval()
    if sharded:
        # the grids run outside the sharded forward: a whole copy (gathered
        # on every rank, drawn by rank 0)
        whole = {k: full(v).detach() for k, v in state.params.items()}
        model = _build_model(args).to(device).eval()
        model.load_state_dict(whole)
    figures, images = {}, {}
    if primary:
        figures, images = _diagnostics(args, model, get_batch, n_items, rng, device,
                                       results_dir)
        print("saved: " + ", ".join(figures.values()))
    return VaeTrainRun(state, module, tx, config, hists, epoch_seconds, ips_hist, figures,
                       images)


@torch.no_grad()
def _diagnostics(args, model, get_batch, n_items: int, rng: np.random.Generator, device,
                 results_dir: str) -> tuple[dict[str, str], dict[str, np.ndarray]]:
    """The recon, standard-prior and mixture-of-posteriors grids."""
    gen = torch.Generator(device=device).manual_seed(chunk_seed(args.seed, args.epochs))
    figures = {k: os.path.join(results_dir, f"vae_{k}.png")
               for k in ("recon", "samples_prior", "samples_mop")}

    # reconstructions of 16 items of one fresh batch
    x0, y0_cat, y0_cont = get_batch(rng.permutation(n_items)[:args.batch_size])
    x0, y0_cat, y0_cont = x0[:16], y0_cat[:16], y0_cont[:16]
    args_x = (x0,) if args.uncond else (x0, y0_cat, y0_cont)
    x_hat = model(*args_x, generator=gen)[0]
    save_recon_grid(x0.cpu().numpy(), x_hat.cpu().numpy(), figures["recon"])

    # standard-prior samples on the 6x6 grid conditions
    z = torch.randn((N_GRID, args.z_dim), generator=gen, device=device)
    yg_cat, yg_cont = sample_grid_conditions(N_GRID, args.n_types, args.y_cont_dim,
                                             device=device)
    x_prior = model.decode(z) if args.uncond else model.decode(z, yg_cat, yg_cont)
    save_image_grid(x_prior.cpu().numpy(), figures["samples_prior"])

    # mixture of posteriors: encode pool items, decode with the target condition
    px, pcat, pcont = get_batch(rng.permutation(n_items)[:min(POOL_SIZE, n_items)])
    if args.uncond:
        sel = torch.randint(0, px.shape[0], (N_GRID,), generator=gen, device=device)
        mu, logvar = model.encode(px[sel])
    else:
        # per target: the pool item of the same type at the nearest theta
        d = (pcont[None, :, 1] - yg_cont[:, None, 1]).abs()
        d = torch.where(pcat[None, :] == yg_cat[:, None], d, torch.full_like(d, math.inf))
        sel = d.argmin(dim=1)
        mu, logvar = model.encode(px[sel], pcat[sel], pcont[sel])
    z = model.reparameterise(mu, logvar, gen)
    x_mop = model.decode(z) if args.uncond else model.decode(z, yg_cat, yg_cont)
    save_image_grid(x_mop.cpu().numpy(), figures["samples_mop"])
    images = {"recon_x": x0.cpu().numpy(), "recon_x_hat": x_hat.cpu().numpy(),
              "samples_prior": x_prior.cpu().numpy(), "samples_mop": x_mop.cpu().numpy()}
    return figures, images


def _build_model(args) -> torch.nn.Module:
    if args.uncond:
        return VAE(z_dim=args.z_dim)
    return CondVAE(z_dim=args.z_dim, n_types=args.n_types, y_cont_dim=args.y_cont_dim,
                   cond_drop=args.cond_drop)


def main(argv: list[str] | None = None) -> int:
    """The CLI: `train(argv)` in this process, or in --shard N spawned ranks."""
    args = build_parser().parse_args(argv)
    if not spawn_shards(args, train, argv, (args.batch_size,)):
        train(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
