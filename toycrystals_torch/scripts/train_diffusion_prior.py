#!/usr/bin/env python3
"""Train the latent diffusion prior on the cached latents of a frozen VAE, on the GPU.

    python -m toycrystals_torch.scripts.train_diffusion_prior --vae-ckpt PATH [flags]

Counterpart of scripts/train_diffusion_prior.py, with its flags and defaults
(T 200, beta 1e-4 to 1.0, width 512, 8 FiLM blocks, y_cat_emb_dim 64, batch
256, lr 1e-4, 600 epochs, DDIM-50):

- the frozen CondVAE from --vae-ckpt: a msgpack checkpoint of either
  package's train_vae, or the reference's torch `vae_last.pt`;
- the latent cache: every item of --data-path (or, with --procedural, of the
  rot-only procedural set, up to --max-items) encoded in batches of 512,
  z = mu or a posterior sample (--z-target), written with np.savez as z0,
  y_cat, y_cont, z_mean, z_std (population std, floored at 1e-6) and reused
  unless --rebuild-latents; the prior trains on (z0 - z_mean) / z_std;
- t = clamp(int(u^2 T), 0, T - 1), the eps-MSE, and the 4-bucket losses over
  t, printed per epoch beside z/s; a non-finite epoch loss stops the run
  before the checkpoint write;
- --moe-experts E trains `DiffusionPriorMoE` (switch top-1 experts per block)
  with --moe-aux-weight x its load-balancing term;
- the checkpoint {params, config} (the JAX CLI's keys, n_experts included;
  the bytes JAX's `save_checkpoint` writes), weights only: --resume loads
  them and trains --epochs more epochs with a fresh Adam, as JAX does;
  --sample-only also reads the reference's `diffusion_prior_last.pt`;
- the DDIM grid results/diffusion_samples.png: 36 latents on the 6x6 grid
  conditions, un-standardised and decoded by the VAE.

Differences from the JAX CLI: --device defaults to cuda and never falls back
to the CPU; --out-dir (default: the working directory, where the JAX CLI
writes) holds results/, and relative --vae-ckpt, --latent-cache and
--prior-ckpt paths resolve under it; the grid is an 8-bit PNG of the pixels
without titles (utils/figures.py) and no loss-curve PNG is written; each
epoch draws its shuffle and steps from a generator seeded by (--seed,
epoch).

--shard N trains over N ranks (one process per device, spawned here unless
the cluster flags --coordinator/--num-processes/--process-id join ranks
started elsewhere), each with its rows of every batch, under
DistributedDataParallel, or FSDP2 with --fsdp; the MoE prior's routing
statistics, the losses and the bucket diagnostics are the global batch's,
so the numbers are the one-device run's up to the order of reductions.
Rank 0 writes the cache, the checkpoint and the grid. --shard-model M
splits every dense layer's and embedding's output features over M ranks as
well (a --shard x M ("data", "model") mesh, parallel/tensor.py; with --fsdp
each rank's blocks are sharded over --shard too); the checkpoint is gathered
to one process's bytes and the DDIM grid runs through the placed model on
every rank, as under --fsdp. --shard-pipe S runs the FiLM prior's 8 blocks
as S stages of a pipeline of --pipe-micro microbatches (a --shard x S
("data", "pipe") mesh, parallel/pipeline.py): each rank holds the stem, the
head and its stage's blocks with their Adam moments, and the DDIM grid runs
through the pipeline where 36 divides by --shard x --pipe-micro, else on
every rank from the gathered weights, as JAX's does. --moe-experts E
--shard-expert N splits each block's experts, and every leaf JAX's expert
rule shards, over N ranks (a --shard x N ("data", "expert") mesh,
parallel/expert.py); the grid runs through the placed model. Under both the
checkpoint is gathered to one process's bytes, and --fsdp changes nothing,
as in JAX. Across hosts --fsdp, --shard-model, --shard-pipe and
--shard-expert are refused, as in JAX (msgpack checkpoints only), and so are
JAX's other exclusions (--shard-expert with --shard-pipe or --shard-model,
--shard-pipe with --shard-model or --moe-experts, --shard-expert without
--moe-experts divisible by it, 8 blocks that --shard-pipe does not divide,
a batch that --shard x --pipe-micro does not divide).
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
from toycrystals_torch.models.diffusion_prior import (
    DiffusionPriorFiLM,
    DiffusionSchedule,
    ddim_sample,
)
from toycrystals_torch.models.moe_prior import DiffusionPriorMoE
from toycrystals_torch.models.sde_score_model import chunk_seed, sample_grid_conditions
from toycrystals_torch.models.torch_init import flax_default_init
from toycrystals_torch.models.vae import CondVAE
from toycrystals_torch.parallel.fsdp import full_tensors
from toycrystals_torch.parallel.mesh import AXIS, axis_group, axis_size, data_sharding
from toycrystals_torch.parallel.multihost import is_primary
from toycrystals_torch.parallel.spatial import dispatch_scope
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
from toycrystals_torch.train.steps import make_prior_train_epoch, make_prior_train_step
from toycrystals_torch.utils.checkpoint import AsyncCheckpointer, load_checkpoint, save_checkpoint
from toycrystals_torch.utils.figures import save_image_grid
from toycrystals_torch.utils.params import (
    flax_prior_from_torch_state_dict,
    torch_state_dict_from_flax_prior,
    torch_state_dict_from_flax_vae,
)
from toycrystals_torch.utils.preempt import GracefulShutdown
from toycrystals_torch.utils.rng import randn
from toycrystals_torch.utils.torch_interop import (
    load_torch_prior_checkpoint,
    load_torch_vae_checkpoint,
)

N_BLOCKS, Y_CAT_EMB_DIM = 8, 64  # fixed by the trainer, as in the reference
ENCODE_BATCH = 512
N_GRID = 36
_CACHE_STREAM = 2**32 - 1  # generator stream of the --z-target sample draws


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    add_device_flag(p)
    p.add_argument("--data-path", type=str, default="data/toycrystals_train_rotonly.npz")
    p.add_argument("--procedural", action="store_true",
                   help="render rot-only batches on the device (no image archive)")
    p.add_argument("--vae-ckpt", type=str, default="checkpoints/vae_last.msgpack")
    p.add_argument("--z-dim", type=int, default=32)
    p.add_argument("--n-types", type=int, default=4)
    p.add_argument("--y-cont-dim", type=int, default=4)
    p.add_argument("--z-target", type=str, choices=["mu", "sample"], default="mu")
    p.add_argument("--latent-cache", type=str, default="data/latents_rotonly_mu.npz")
    p.add_argument("--rebuild-latents", action="store_true")
    p.add_argument("--max-items", type=int, default=50_000)
    p.add_argument("--T", type=int, default=200)
    p.add_argument("--beta-start", type=float, default=1e-4)
    p.add_argument("--beta-end", type=float, default=1.0)
    p.add_argument("--t-emb-dim", type=int, default=64)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=600)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--clip-grad-norm", type=float, default=0.0,
                   help="Clip gradients to this global L2 norm before Adam (0 = off).")
    p.add_argument("--ddim-steps", type=int, default=50)
    p.add_argument("--prior-ckpt", type=str, default="checkpoints/diffusion_prior_last.msgpack")
    p.add_argument("--resume", action="store_true",
                   help="Start from the weights in --prior-ckpt (a fresh Adam state).")
    p.add_argument("--sample-only", action="store_true",
                   help="Write the DDIM grid of --prior-ckpt (msgpack or the reference's "
                        ".pt) and exit.")
    p.add_argument("--fused-epoch", type=int, default=1, choices=[0, 1],
                   help="1: make_prior_train_epoch (shuffle and gathers on the device); 0: one "
                        "step per host batch of indices.")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="Save the prior checkpoint every N epochs (always at the end; 0 = end "
                        "only).")
    p.add_argument("--async-ckpt", type=int, default=1, choices=[0, 1],
                   help="Encode and write checkpoints on a thread while the next epoch "
                        "trains; the process waits for the last write. 0 = synchronous.")
    add_parallel_flags(p, space=False)
    p.add_argument("--shard-pipe", type=int, default=0,
                   help="Pipeline parallelism: place the prior's 8 FiLM blocks on N stages of a "
                        "('data','pipe') mesh and stream microbatches through them (one rank "
                        "per stage, hand-placed hops between neighbouring stages, "
                        "parallel/pipeline.py). Composes with --shard; 8 must divide by N. "
                        "--fsdp changes nothing under it, as in JAX. 0/1 = off.")
    p.add_argument("--pipe-micro", type=int, default=4,
                   help="Microbatches per pipeline replica (bubble fraction = (stages-1)/"
                        "(micro+stages-1)). batch-size must divide by max(1,--shard) * this. "
                        "Ignored without --shard-pipe.")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="Train the mixture-of-experts prior: E switch-routed expert MLPs per "
                        "block, routed on the (t, y) conditioning. 0 = dense. Recorded in the "
                        "checkpoint's config; --resume and --sample-only need the same value.")
    p.add_argument("--moe-aux-weight", type=float, default=0.01,
                   help="Weight of the switch load-balancing auxiliary loss (only with "
                        "--moe-experts).")
    p.add_argument("--shard-expert", type=int, default=0,
                   help="Expert parallelism: shard the MoE prior's stacked experts (and their "
                        "Adam moments) over N devices of a ('data','expert') mesh; the "
                        "per-block combine is one sum over the expert ranks "
                        "(parallel/expert.py). Requires --moe-experts divisible by N; "
                        "composes with --shard; --fsdp changes nothing under it, as in JAX. "
                        "0/1 = off.")
    p.add_argument("--sample-every", type=int, default=1,
                   help="epochs between DDIM grids; 0 disables in-training grids")
    p.add_argument("--out-dir", type=str, default=".",
                   help="Directory holding results/ and, for relative paths, the VAE and "
                        "prior checkpoints and the latent cache (default: the working "
                        "directory, as the JAX CLI).")
    return p


@dataclasses.dataclass
class PriorTrainRun:
    """What a run leaves in memory: the state, its pieces, the latent
    statistics, this process's per-epoch losses, bucket losses, seconds and
    z/s, the cache build's seconds (None when the cache was read), each DDIM
    grid's sampling seconds, and the last grid's path and images."""

    state: TrainState | None
    model: torch.nn.Module
    config: dict[str, Any]
    z_mean: torch.Tensor
    z_std: torch.Tensor
    loss_hist: list[float]
    bucket_hist: list[list[float]]
    epoch_seconds: list[float]
    z_per_second: list[float]
    cache_seconds: float | None
    sample_seconds: list[float]
    figure: str | None
    samples: np.ndarray | None


def _under(out_dir: str, path: str) -> str:
    return path if os.path.isabs(path) else os.path.join(out_dir, path)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_frozen_vae(path: str, z_dim: int, n_types: int, y_cont_dim: int,
                    device: torch.device) -> CondVAE:
    """The CondVAE of a msgpack checkpoint (`{"params": ...}` or a bare
    tree) or of the reference's `.pt`, in eval mode without gradients."""
    obj = load_torch_vae_checkpoint(path) if path.endswith(".pt") else load_checkpoint(path)
    params = obj["params"] if "params" in obj else obj
    vae = CondVAE(z_dim=z_dim, n_types=n_types, y_cont_dim=y_cont_dim, cond_drop=0.0)
    vae.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
                         torch_state_dict_from_flax_vae(params).items()})
    return vae.to(device).eval().requires_grad_(False)


@torch.no_grad()
def build_latent_cache(vae: CondVAE, get_batch, n_items: int, z_target: str,
                       generator: torch.Generator) -> tuple[torch.Tensor, ...]:
    """(z0, y_cat, y_cont, z_mean, z_std) of every item, encoded in batches of
    ENCODE_BATCH; z0 = mu, or mu + exp(logvar / 2) eps with eps from
    `generator`."""
    zs, cats, conts = [], [], []
    for start in range(0, n_items, ENCODE_BATCH):
        x, yc, yv = get_batch(np.arange(start, min(start + ENCODE_BATCH, n_items)))
        mu, logvar = vae.encode(x, yc, yv)
        if z_target == "sample":
            mu = mu + torch.exp(0.5 * logvar) * torch.randn(mu.shape, generator=generator,
                                                            device=mu.device)
        zs.append(mu)
        cats.append(yc)
        conts.append(yv)
    z0 = torch.cat(zs)
    return (z0, torch.cat(cats).to(torch.int32), torch.cat(conts).to(torch.float32),
            z0.mean(dim=0, keepdim=True),
            z0.std(dim=0, keepdim=True, correction=0).clamp_min(1e-6))


def train(argv: list[str] | None = None) -> PriorTrainRun:
    p = build_parser()
    args = p.parse_args(argv)
    pipe, ep = _refuse(args)
    multihost = init_distributed(args, args.device)
    if multihost and (args.fsdp or args.shard_model > 1 or pipe or ep):
        # msgpack-only checkpoints: the save gathers the whole state to one host,
        # impossible under any weight-sharding axis that spans processes
        raise SystemExit("multi-host --fsdp/--shard-model/--shard-pipe/--shard-expert is "
                         "unsupported in this trainer (msgpack checkpoints gather every "
                         "shard to one host); drop the flag or train single-host")
    device = select_device(args.device)
    mesh = setup_mesh(args.shard, args.batch_size, device=device, shard_model=args.shard_model,
                      shard_pipe=pipe, shard_expert=ep)
    primary = is_primary()
    say = print if primary else (lambda *a, **k: None)
    n_data = max(1, args.shard)
    if pipe:
        say(f"2-D mesh: {n_data} data x {pipe} pipe stages")
    elif ep:
        say(f"2-D mesh: {n_data} data x {ep} expert devices")
    if mesh is not None and args.sample_only:
        say("note: --shard only parallelises training; --sample-only runs on one device")
    vae_ckpt, cache_path, prior_ckpt = (_under(args.out_dir, a) for a in (
        args.vae_ckpt, args.latent_cache, args.prior_ckpt))
    results_dir = os.path.join(args.out_dir, "results")
    for d in (results_dir, os.path.dirname(cache_path)):
        os.makedirs(d or ".", exist_ok=True)

    vae = load_frozen_vae(vae_ckpt, args.z_dim, args.n_types, args.y_cont_dim, device)

    # --- the latent cache ---
    cache_seconds = None
    if not args.rebuild_latents and os.path.exists(cache_path):
        with np.load(cache_path) as obj:
            z0 = torch.from_numpy(obj["z0"]).to(device)
            y_cat = torch.from_numpy(obj["y_cat"].astype(np.int32)).to(device)
            y_cont = torch.from_numpy(obj["y_cont"].astype(np.float32)).to(device)
            z_mean = (torch.from_numpy(obj["z_mean"]).to(device) if "z_mean" in obj
                      else z0.mean(dim=0, keepdim=True))
            z_std = (torch.from_numpy(obj["z_std"]).to(device) if "z_std" in obj
                     else z0.std(dim=0, keepdim=True, correction=0).clamp_min(1e-6))
        say(f"loaded latents: {cache_path}  z0={tuple(z0.shape)}")
    else:
        if args.procedural or not args.data_path:
            cfg = LatticeConfig(img_size=64, n_types=args.n_types, rot_only=True)
            budget = static_point_budget(cfg)
            n_items = args.max_items

            def get_batch(idx):
                return generate_batch(cfg, args.seed, torch.as_tensor(idx, device=device),
                                      budget, device)
        else:
            ds = ResidentDiskDataset(args.data_path, device)
            n_items = min(len(ds), args.max_items)
            get_batch = ds.gather
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(chunk_seed(args.seed, _CACHE_STREAM))
        z0, y_cat, y_cont, z_mean, z_std = build_latent_cache(vae, get_batch, n_items,
                                                              args.z_target, gen)
        if primary:  # every rank builds the same cache; rank 0 writes it
            np.savez(cache_path, **{k: v.cpu().numpy() for k, v in (
                ("z0", z0), ("y_cat", y_cat), ("y_cont", y_cont), ("z_mean", z_mean),
                ("z_std", z_std))})
        cache_seconds = time.perf_counter() - t0
        say(f"saved latents: {cache_path}  z0={tuple(z0.shape)} ({cache_seconds:.1f}s)")
    z0_norm = (z0 - z_mean) / z_std
    n_items = int(z0_norm.shape[0])

    # --- prior, schedule, optimizer ---
    kw = dict(z_dim=args.z_dim, n_types=args.n_types, y_cont_dim=args.y_cont_dim,
              t_emb_dim=args.t_emb_dim, width=args.width, n_blocks=N_BLOCKS,
              y_cat_emb_dim=Y_CAT_EMB_DIM)
    if args.moe_experts > 0:
        say(f"MoE prior: {args.moe_experts} experts/block (aux weight {args.moe_aux_weight})")
        prior = DiffusionPriorMoE(n_experts=args.moe_experts, **kw)
    else:
        prior = DiffusionPriorFiLM(**kw)
    # a checkpoint replaces the drawn weights, and on a mesh every rank takes
    # rank 0's when the state is placed: draw them only where they are used
    loads = (args.sample_only or args.resume) and os.path.exists(prior_ckpt)
    if not loads and (primary or args.sample_only):
        flax_default_init(prior, np.random.default_rng(args.seed))
    prior.to(device)
    sched = DiffusionSchedule.linear(args.T, args.beta_start, args.beta_end, device=device)
    config = {"z_dim": args.z_dim, "n_types": args.n_types, "y_cont_dim": args.y_cont_dim,
              "t_emb_dim": args.t_emb_dim, "width": args.width, "n_blocks": N_BLOCKS,
              "y_cat_emb_dim": Y_CAT_EMB_DIM, "T": args.T, "beta_start": args.beta_start,
              "beta_end": args.beta_end, "n_experts": args.moe_experts}

    if (args.sample_only or args.resume) and os.path.exists(prior_ckpt):
        raw = (load_torch_prior_checkpoint(prior_ckpt) if prior_ckpt.endswith(".pt")
               else load_checkpoint(prior_ckpt))
        try:
            prior.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
                                   torch_state_dict_from_flax_prior(raw["params"]).items()})
        except RuntimeError as e:
            raise SystemExit(f"{prior_ckpt} does not match the flags' prior: {e}") from e
        say(f"loaded diffusion prior: {prior_ckpt}")

    sample_seconds: list[float] = []
    figure, samples = None, None

    def grid_latents(yg_cat, yg_cont, gen) -> torch.Tensor:
        """DDIM of the grid's conditions: through the pipeline where 36 divides
        by --shard x --pipe-micro (each data rank its rows, gathered over
        "data"), else on every rank from the gathered weights (JAX's rule);
        otherwise through `sampler`."""
        if not pipe:
            return ddim_sample(sampler, sched, yg_cat, yg_cont, args.ddim_steps, args.z_dim,
                               generator=gen)
        z = randn((N_GRID, args.z_dim), gen, device)  # what ddim_sample draws from `gen`
        if N_GRID % (n_data * args.pipe_micro) == 0:
            rows = data_sharding(mesh, N_GRID)
            z_norm = ddim_sample(sampler, sched, yg_cat[rows], yg_cont[rows], args.ddim_steps,
                                 args.z_dim, z=z[rows])
            if axis_size(mesh, AXIS) == 1:
                return z_norm
            parts = [torch.empty_like(z_norm) for _ in range(axis_size(mesh, AXIS))]
            torch.distributed.all_gather(parts, z_norm, group=axis_group(mesh, AXIS))
            return torch.cat(parts)
        whole = DiffusionPriorFiLM(**kw)
        whole.load_state_dict({k: v.detach() for k, v in full_tensors(
            dict(sampler.named_parameters())).items()})
        return ddim_sample(whole.to(device), sched, yg_cat, yg_cont, args.ddim_steps,
                           args.z_dim, z=z)

    def save_samples() -> None:
        """The DDIM grid, on every rank (under FSDP2 each forward gathers
        the weights, on a pipe mesh every stage takes part), written by
        rank 0."""
        nonlocal figure, samples
        yg_cat, yg_cont = sample_grid_conditions(N_GRID, args.n_types, args.y_cont_dim,
                                                 device=device)
        _sync(device)
        t0 = time.perf_counter()
        z_norm = grid_latents(yg_cat, yg_cont,
                              torch.Generator(device=device).manual_seed(args.seed + 1))
        _sync(device)
        sample_seconds.append(time.perf_counter() - t0)
        with torch.no_grad():
            samples = vae.decode(z_norm * z_std + z_mean, yg_cat, yg_cont).cpu().numpy()
        figure = os.path.join(results_dir, "diffusion_samples.png")
        if primary:
            save_image_grid(samples, figure)

    def run(state) -> PriorTrainRun:
        return PriorTrainRun(state, prior, config, z_mean, z_std, loss_hist, bucket_hist,
                             epoch_seconds, z_per_second, cache_seconds, sample_seconds, figure,
                             samples)

    loss_hist: list[float] = []
    bucket_hist: list[list[float]] = []
    epoch_seconds: list[float] = []
    z_per_second: list[float] = []
    sampler = prior
    if args.sample_only:
        if pipe:  # JAX samples through the pipeline here too
            from toycrystals_torch.parallel.pipeline import make_stage

            sampler = prior = make_stage(mesh, prior, args.pipe_micro)
        save_samples()
        say(f"sample-only: saved {figure}")
        return run(None)

    tx = Optimizer(args.lr, clip_grad_norm=args.clip_grad_norm)
    module, state = place_state(mesh, prior, create_train_state(prior, tx), fsdp=args.fsdp,
                                what="--width", n_micro=args.pipe_micro)
    if pipe or ep:
        # the stage (the other stages' blocks and their moments are not held
        # here), or the experts' placement: each forward gathers what it needs
        sampler = prior = module
    elif mesh is not None and (args.fsdp or args.shard_model > 1):
        # the placed model: FSDP2 gathers its weights in forward, the model
        # axis's ops gather its blocks in the mesh's dispatch scope
        placed = getattr(module, "module", module)  # inside DDP

        def sampler(*a):
            with dispatch_scope(mesh):
                return placed(*a)
    aux_weight = args.moe_aux_weight if args.moe_experts else 0.0
    if args.fused_epoch:
        epoch_fn = make_prior_train_epoch(module, tx, args.T, args.batch_size,
                                          (z0_norm, y_cat, y_cont), mesh=mesh,
                                          aux_weight=aux_weight)
    else:
        step = make_prior_train_step(module, tx, args.T, aux_weight=aux_weight, mesh=mesh)
        mine = data_sharding(mesh, args.batch_size)
    steps_per_epoch = n_items // args.batch_size
    if steps_per_epoch == 0:
        raise SystemExit(f"{n_items} latents make no batch of {args.batch_size}")

    say("starting diffusion training loop.")
    ckptr = AsyncCheckpointer()
    save_ckpt = ckptr.save if args.async_ckpt else save_checkpoint
    with GracefulShutdown() as stop, ckptr:
        for epoch in range(args.epochs):
            t0 = time.perf_counter()
            # one generator per epoch, seeded by (seed, epoch): the shuffle and every step's draws
            gen = torch.Generator(device=device).manual_seed(chunk_seed(args.seed, epoch))
            if args.fused_epoch:
                state, em = epoch_fn(state, sched, gen)
            else:
                ms = []
                for bidx in batch_iterator(n_items, args.batch_size,
                                           rng=np.random.default_rng([args.seed, epoch])):
                    idx = torch.as_tensor(bidx[mine], device=device)
                    state, m = step(state, sched, z0_norm[idx], y_cat[idx], y_cont[idx], gen)
                    ms.append(m)
                em = {"loss": torch.stack([m["loss"] for m in ms]).mean(),
                      "bucket_sum": torch.stack([m["bucket_sum"] for m in ms]).sum(0),
                      "bucket_n": torch.stack([m["bucket_n"] for m in ms]).sum(0)}
            avg = float(em["loss"])  # one host sync per epoch
            bucket_avg = (em["bucket_sum"] / em["bucket_n"].clamp_min(1.0)).tolist()
            dt = time.perf_counter() - t0
            if not math.isfinite(avg):
                # halt before the save, so the last checkpoint with a finite loss survives
                raise SystemExit(f"epoch {epoch + 1}: non-finite loss ({avg}): training "
                                 f"diverged; last good checkpoint kept at {prior_ckpt}.")
            loss_hist.append(avg)
            bucket_hist.append(bucket_avg)
            epoch_seconds.append(dt)
            z_per_second.append(steps_per_epoch * args.batch_size / dt)
            say(f"epoch {epoch + 1:02d}/{args.epochs} diffusion_loss={avg:.6f} "
                f"({z_per_second[-1]:.0f} z/s)")

            # one read per epoch: a signal between two reads must not claim a save
            preempted = any_rank(mesh, stop.requested, device)
            if preempted or (args.ckpt_every > 0 and (epoch + 1) % args.ckpt_every == 0) \
                    or epoch == args.epochs - 1:
                whole = full_tensors(state.params)  # every shard, block and stage's blocks
                if primary:
                    save_ckpt(prior_ckpt, {"params": flax_prior_from_torch_state_dict(whole),
                                           "config": config})
            if preempted:
                say(f"preempted ({stop.signame}) after epoch {epoch + 1}: checkpoint saved at "
                      f"{prior_ckpt}; continue with --resume")
                break
            if args.sample_every > 0 and ((epoch + 1) % args.sample_every == 0
                                          or epoch == args.epochs - 1):
                save_samples()
            say("  bucket loss (low t -> high t):", [f"{v:.3f}" for v in bucket_avg])
    say(f"saved: {figure or 'no grid'}, {prior_ckpt}")
    return run(state)


def _refuse(args) -> tuple[int, int]:
    """JAX's refusals of the ways to split the prior, in its order and words
    (scripts/train_diffusion_prior.py); returns (pipe stages, expert ranks),
    0 where the axis is off."""
    pipe = args.shard_pipe if args.shard_pipe > 1 else 0
    ep = args.shard_expert if args.shard_expert > 1 else 0
    if ep and pipe:
        raise SystemExit("--shard-expert and --shard-pipe are mutually exclusive (pick one way "
                         "to split the blocks)")
    if ep and args.shard_model > 1:
        raise SystemExit("--shard-expert and --shard-model are mutually exclusive (pick one way "
                         "to split the weights)")
    if ep and (args.moe_experts <= 0 or args.moe_experts % ep):
        raise SystemExit(f"--shard-expert {ep} requires --moe-experts divisible by it (got "
                         f"{args.moe_experts})")
    if args.moe_experts and pipe:
        raise SystemExit("--moe-experts does not support --shard-pipe (the pipelined forward is "
                         "the dense FiLM prior)")
    n_data = max(1, args.shard)
    if pipe:
        if args.shard_model > 1:
            raise SystemExit("--shard-pipe and --shard-model are mutually exclusive (pick one way "
                             "to split the weights)")
        if N_BLOCKS % pipe:
            raise SystemExit(f"--shard-pipe {pipe} must divide the prior's {N_BLOCKS} blocks")
        if args.batch_size % (n_data * args.pipe_micro):
            raise SystemExit(f"batch size {args.batch_size} must divide by --shard {n_data} x "
                             f"--pipe-micro {args.pipe_micro}")
    elif ep and args.batch_size % n_data:
        raise SystemExit(f"batch size {args.batch_size} not divisible by --shard {args.shard}")
    return pipe, ep


def main(argv: list[str] | None = None) -> int:
    """The CLI: `train(argv)` in this process, or in --shard N (x --shard-model,
    --shard-pipe or --shard-expert) spawned ranks; JAX's refusals come first,
    before any rank starts."""
    args = build_parser().parse_args(argv)
    _refuse(args)
    if not spawn_shards(args, train, argv, (args.batch_size,)):
        train(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
