#!/usr/bin/env python3
"""Train the VP-SDE score model (conditional tiny U-Net) on the GPU.

    python -m toycrystals_torch.scripts.train_sde_score_model --procedural [flags]

Counterpart of scripts/train_sde_score_model.py, with its flags, defaults and
layout: a run dir (timestamped under runs/sde_score/ unless --out-dir) holding
checkpoints/sde_score_model_last.msgpack (and _best with --save-best),
metrics.jsonl ({"epoch", "loss"} per epoch) and results/ (sample grids). The
checkpoint is the JAX package's: {epoch_next, state (params, optax-layout
opt_state, ema_params), loss_hist, config}, so either package's CLIs read
the other's. --resume continues from the last checkpoint and restores the
config's schedule, dtype, img_size, param, stem and clipping unless flags
override them.

Differences from the JAX CLI: --device defaults to cuda and never falls back
to the CPU; the sample grids are 8-bit PNGs of the pixels themselves
(utils/figures.py) and there is no loss-curve figure; each epoch draws from a
generator seeded by (--seed, epoch), so a resumed run continues the draws of
an uninterrupted one; --stream draws the shuffle and the steps' noise as the
resident per-batch path (--fused-epoch 0) does, so both see the same batches
and draws; --profile-dir writes a torch.profiler Chrome trace (CPU and CUDA
activity) of the second epoch, where JAX writes an XPlane trace.

--shard N trains on N devices with the batch split by rows (N ranks, one
process per device, parallel/; spawned here unless the cluster flags
--coordinator/--num-processes/--process-id join ranks started elsewhere),
--fsdp shards the weights, moments and EMA over them (FSDP2), and
--ckpt-format orbax writes sharded torch.distributed.checkpoint directories
(utils/orbax_io.py; JAX's orbax directories are not readable here). The
numbers are the single-device run's up to the order of reductions. Only
rank 0 writes the msgpack checkpoint, metrics.jsonl and the grids.
--shard-space S also splits every image's height over S ranks (a --shard x S
("data", "space") mesh, parallel/spatial.py): each rank renders or gathers
its rows of the batch and keeps its rows of the image height, the ops of the
U-Net exchange rows with their neighbours forward and backward, DDP averages
the gradients over all the ranks, and the epoch-end grids sample on the same
mesh. H/4 must divide by S (and H/8 for the s2d stems). With --fsdp the
weights, moments and EMA are sharded over --shard and replicated over S
(HSDP, parallel/fsdp.py). --shard-model M splits every weight's output
channels over M ranks instead (a --shard x M ("data", "model") mesh,
parallel/tensor.py): each rank holds its block of the weights, of Adam's
moments and of the EMA, the ops of the U-Net gather and reduce channels
forward and backward, and DDP averages over --shard; the msgpack checkpoint
is gathered to the flax layout, so it is one process's. With --fsdp FSDP2
shards each rank's blocks over --shard as well (JAX's 2-D weight sharding,
parallel/fsdp.py). --shard-space S with --shard-model M runs both at once on
JAX's 3-D (data, space, model) mesh of --shard x S x M ranks: each rank its
rows of the batch and of the height with its block of the weights, DDP over
the --shard x S ranks of its block (with --fsdp, HSDP on the blocks: sharded
over --shard, replicated over S).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import time
from datetime import datetime
from typing import Any

import numpy as np
import torch

from toycrystals_torch.data.datasets import batch_iterator, generate_batch
from toycrystals_torch.data.lattice import LatticeConfig, static_point_budget
from toycrystals_torch.data.stream import StreamingDiskDataset
from toycrystals_torch.models.flow_matching import sample_rectified_flow
from toycrystals_torch.models.sde_score_model import (
    VPSDE,
    CondUNetTiny,
    auto_chunk,
    chunk_seed,
    eps_apply_from_v,
    sample_chunked,
    sample_grid_conditions,
    sample_probability_flow_ode,
)
from toycrystals_torch.models.torch_init import flax_default_init, torch_like_init
from toycrystals_torch.parallel.fsdp import full
from toycrystals_torch.parallel.tensor import shard_params
from toycrystals_torch.parallel.mesh import data_sharding
from toycrystals_torch.parallel.multihost import is_primary
from toycrystals_torch.parallel.spatial import check_stem_divisibility, space_rows
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
from toycrystals_torch.train.state import (
    Optimizer,
    TrainState,
    create_train_state,
    linear_schedule,
    warmup_cosine_decay_schedule,
)
from toycrystals_torch.train.steps import make_sde_train_epoch, make_sde_train_step
from toycrystals_torch.utils.checkpoint import (
    AsyncCheckpointer,
    float_list,
    load_checkpoint,
    save_checkpoint,
)
from toycrystals_torch.utils.figures import save_image_grid
from toycrystals_torch.utils.metrics import append_jsonl, ensure_file, truncate_jsonl
from toycrystals_torch.utils.orbax_io import ShardedCheckpointManager, load_orbax_meta
from toycrystals_torch.utils.params import (
    load_train_state_from_checkpoint,
    train_state_to_checkpoint,
)
from toycrystals_torch.utils.preempt import GracefulShutdown


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    add_device_flag(p)
    p.add_argument("--data-path", type=str, default="data/toycrystals_train_rotonly.npz")
    p.add_argument("--img-size", type=int, default=None,
                   help="Lattice image size for --procedural data (disk data has its own). "
                        "Default: 64, or the checkpoint's img_size on --resume.")
    p.add_argument("--procedural", action="store_true",
                   help="render rot-only batches on the device, no files")
    p.add_argument("--n-samples", type=int, default=50_000,
                   help="items per epoch when --procedural")
    p.add_argument("--out-dir", type=str, default=None,
                   help="Run output directory. If omitted, a timestamped run dir is created "
                        "under runs/sde_score/")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--n-types", type=int, default=4)
    p.add_argument("--y-cont-dim", type=int, default=4)
    p.add_argument("--base-ch", type=int, default=96)
    p.add_argument("--emb-dim", type=int, default=128)
    p.add_argument("--stem", type=str, default=None, choices=["none", "s2d", "s2dr"],
                   help="U-Net stem; checkpoints do not carry across stems. Default: none, "
                        "or the checkpoint's stem on --resume.")
    p.add_argument("--cond-ch", type=int, default=8)
    p.add_argument("--time-ch", type=int, default=8)
    # None so that --resume can restore the trained schedule from the config
    p.add_argument("--beta-min", type=float, default=None,
                   help="Default: 0.1, or the checkpoint's value on --resume.")
    p.add_argument("--beta-max", type=float, default=None,
                   help="Default: 30.0, or the checkpoint's value on --resume.")
    p.add_argument("--logsnr-shift", type=float, default=None,
                   help="Shift of the schedule's log-SNR in nats (2 ln(64/R) at size R, "
                        "-2.77 at 256x256). Default: 0, or the checkpoint's on --resume.")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--p-uncond", type=float, default=0.1)
    p.add_argument("--t-power", type=float, default=1.0,
                   help="Sample t as t=u**t_power. >1 biases towards small t.")
    p.add_argument("--param", type=str, default=None, choices=["eps", "v", "fm"],
                   help="Prediction target: eps, v, or fm (rectified-flow velocity on the "
                        "straight-line path; sample with --sampler rf). Stored in the config. "
                        "Default: eps, or the checkpoint's on --resume.")
    p.add_argument("--fm-shift", type=float, default=None,
                   help="Timestep shift t -> s t / (1 + (s - 1) t) of --param fm, in the "
                        "training draw and the rf sampling grid (4.0 at 256x256). Default: "
                        "1.0, or the checkpoint's on --resume.")
    p.add_argument("--min-snr-gamma", type=float, default=None,
                   help="min-SNR-gamma loss weighting for eps|v (0 = off). Default: 0, or the "
                        "checkpoint's value on --resume.")
    p.add_argument("--clip-grad-norm", type=float, default=None,
                   help="Clip gradients to this global L2 norm before Adam (0 = off). "
                        "Default: 0, or the checkpoint's value on --resume.")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="0 disables EMA. Typical: 0.999 or 0.9999")
    p.add_argument("--sample-every", type=int, default=10000,
                   help="Write a sample grid every N epochs (and on the final epoch). 0 "
                        "disables in-training grids.")
    p.add_argument("--sample-steps", type=int, default=200)
    p.add_argument("--cfg", type=float, default=0)
    p.add_argument("--t-end", type=float, default=1e-3)
    p.add_argument("--sample-from-ema", type=int, default=1, choices=[0, 1],
                   help="If EMA enabled, sample the grids with the EMA weights.")
    p.add_argument("--clip-x0", type=int, default=0, choices=[0, 1],
                   help="Static x0-thresholding in the in-training sample grids.")
    p.add_argument("--dtype", type=str, default=None, choices=["float32", "bfloat16"],
                   help="Computation dtype (parameters stay float32). Default: float32, or "
                        "the checkpoint's dtype on --resume.")
    p.add_argument("--attn-impl", type=str, default="auto", choices=["auto", "xla", "flash"],
                   help="Attention: auto = the flash kernel at >= 2048 tokens.")
    p.add_argument("--lr-schedule", type=str, default="constant",
                   choices=["constant", "cosine"],
                   help="cosine = warmup to --lr, then cosine decay to 1%% over the run, "
                        "stepped per optimizer update (the count is in the checkpoint).")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="Linear LR warmup steps (with either --lr-schedule).")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="Split each batch into N sequential chunks; the update equals the "
                        "full batch's at 1/N of the activations.")
    p.add_argument("--skip-nonfinite", type=int, default=0, metavar="K",
                   help="Skip optimizer/EMA updates whose gradients hold NaN/Inf, up to K in "
                        "a row; skips are reported per epoch. Changes the optimizer-state "
                        "layout: pass the same value when resuming.")
    p.add_argument("--fused-epoch", type=int, default=1, choices=[0, 1],
                   help="1: make_sde_train_epoch (shuffle and batches on the device); 0: one "
                        "step per host batch of indices.")
    p.add_argument("--stream", type=int, nargs="?", const=2, default=0, metavar="DEPTH",
                   help="Keep the archive in host memory instead of on the device: batches "
                        "gathered on the host as u8 and copied to the device DEPTH steps "
                        "ahead on a side CUDA stream (data/stream.py). Needs --data-path; "
                        "implies --fused-epoch 0.")
    p.add_argument("--fresh-data", action="store_true",
                   help="Procedural source only: epoch e trains on items [e*n, (e+1)*n) "
                        "instead of re-shuffling the same n.")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="Write a torch.profiler Chrome trace (CPU and CUDA activity) of one "
                        "post-warmup epoch into this directory.")
    p.add_argument("--init", type=str, default="flax", choices=["flax", "torch"],
                   help="Parameter init: flax defaults, or torch layer defaults.")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="Save the checkpoint every N epochs (always at the end; 0 = end only).")
    p.add_argument("--ckpt-format", default="msgpack", choices=["msgpack", "orbax"],
                   help="msgpack: one self-describing file, gathered whole on rank 0 (the "
                        "JAX package's format). orbax: a step directory per save, each "
                        "rank writing its own shards (torch.distributed.checkpoint, "
                        "utils/orbax_io.py; not the JAX package's orbax), restored into "
                        "the resuming run's layout.")
    p.add_argument("--async-ckpt", type=int, default=1, choices=[0, 1],
                   help="Encode and write checkpoints on a thread while the next epoch "
                        "trains (the copy to the host stays synchronous). 0 = synchronous.")
    add_parallel_flags(p)
    p.add_argument("--save-best", type=int, default=0, choices=[0, 1],
                   help="Also write sde_score_model_best.msgpack whenever the epoch loss "
                        "improves.")
    return p


def _make_run_name(args) -> str:
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    return (f"{ts}_lr{args.lr:.2e}_ch{args.base_ch}"
            f"_b{args.beta_max:g}_tp{args.t_power:g}_pu{args.p_uncond:g}")


@dataclasses.dataclass
class TrainRun:
    """What a run leaves in memory: the state as last saved, its pieces, and
    the per-epoch losses and seconds of this process. On a mesh, `model`
    is the module trained through (DistributedDataParallel or FSDP2)."""

    state: TrainState
    model: torch.nn.Module
    tx: Optimizer
    config: dict[str, Any]
    loss_hist: list[float]
    epoch_seconds: list[float]
    trace_path: str | None = None


def train(argv: list[str] | None = None) -> TrainRun:
    p = build_parser()
    args = p.parse_args(argv)
    multihost = init_distributed(args, args.device)
    device = select_device(args.device)
    primary = is_primary()
    say = print if primary else (lambda *a, **k: None)

    if args.out_dir is None:
        # a fresh run dir holds no checkpoint to resume, so the schedule's
        # flags take their defaults before the run is named
        args.beta_max = 30.0 if args.beta_max is None else args.beta_max
        args.out_dir = os.path.join("runs", "sde_score", _make_run_name(args))
    say(f"run dir: {args.out_dir}")
    results_dir = os.path.join(args.out_dir, "results")
    ckpt_dir = os.path.join(args.out_dir, "checkpoints")
    os.makedirs(results_dir, exist_ok=True)
    os.makedirs(ckpt_dir, exist_ok=True)
    metrics_path = os.path.join(args.out_dir, "metrics.jsonl")
    orbax_fmt = args.ckpt_format == "orbax"
    ckpt_ext = ".orbax" if orbax_fmt else ".msgpack"
    ckpt_path = os.path.join(ckpt_dir, "sde_score_model_last" + ckpt_ext)

    # read the checkpoint before anything is built: on --resume its config
    # decides dtype, img_size, param, stem and the schedule unless flags do
    # (orbax: the JSON sidecar only; the tensors load into the placed state)
    resume_raw = None
    if args.resume and os.path.exists(ckpt_path):
        resume_raw = load_orbax_meta(ckpt_path) if orbax_fmt else load_checkpoint(ckpt_path)
    rcfg = (resume_raw or {}).get("config", {})
    dtype_name = args.dtype or str(rcfg.get("dtype") or "float32")
    if args.img_size is None:
        args.img_size = int(rcfg.get("img_size") or 64)
    if args.param is None:
        args.param = str(rcfg.get("param") or "eps")
    if args.stem is None:
        args.stem = str(rcfg.get("stem") or "none")
    if args.beta_min is None:
        args.beta_min = float(rcfg.get("beta_min", 0.1))
    if args.beta_max is None:
        args.beta_max = float(rcfg.get("beta_max", 30.0))
    if args.logsnr_shift is None:
        args.logsnr_shift = float(rcfg.get("logsnr_shift", 0.0))
    if args.fm_shift is None:
        args.fm_shift = float(rcfg.get("fm_shift", 1.0))
    if args.fm_shift != 1.0 and args.param != "fm":
        raise SystemExit("--fm-shift shifts the rectified-flow timestep draw (--param fm); VP "
                         "runs shift via --logsnr-shift")
    if args.min_snr_gamma is None:
        args.min_snr_gamma = float(rcfg.get("min_snr_gamma", 0.0))
    if args.min_snr_gamma > 0.0 and args.param == "fm":
        raise SystemExit("--min-snr-gamma weights the VP objectives (--param eps|v); rectified "
                         "flow weights timesteps via --fm-shift instead")
    # clipping changes the opt_state layout, so it follows the checkpoint
    if args.clip_grad_norm is None:
        args.clip_grad_norm = float(rcfg.get("clip_grad_norm", 0.0))
    mesh = setup_mesh(args.shard, args.batch_size, device=device,
                      shard_space=args.shard_space, shard_model=args.shard_model,
                      img_size=args.img_size)
    if multihost and (args.fsdp or args.shard_model > 1) and not orbax_fmt:
        # msgpack saves gather the whole state to rank 0; the JAX trainer
        # refuses this across hosts, and so does the port
        raise SystemExit("multi-host --fsdp/--shard-model needs --ckpt-format orbax (per-shard "
                         "writes; msgpack would gather every shard to one host)")
    if args.grad_accum < 1:
        raise SystemExit(f"--grad-accum must be >= 1, got {args.grad_accum}")
    if args.batch_size % args.grad_accum:
        raise SystemExit(f"batch size {args.batch_size} not divisible by --grad-accum "
                         f"{args.grad_accum}")
    if args.ema_decay != 0.0 and not 0.0 < args.ema_decay < 1.0:
        raise SystemExit("--ema-decay must be in (0,1) or 0 to disable.")

    # --- data ---
    img_size = args.img_size
    procedural = args.procedural or not args.data_path
    if args.stream:
        if procedural:
            raise SystemExit("--stream needs --data-path (the procedural dataset already renders "
                             "on the device)")
        if args.fused_epoch:
            say("--stream: per-batch path (the fused epoch needs the archive on the device)")
            args.fused_epoch = 0
    if args.fresh_data and not procedural:
        raise SystemExit("--fresh-data needs the procedural source (a disk archive has only "
                         "its n items)")
    if args.fresh_data and args.epochs * args.n_samples >= 2**31:
        raise SystemExit(f"--fresh-data: epochs x n-samples = {args.epochs * args.n_samples:,} "
                         f"overflows the int32 item-index space (2^31); lower --epochs or "
                         f"--n-samples")
    if procedural:
        lattice_cfg = LatticeConfig(img_size=img_size, n_types=args.n_types, rot_only=True)
        n_items = args.n_samples
        budget = static_point_budget(lattice_cfg)

        def get_batch(idx):
            return generate_batch(lattice_cfg, args.seed, idx, budget, device)
    elif args.stream:
        sds = StreamingDiskDataset(args.data_path, device)
        n_items, img_size = len(sds), int(sds.x_u8.shape[1])
    else:
        ds = ResidentDiskDataset(args.data_path, device)
        n_items, img_size = len(ds), int(ds.x_u8.shape[1])
        get_batch = ds.gather
    steps_per_epoch = n_items // args.batch_size
    if steps_per_epoch == 0:
        raise SystemExit(f"{n_items} items make no batch of {args.batch_size}")
    if args.shard_space > 1:
        try:
            check_stem_divisibility(img_size, args.shard_space, args.stem)
        except ValueError as e:
            raise SystemExit(str(e)) from None

    # --- model, SDE, optimizer, state ---
    model = CondUNetTiny(
        n_types=args.n_types, y_cont_dim=args.y_cont_dim, base_ch=args.base_ch,
        emb_dim=args.emb_dim, cond_ch=args.cond_ch, time_ch=args.time_ch,
        dtype=torch.bfloat16 if dtype_name == "bfloat16" else torch.float32,
        attn_impl=args.attn_impl, stem=args.stem)
    if args.init == "torch":
        torch_like_init(model, torch.Generator().manual_seed(args.seed))
    else:
        flax_default_init(model, np.random.default_rng(args.seed))
    model.to(device)
    sde = VPSDE(beta_min=args.beta_min, beta_max=args.beta_max, logsnr_shift=args.logsnr_shift)
    if args.lr_schedule == "cosine":
        total_steps = max(args.epochs * steps_per_epoch, 1)
        lr = warmup_cosine_decay_schedule(0.0, args.lr, min(args.warmup_steps, total_steps),
                                          total_steps, args.lr * 0.01)
        say(f"lr schedule: cosine (peak {args.lr:g}, {args.warmup_steps} warmup of "
              f"{total_steps} steps)")
    else:
        lr = args.lr
        if args.warmup_steps:
            lr = linear_schedule(0.0, args.lr, args.warmup_steps)
            say(f"lr schedule: constant {args.lr:g} after {args.warmup_steps} warmup steps")
    if args.clip_grad_norm > 0.0:
        say(f"gradient clipping: global norm <= {args.clip_grad_norm:g}")
    if args.skip_nonfinite > 0:
        say(f"non-finite-gradient guard: skipping up to {args.skip_nonfinite} consecutive "
              f"bad steps")
    tx = Optimizer(lr, clip_grad_norm=args.clip_grad_norm, skip_nonfinite=args.skip_nonfinite)
    state = create_train_state(model, tx, ema=args.ema_decay > 0.0)

    # the self-describing config embedded in the checkpoint (the JAX CLI's keys)
    config = {
        "img_ch": 1, "img_size": img_size,
        "n_types": args.n_types, "y_cont_dim": args.y_cont_dim,
        "base_ch": args.base_ch, "emb_dim": args.emb_dim, "cond_ch": args.cond_ch,
        "time_ch": args.time_ch, "beta_min": args.beta_min, "beta_max": args.beta_max,
        "logsnr_shift": args.logsnr_shift,
        "t_power": args.t_power, "p_uncond": args.p_uncond, "dtype": dtype_name,
        "param": args.param, "fm_shift": args.fm_shift, "stem": args.stem,
        "min_snr_gamma": args.min_snr_gamma,
        "clip_grad_norm": args.clip_grad_norm,
        "fresh_data": bool(args.fresh_data),
    }

    start_epoch = 0
    loss_hist: list[float] = []
    if resume_raw is not None:
        if not orbax_fmt:
            try:
                load_train_state_from_checkpoint(state, tx, resume_raw["state"])
            except ValueError as e:
                raise SystemExit(f"--resume from {ckpt_path}: {e}") from e
        start_epoch = int(resume_raw["epoch_next"])
        loss_hist = float_list(resume_raw.get("loss_hist", []))
        # with --ckpt-every N > 1 metrics.jsonl can run ahead of the restored
        # epoch; drop those rows so the epochs trained again do not repeat them
        if primary:
            truncate_jsonl(metrics_path, "epoch", start_epoch)
        if start_epoch > 0:
            say(f"resumed from: {ckpt_path} (next epoch {start_epoch + 1})")

    # the mesh's placement (DistributedDataParallel, or FSDP2 under --fsdp),
    # then an orbax checkpoint straight into the placed layout
    module, state = place_state(mesh, model, state, fsdp=args.fsdp)
    ckpt_mgr = best_mgr = None
    if orbax_fmt:
        ckpt_mgr = ShardedCheckpointManager(ckpt_path, max_to_keep=2)
        if args.save_best:
            best_mgr = ShardedCheckpointManager(
                os.path.join(ckpt_dir, "sde_score_model_best.orbax"), max_to_keep=1)
        if resume_raw is not None:
            try:
                state, _ = ckpt_mgr.restore_onto(state)
            except (KeyError, RuntimeError, ValueError) as e:
                raise SystemExit(f"--resume from {ckpt_path}: {e}") from e
    train_kw = dict(parameterization=args.param, grad_accum=args.grad_accum,
                    t_shift=args.fm_shift, min_snr_gamma=args.min_snr_gamma, mesh=mesh)
    if args.fused_epoch:
        epoch_fn = make_sde_train_epoch(
            module, tx, sde, args.n_types, args.p_uncond, args.t_power, args.ema_decay,
            args.batch_size, n_items, lattice_cfg=lattice_cfg if procedural else None,
            dataset_seed=args.seed, resident=None if procedural else ds.arrays,
            nan_safe_metrics=args.skip_nonfinite > 0, fresh_data=args.fresh_data, **train_kw)
    else:
        step = make_sde_train_step(module, tx, sde, args.n_types, args.p_uncond, args.t_power,
                                   args.ema_decay, **train_kw)

    def save_samples(out_path: str) -> None:
        """A 36-image grid with the ODE sampler (rf on the --fm-shift grid for
        --param fm), as the JAX trainer's in-training grids, from a copy of
        the model holding the EMA (or the live) weights. On a mesh every rank
        samples its rows and rank 0 writes the grid."""
        prm = state.sample_params if args.sample_from_ema == 1 else state.params
        grid_model = CondUNetTiny(
            n_types=args.n_types, y_cont_dim=args.y_cont_dim, base_ch=args.base_ch,
            emb_dim=args.emb_dim, cond_ch=args.cond_ch, time_ch=args.time_ch,
            dtype=model.dtype, attn_impl=args.attn_impl, stem=args.stem)
        grid_model.load_state_dict({k: full(v).detach() for k, v in prm.items()}, strict=True)
        grid_model = grid_model.to(device).eval().requires_grad_(False)
        if args.shard_model > 1:
            shard_params(grid_model, mesh)
        apply_fn = eps_apply_from_v(sde, grid_model) if args.param == "v" else grid_model
        grid_sampler, grid_name, grid_kw = sample_probability_flow_ode, "ode", {}
        if args.param == "fm":
            grid_sampler, grid_name = sample_rectified_flow, "rf"
            grid_kw = {"t_shift": args.fm_shift}
        y_cat, y_cont = sample_grid_conditions(36, args.n_types, args.y_cont_dim, device=device)
        with torch.inference_mode():
            x = sample_chunked(
                grid_sampler, apply_fn, sde, y_cat, y_cont, (36, img_size, img_size, 1),
                args.seed + 1, chunk=auto_chunk(img_size, args.sample_steps, grid_name),
                mesh=mesh, n_steps=args.sample_steps, guidance_scale=args.cfg,
                t_end=args.t_end, n_types=args.n_types, clip_x0=bool(args.clip_x0), **grid_kw)
        if primary:
            save_image_grid(x, out_path)

    def epoch_batches(epoch: int, offset: int):
        """The per-batch path's batches on the device: the host shuffle of
        (seed, epoch), streamed or gathered from the resident source; on a
        mesh, this rank's rows of each, and of the image height."""
        mine = data_sharding(mesh, args.batch_size)
        idx_it = (bidx[mine] + offset for bidx in batch_iterator(
            n_items, args.batch_size, rng=np.random.default_rng([args.seed, epoch])))
        if args.stream:
            batches = sds.device_batches(idx_it, args.stream)
        else:
            batches = (get_batch(torch.as_tensor(bidx, device=device)) for bidx in idx_it)
        if args.shard_space <= 1:
            return batches
        return ((x0[:, space_rows(mesh, x0.shape[1])], y_cat, y_cont)
                for x0, y_cat, y_cont in batches)

    # the second epoch of this process (the first carries the warm-up)
    profile_epoch = start_epoch + 1 if args.epochs - start_epoch > 1 else start_epoch
    trace_path = None
    say("starting SDE score-model training loop.")
    if primary:
        ensure_file(metrics_path)
    sample_grid_ok = False
    epoch_seconds: list[float] = []
    ckptr = AsyncCheckpointer()
    save_ckpt = ckptr.save if args.async_ckpt else save_checkpoint

    def write_ckpt(which: str, epoch: int) -> None:
        """One checkpoint write ('last' or 'best'), either format: orbax on
        every rank (each its shards); msgpack gathered whole (a collective
        under --fsdp and --shard-model) and written by rank 0."""
        meta = {"epoch_next": epoch + 1, "loss_hist": loss_hist, "config": config}
        if orbax_fmt:
            (ckpt_mgr if which == "last" else best_mgr).save(epoch + 1, state, tx, meta)
            return
        if primary or (args.fsdp or args.shard_model > 1) and mesh is not None:
            tree = train_state_to_checkpoint(state, tx)
        if primary:
            save_ckpt(ckpt_path if which == "last" else
                      os.path.join(ckpt_dir, "sde_score_model_best.msgpack"),
                      {**meta, "state": tree})

    with GracefulShutdown() as stop, ckptr, contextlib.ExitStack() as mgrs:
        for m in (ckpt_mgr, best_mgr):
            if m is not None:
                mgrs.enter_context(m)
        for epoch in range(start_epoch, args.epochs):
            t0 = time.perf_counter()
            # one generator per epoch, seeded by (seed, epoch): the shuffle
            # and every step's draws; a resumed run repeats them
            gen = torch.Generator(device=device).manual_seed(chunk_seed(args.seed, epoch))
            offset = epoch * n_items if args.fresh_data else 0
            profiling = primary and args.profile_dir is not None and epoch == profile_epoch
            with (_profiler(device) if profiling else contextlib.nullcontext()) as prof:
                if args.fused_epoch:
                    state, avg_t = epoch_fn(state, gen, offset)
                    avg = float(avg_t)
                else:
                    losses = []
                    for x0, y_cat, y_cont in epoch_batches(epoch, offset):
                        state, loss = step(state, x0, y_cat, y_cont, gen)
                        losses.append(loss)
                    stacked = torch.stack(losses)
                    avg = float(stacked.nanmean() if args.skip_nonfinite > 0 else stacked.mean())
            dt = time.perf_counter() - t0
            if prof is not None:
                os.makedirs(args.profile_dir, exist_ok=True)
                trace_path = os.path.join(args.profile_dir, f"epoch_{epoch + 1:03d}.trace.json")
                prof.export_chrome_trace(trace_path)
                say(f"  profile: {trace_path}")
            if not math.isfinite(avg):
                # halt before the save, so the last checkpoint with a finite
                # loss survives
                raise SystemExit(
                    f"epoch {epoch + 1}: non-finite loss ({avg}): training diverged. Last good "
                    f"checkpoint kept at {ckpt_path} (epoch {epoch}); resume with --resume "
                    f"after lowering --lr.")
            loss_hist.append(avg)
            epoch_seconds.append(dt)
            skipped = ""
            if args.skip_nonfinite > 0 and state.opt_state.total_notfinite:
                skipped = (f" [{state.opt_state.total_notfinite} non-finite steps skipped "
                           f"so far]")
            say(f"epoch {epoch + 1:03d}/{args.epochs}: loss={avg:.6f} "
                f"({steps_per_epoch * args.batch_size / dt:.0f} img/s){skipped}")

            # one read per epoch: a signal between two reads must not claim a
            # save that never happened; on a mesh a signal to any rank stops all
            preempted = any_rank(mesh, stop.requested, device)
            if preempted or (args.ckpt_every > 0 and (epoch + 1) % args.ckpt_every == 0) \
                    or epoch == args.epochs - 1:
                write_ckpt("last", epoch)
            if args.save_best and avg <= min(loss_hist):
                write_ckpt("best", epoch)
            if primary:
                append_jsonl(metrics_path, {"epoch": epoch + 1, "loss": avg})
            if preempted:
                say(f"preempted ({stop.signame}) after epoch {epoch + 1}: checkpoint saved at "
                      f"{ckpt_path}; continue with --resume")
                break

            if args.sample_every > 0 and ((epoch + 1) % args.sample_every == 0
                                          or epoch == args.epochs - 1):
                out_path = os.path.join(results_dir, f"sde_samples_epoch_{epoch + 1:03d}.png")
                # a failed diagnostic grid must not fail a run whose checkpoint
                # and metrics are saved, unless grids never worked in this run
                try:
                    save_samples(out_path)
                    sample_grid_ok = True
                    say(f"  saved: {out_path}")
                except Exception as e:  # noqa: BLE001
                    if not sample_grid_ok:
                        raise
                    say(f"  WARNING: sample grid failed ({type(e).__name__}); training "
                          f"artefacts are saved; rerun via sample_sde_score_model: {e}")
    say(f"checkpoint: {ckpt_path}")
    return TrainRun(state, module, tx, config, loss_hist, epoch_seconds, trace_path)


def _profiler(device: torch.device) -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def main(argv: list[str] | None = None) -> int:
    """The CLI: `train(argv)` in this process, or in --shard N (x
    --shard-space S, or x --shard-model M) spawned ranks."""
    args = build_parser().parse_args(argv)
    if not spawn_shards(args, train, argv, (args.batch_size,)):
        train(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
