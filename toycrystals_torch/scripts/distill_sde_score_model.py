#!/usr/bin/env python3
"""Progressively distill a trained score model into a few-step sampler, on the GPU.

    python -m toycrystals_torch.scripts.distill_sde_score_model --teacher <ckpt> \\
        --from-steps 64 --to-steps 4 [flags]

Counterpart of scripts/distill_sde_score_model.py, with its flags, phase
schedule and run dir: each phase halves the DDIM step count (from
--from-steps down to --to-steps, powers of 2) with the guidance --cfg baked
into the student (train/distill.py). After each phase the run dir gets
checkpoints/distilled_{n}step.msgpack (the JAX trainer's layout; config
keys param v, distilled, distill_cfg, distill_t_end, distill_teacher,
distill_steps), metrics.jsonl ({"phase", "steps", "epoch", "loss"} per
epoch), results/ddim_{n}step.png (a DDIM grid of the student) and a line
of distill_summary.jsonl scored by utils/fidelity.py. The next phase's
teacher is that student. A preemption signal saves the partial student of
the phase and exits. Students serve through `ScoreModelService`'s DDIM path.

Differences from the JAX CLI: --device defaults to cuda and never falls back
to the CPU; the grids are 8-bit PNGs of the pixels (utils/figures.py).
--shard is not ported yet and exits naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from datetime import datetime
from typing import Any

import torch

from toycrystals_torch.data.lattice import LatticeConfig
from toycrystals_torch.models.sde_score_model import (
    VPSDE,
    CondUNetTiny,
    sample_ddim,
    sample_grid_conditions,
)
from toycrystals_torch.scripts._common import (
    PARALLEL,
    ResidentDiskDataset,
    add_device_flag,
    select_device,
)
from toycrystals_torch.train.distill import make_distill_train_epoch
from toycrystals_torch.train.state import Optimizer, create_train_state
from toycrystals_torch.utils.checkpoint import AsyncCheckpointer, load_score_payload
from toycrystals_torch.utils.fidelity import score_lattice_fidelity
from toycrystals_torch.utils.figures import save_image_grid
from toycrystals_torch.utils.metrics import append_jsonl
from toycrystals_torch.utils.params import load_flax_params, train_state_to_checkpoint
from toycrystals_torch.utils.preempt import GracefulShutdown


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_flag(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--teacher", type=str, required=True,
                   help="Teacher checkpoint: .msgpack of either package's trainer, or a "
                        "reference .pt.")
    p.add_argument("--use-ema", type=int, default=1, choices=[0, 1],
                   help="Distill from the teacher's EMA weights when present.")
    p.add_argument("--out-dir", type=str, default=None,
                   help="Run dir (default: runs/distill/<timestamp>_...)")
    p.add_argument("--procedural", action="store_true",
                   help="render rot-only batches on the device (the default when there is no "
                        "--data-path; wins over --data-path when both are given)")
    p.add_argument("--data-path", type=str, default=None,
                   help="npz archive instead of --procedural")
    p.add_argument("--n-samples", type=int, default=50_000,
                   help="items per epoch when procedural")
    p.add_argument("--from-steps", type=int, default=64,
                   help="Step count of the first student phase; the teacher runs at twice "
                        "this on the nested grid.")
    p.add_argument("--to-steps", type=int, default=1,
                   help="Final student step count; phases halve from --from-steps down to "
                        "this (both powers of 2).")
    p.add_argument("--epochs", type=int, default=8, help="Epochs per phase.")
    p.add_argument("--phase0-epochs", type=int, default=None,
                   help="Epochs of the FIRST phase only (default: --epochs). An eps teacher's "
                        "phase 0 must also learn the eps -> v conversion and converges far "
                        "slower; prefer a --param v teacher.")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--clip-grad-norm", type=float, default=0.0,
                   help="Clip gradients to this global L2 norm before Adam (0 = off).")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="Student EMA (0 disables; Salimans & Ho distill without EMA).")
    p.add_argument("--cfg", type=float, default=1.5,
                   help="Guidance weight BAKED INTO the student: every teacher evaluation is "
                        "CFG-combined at this scale, so sample the student with --cfg 0.")
    p.add_argument("--t-end", type=float, default=0.005,
                   help="Integration endpoint baked into the student's grid.")
    p.add_argument("--dtype", type=str, default=None, choices=["float32", "bfloat16"],
                   help="Computation dtype; default: the teacher's.")
    p.add_argument("--attn-impl", type=str, default="auto", choices=["auto", "xla", "flash"])
    p.add_argument("--shard", type=int, default=0, help=f"not ported yet ({PARALLEL})")
    p.add_argument("--grid-n", type=int, default=36,
                   help="Sample-grid size scored after each phase (0 disables grids and "
                        "fidelity scoring).")
    p.add_argument("--theta-max", type=float, default=math.pi / 3.0)
    return p


@dataclasses.dataclass
class DistillRun:
    """What a run leaves: the run dir, the phases' step counts, each
    finished phase's checkpoint path, per-epoch losses and seconds, and the
    summary lines."""

    out_dir: str
    schedule: list[int]
    checkpoints: list[str]
    losses: list[list[float]]
    epoch_seconds: list[list[float]]
    summary: list[dict[str, Any]]
    preempted: bool = False


def distill(argv: list[str] | None = None) -> DistillRun:
    p = build_parser()
    args = p.parse_args(argv)
    if args.shard:
        raise SystemExit(f"--shard {args.shard} is not ported yet ({PARALLEL})")
    device = select_device(args.device)

    # ---- teacher ----
    payload = load_score_payload(args.teacher)
    tcfg = payload.get("config")
    if not tcfg:
        raise SystemExit("teacher checkpoint has no embedded config")
    state_t = payload["state"]
    teacher_params = state_t["params"]
    if args.use_ema and state_t.get("ema_params") is not None:
        teacher_params = state_t["ema_params"]
    teacher_pred = str(tcfg.get("param", "eps"))
    if teacher_pred == "fm":
        raise SystemExit("progressive distillation consumes a VP eps/v teacher (DDIM nested-grid "
                         "steps); this teacher was trained with --param fm: rectified-flow "
                         "checkpoints already sample at few Euler steps (--sampler rf)")
    dtype_name = args.dtype or str(tcfg.get("dtype", "float32"))
    img_size = int(tcfg.get("img_size", 64))
    n_types = int(tcfg["n_types"])

    def build_model() -> CondUNetTiny:
        return CondUNetTiny(
            n_types=n_types, y_cont_dim=int(tcfg["y_cont_dim"]), base_ch=int(tcfg["base_ch"]),
            emb_dim=int(tcfg["emb_dim"]), cond_ch=int(tcfg.get("cond_ch", 8)),
            time_ch=int(tcfg.get("time_ch", 8)),
            dtype=torch.bfloat16 if dtype_name == "bfloat16" else torch.float32,
            attn_impl=args.attn_impl, stem=str(tcfg.get("stem", "none")))

    teacher = build_model()
    load_flax_params(teacher, teacher_params)
    teacher = teacher.to(device).eval().requires_grad_(False)
    student = build_model().to(device)
    sde = VPSDE(beta_min=float(tcfg.get("beta_min", 0.1)),
                beta_max=float(tcfg.get("beta_max", 30.0)),
                logsnr_shift=float(tcfg.get("logsnr_shift", 0.0)))

    # ---- schedule ----
    fs, ts_ = args.from_steps, args.to_steps
    if fs < 1 or ts_ < 1 or (fs & (fs - 1)) or (ts_ & (ts_ - 1)) or ts_ > fs:
        raise SystemExit(f"--from-steps/--to-steps must be powers of 2 with to <= from, got "
                         f"{fs} -> {ts_}")
    schedule = []
    n = fs
    while n >= ts_:
        schedule.append(n)
        n //= 2
    print(f"distilling {teacher_pred}-teacher at cfg {args.cfg}: phases {schedule} "
          f"({args.epochs} epochs each)")
    if teacher_pred == "eps" and args.phase0_epochs is None:
        print("WARNING: eps-parameterized teacher: phase 0 must also LEARN the eps->v "
              "parameterization conversion (loss starts ~1 and falls slowly). Give it "
              "--phase0-epochs >> --epochs, or train the teacher with --param v (recommended; "
              "see --phase0-epochs help).")

    # ---- run dir ----
    if args.out_dir is None:
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        args.out_dir = os.path.join("runs", "distill", f"{stamp}_s{fs}-{ts_}_cfg{args.cfg:g}")
    ckpt_dir = os.path.join(args.out_dir, "checkpoints")
    results_dir = os.path.join(args.out_dir, "results")
    os.makedirs(ckpt_dir, exist_ok=True)
    os.makedirs(results_dir, exist_ok=True)
    metrics_path = os.path.join(args.out_dir, "metrics.jsonl")
    summary_path = os.path.join(args.out_dir, "distill_summary.jsonl")
    print(f"run dir: {args.out_dir}")

    # ---- data ----
    data_kw: dict[str, Any]
    if args.data_path and not args.procedural:
        ds = ResidentDiskDataset(args.data_path, device)
        data_kw = {"resident": ds.arrays}
        n_items = len(ds)
        if img_size != int(ds.x_u8.shape[1]):
            raise SystemExit(f"teacher img_size {img_size} != archive {int(ds.x_u8.shape[1])}")
    else:
        data_kw = {"lattice_cfg": LatticeConfig(img_size=img_size, rot_only=True),
                   "dataset_seed": args.seed}
        n_items = args.n_samples

    grid_n = args.grid_n or 36
    y_cat_g, y_cont_g = sample_grid_conditions(grid_n, n_types, int(tcfg["y_cont_dim"]),
                                               args.theta_max, device=device)
    tx = Optimizer(args.lr, clip_grad_norm=args.clip_grad_norm)
    student_cfg = dict(tcfg)
    student_cfg.update({"param": "v", "dtype": dtype_name, "img_size": img_size,
                        "distilled": True, "distill_cfg": float(args.cfg),
                        "distill_t_end": float(args.t_end),
                        "distill_teacher": os.path.abspath(args.teacher)})
    gen = torch.Generator(device=device).manual_seed(args.seed)
    run = DistillRun(args.out_dir, schedule, [], [], [], [])

    def save(ckptr, path, student_state, n_steps, epoch_next, losses):
        student_cfg["distill_steps"] = n_steps
        ckptr.save(path, {"epoch_next": epoch_next, "loss_hist": losses,
                          "config": dict(student_cfg),
                          "state": train_state_to_checkpoint(student_state, tx)})

    # the phase-end save overlaps the grid and fidelity pass; the context
    # manager joins the writer before any exit
    ckptr = AsyncCheckpointer()
    with GracefulShutdown() as stop, ckptr:
        for phase, n_steps in enumerate(schedule):
            t0 = time.perf_counter()
            n_epochs = (args.phase0_epochs if phase == 0 and args.phase0_epochs is not None
                        else args.epochs)
            # the student starts from the teacher's weights
            student.load_state_dict(teacher.state_dict())
            state = create_train_state(student, tx, ema=args.ema_decay > 0)
            epoch_fn = make_distill_train_epoch(
                student, teacher, tx, sde, n_steps, n_types=n_types, guidance_scale=args.cfg,
                teacher_prediction=teacher_pred, t_end=args.t_end, ema_decay=args.ema_decay,
                batch_size=args.batch_size, n_items=n_items, **data_kw)
            ckpt_path = os.path.join(ckpt_dir, f"distilled_{n_steps}step.msgpack")
            losses: list[float] = []
            seconds: list[float] = []
            run.losses.append(losses)
            run.epoch_seconds.append(seconds)
            for ep in range(n_epochs):
                te = time.perf_counter()
                state, loss_t = epoch_fn(state, gen)
                loss = float(loss_t)
                seconds.append(time.perf_counter() - te)
                losses.append(loss)
                print(f"[phase {phase} | {n_steps}-step] epoch {ep + 1}/{n_epochs} "
                      f"v-mse {loss:.5f}")
                append_jsonl(metrics_path, {"phase": phase, "steps": n_steps, "epoch": ep + 1,
                                            "loss": loss})
                if stop.requested:
                    # a working n_steps student, undertrained; continue with
                    # --teacher <this ckpt> --from-steps n_steps
                    save(ckptr, ckpt_path, state, n_steps, ep + 1, losses)
                    print(f"preempted ({stop.signame}) in phase {phase} after epoch {ep + 1}: "
                          f"partial student saved at {ckpt_path}")
                    run.checkpoints.append(ckpt_path)
                    run.preempted = True
                    return run

            save(ckptr, ckpt_path, state, n_steps, n_epochs, losses)
            run.checkpoints.append(ckpt_path)
            print(f"  saved: {ckpt_path}  ({time.perf_counter() - t0:.0f}s)")
            # this phase's student teaches the next (always v from here on)
            teacher.load_state_dict(state.sample_params)
            teacher_pred = "v"
            # a signal during the last epoch's bookkeeping must not buy a grid
            if stop.requested:
                print(f"preempted ({stop.signame}) after phase {phase}: checkpoint saved at "
                      f"{ckpt_path}; skipping diagnostics and later phases")
                run.preempted = True
                return run
            if args.grid_n:
                with torch.inference_mode():
                    g = torch.Generator(device=device).manual_seed(args.seed + 1)
                    x = sample_ddim(teacher, sde, y_cat_g, y_cont_g,
                                    (grid_n, img_size, img_size, 1), g, n_steps=n_steps,
                                    guidance_scale=0.0, t_end=args.t_end, n_types=n_types,
                                    prediction="v").cpu().numpy()
                side = int(math.ceil(math.sqrt(grid_n)))
                grid_path = os.path.join(results_dir, f"ddim_{n_steps}step.png")
                save_image_grid(x, grid_path, nrows=side, ncols=side)
                score = score_lattice_fidelity(x, y_cat_g.cpu().numpy(),
                                               y_cont_g[:, 1].cpu().numpy(), n_types=n_types,
                                               theta_max=args.theta_max, device=device)
                line = {"steps": n_steps, "final_loss": losses[-1] if losses else None,
                        **{k: score[k] for k in ("type_acc", "type_acc_merged01",
                                                 "theta_mae_deg", "cond_fidelity")}}
                append_jsonl(summary_path, line)
                run.summary.append(line)
                print(f"  grid: {grid_path}\n  fidelity: {json.dumps(line)}")
            if stop.requested:  # a signal during the diagnostics
                print(f"preempted ({stop.signame}) after phase {phase} diagnostics: "
                      f"checkpoint saved at {ckpt_path}; skipping later phases")
                run.preempted = True
                return run

    print(f"done: {len(schedule)} phases -> {ckpt_dir}")
    return run


def main(argv: list[str] | None = None) -> int:
    distill(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
