"""Shared plumbing of the port's CLIs (counterpart of scripts/_common.py):
device selection, checkpoint-name resolution, a disk archive resident on
the device, and the flags whose paths are not ported yet."""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import torch

from toycrystals_torch.data.datasets import load_archive
from toycrystals_torch.serve import resolve_device

PARALLEL = "ROADMAP.md queue 1, module 5: parallel axes"


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or auto: the GPU, and an error without one; "
                        "cpu: the plain versions of the kernels on the CPU, only when asked.")


def select_device(device: str) -> torch.device:
    """'cuda', 'cuda:N', 'auto' (= 'cuda') or 'cpu'. A CUDA device with no GPU
    raises: nothing falls back to the CPU."""
    return resolve_device("cuda" if device == "auto" else device)


def add_parallel_flags(p: argparse.ArgumentParser, train: bool = True,
                       space: bool = True) -> None:
    """The JAX CLIs' mesh and multi-process flags, kept so that the command
    lines match; any value but the default raises (`refuse_deferred`).
    `space=False` leaves out --shard-space, as the VAE trainer's JAX CLI does."""
    for flag in ("--shard", "--shard-space", "--shard-model"):
        if flag == "--shard-space" and not space:
            continue
        p.add_argument(flag, type=int, default=0, help=f"not ported yet ({PARALLEL})")
    if train:
        p.add_argument("--fsdp", action="store_true", help=f"not ported yet ({PARALLEL})")
    p.add_argument("--coordinator", type=str, default=None, help=f"not ported yet ({PARALLEL})")
    p.add_argument("--num-processes", type=int, default=None,
                   help=f"not ported yet ({PARALLEL})")
    p.add_argument("--process-id", type=int, default=None, help=f"not ported yet ({PARALLEL})")


PARALLEL_DESTS = ("shard", "shard_space", "shard_model", "coordinator", "num_processes",
                  "process_id")


def refuse_deferred(p: argparse.ArgumentParser, args: argparse.Namespace,
                    flags: dict[str, str]) -> None:
    """SystemExit naming the ROADMAP item of the first flag in `flags`
    (dest -> item) that was given a value other than its default."""
    for dest, item in flags.items():
        value = getattr(args, dest)
        if value != p.get_default(dest):
            raise SystemExit(f"--{dest.replace('_', '-')} {value} is not ported yet ({item})")


def infer_score_ckpt_path(out_dir: str, ckpt: str) -> str:
    """Resolve --ckpt: a path (.msgpack, reference .pt, or an orbax
    directory) passes through; 'last' / 'best' resolve under
    <out_dir>/checkpoints, msgpack first, then an orbax run's directory."""
    if ckpt.endswith((".msgpack", ".pt", ".orbax")) or os.path.isdir(ckpt):
        return ckpt
    if ckpt in ("last", "best"):
        base = os.path.join(out_dir, "checkpoints", f"sde_score_model_{ckpt}")
        if not os.path.exists(base + ".msgpack") and os.path.isdir(base + ".orbax"):
            return base + ".orbax"
        return base + ".msgpack"
    raise ValueError("ckpt must be a .msgpack/.orbax/.pt path or one of: last, best")


class ResidentDiskDataset:
    """A dataset archive (`load_archive`: the .npz of scripts/build_dataset.py
    or the reference's torch archive) resident on the device as u8.
    `gather(idx)` returns (x f32 [B, H, W, 1] in [0, 1], y_cat, y_cont) there."""

    def __init__(self, path: str | Path, device: torch.device) -> None:
        x_u8, y_cat, y_cont = load_archive(path)
        self.x_u8, self.y_cat, self.y_cont = (torch.from_numpy(a).to(device)
                                              for a in (x_u8, y_cat, y_cont))
        self.n = int(self.x_u8.shape[0])

    def __len__(self) -> int:
        return self.n

    @property
    def arrays(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.x_u8, self.y_cat, self.y_cont

    def gather(self, idx) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        idx = torch.as_tensor(idx, device=self.x_u8.device)
        return self.x_u8[idx].to(torch.float32) / 255.0, self.y_cat[idx], self.y_cont[idx]
