"""Shared plumbing of the port's CLIs (counterpart of scripts/_common.py):
device selection, the data mesh and its process group (--shard, --fsdp and
the cluster flags), the (data, space) mesh of the score model's sampling,
inpainting, serving and training CLIs (--shard-space), the (data, model)
mesh of those and of the VAE and prior trainers (--shard-model), the 3-D
(data, space, model) mesh of the score model's CLIs (both flags),
checkpoint-name resolution and a disk archive resident on the device.

`--shard N` (with `--shard-space S`: N x S; with `--shard-model M`, and in
the prior's trainer `--shard-pipe S` or `--shard-expert E`: N x M, N x S,
N x E; with `--shard-space S --shard-model M`: N x S x M) with no cluster
flags runs the CLI in that many spawned local ranks (`spawn_shards`), one
per device (parallel/multihost.py); the cluster flags join a process group
whose ranks were started elsewhere, one per device, and then the mesh must
equal its size."""

from __future__ import annotations

import argparse
import math
import os
from pathlib import Path

import torch

from toycrystals_torch.data.datasets import load_archive
from toycrystals_torch.serve import resolve_device


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or auto: the GPU, and an error without one; "
                        "cpu: the plain versions of the kernels on the CPU, only when asked.")


def select_device(device: str) -> torch.device:
    """'cuda', 'cuda:N', 'auto' (= 'cuda') or 'cpu'. A CUDA device with no GPU
    raises: nothing falls back to the CPU. In a process group of several
    ranks, 'cuda' is this rank's own device."""
    from toycrystals_torch.parallel.multihost import rank_device

    return rank_device(resolve_device("cuda" if device == "auto" else device))


def add_shard_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--shard", type=int, default=0,
                   help="Data parallelism over N devices: N ranks (one process per device), "
                        "each with its rows of every batch, gradients averaged over the ranks "
                        "(DistributedDataParallel). Needs the batch size to divide by N. 0/1 "
                        "= one device.")


def add_dist_flags(p: argparse.ArgumentParser) -> None:
    """--coordinator/--num-processes/--process-id: join a process group of
    ranks started elsewhere (parallel/multihost.py `maybe_initialize`)."""
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0's rendezvous (multi-host runs: start the same "
                        "command on every host, one process per device), or 'auto' to read "
                        "torchrun's environment. Omit for one host: --shard N spawns the "
                        "ranks itself.")
    p.add_argument("--num-processes", type=int, default=None,
                   help="Total number of processes (ranks) in the process group.")
    p.add_argument("--process-id", type=int, default=None,
                   help="This process's rank in [0, --num-processes).")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="The process group's backend: nccl on CUDA devices and gloo on the "
                        "CPU by default. gloo on CUDA lets several ranks share a card (rank r "
                        "takes card r modulo the cards visible), which nccl refuses.")


def add_parallel_flags(p: argparse.ArgumentParser, train: bool = True,
                       space: bool = True) -> None:
    """The JAX CLIs' mesh and multi-process flags: --shard (and --fsdp for a
    trainer), --shard-model and the cluster flags run, and so does
    --shard-space (the score model's CLIs). `space=False` leaves out
    --shard-space, as the VAE trainer's and the prior trainer's JAX CLIs
    do."""
    add_shard_flag(p)
    if space:
        p.add_argument("--shard-space", type=int, default=0,
                       help="Spatial parallelism: split every image's height over S ranks (a "
                       "2-D data x space mesh of --shard x S ranks, one per device): the "
                       "hi-res case whose activations outgrow one device. H/4 must divide "
                       "by S." + (" The weights are replicated over all the ranks, or with "
                                  "--fsdp sharded over --shard and replicated over S (HSDP)."
                                  if train else ""))
    p.add_argument("--shard-model", type=int, default=0,
                   help="Tensor parallelism: split every weight's output channels over M ranks "
                        "(a 2-D data x model mesh of --shard x M ranks, one per device, "
                        "parallel/tensor.py); leaves whose channels do not divide by M stay "
                        "whole." + (" With --fsdp each rank's blocks are sharded over --shard "
                                    "too (2-D weight sharding)." if train else "")
                        + (" With --shard-space too, a 3-D data x space x model mesh of "
                           "--shard x S x M ranks." if space else ""))
    if train:
        p.add_argument("--fsdp", action="store_true",
                       help="ZeRO-3 placement: with --shard N, also shard every weight, its "
                            "Adam moments and its EMA 1/N over the ranks (FSDP2, "
                            "parallel/fsdp.py). No effect without --shard >= 2.")
    add_dist_flags(p)


CLUSTER_DESTS = ("coordinator", "num_processes", "process_id")


def init_distributed(args: argparse.Namespace, device: str = "cuda") -> bool:
    """Join the process group that the cluster flags name, before the
    first device is chosen. True when the flags made a multi-process group
    (not when `spawn_shards` started this rank)."""
    from toycrystals_torch.parallel.multihost import maybe_initialize, process_count

    cluster = any(getattr(args, d, None) is not None for d in CLUSTER_DESTS)
    multi = maybe_initialize(getattr(args, "coordinator", None),
                             getattr(args, "num_processes", None),
                             getattr(args, "process_id", None),
                             device_type="cpu" if device == "cpu" else "cuda",
                             backend=getattr(args, "dist_backend", None))
    if multi and cluster:
        import torch.distributed as dist

        print(f"torch.distributed: rank {dist.get_rank()}/{process_count()}")
    return multi and cluster


def _run_rank(fn, argv) -> None:
    fn(argv)


def spawn_shards(args: argparse.Namespace, fn, argv: list[str] | None,
                 batch_sizes: tuple[int, ...] = (), sigterm_rank: int | None = None) -> bool:
    """--shard N > 1, or --shard N x --shard-space S, x --shard-model M, x
    both, x --shard-pipe S or x --shard-expert E > 1,
    with no cluster flags and no process group yet: run `fn(argv)` (a CLI's
    module-level entry) in that many spawned local ranks on `cuda:0..`, or
    on the CPU under --device cpu, and return True once all finished; False
    when this process should run the CLI itself. Any rank's failure exits
    non-zero with its traceback; a SIGTERM to this process goes on to rank
    `sigterm_rank` when one is named."""
    import torch.distributed as dist

    from toycrystals_torch.parallel.multihost import launch

    shard = getattr(args, "shard", 0)
    # the axes beside "data", in the mesh's order (space and model together:
    # JAX's 3-D mesh; the prior's trainer refuses two of its axes before this)
    axes = [(axis, n) for axis in ("space", "model", "pipe", "expert")
            if (n := getattr(args, f"shard_{axis}", 0) or 0) > 1]
    ranks = max(1, shard) * math.prod(n for _, n in axes)
    if ranks <= 1 or dist.is_initialized() or any(
            getattr(args, d, None) is not None for d in CLUSTER_DESTS):
        return False
    check_shard_batches(shard, *batch_sizes)
    device_type = "cpu" if args.device == "cpu" else "cuda"
    backend = getattr(args, "dist_backend", None)
    device_ids = None
    if device_type == "cuda":
        select_device(args.device)
        n_dev = torch.cuda.device_count()
        if backend == "gloo":
            device_ids = [r % n_dev for r in range(ranks)]
        elif ranks > n_dev:
            raise SystemExit(f"--shard {shard} but only {n_dev} devices visible" if not axes
                             else f"--shard {shard} x " + " x ".join(
                                 f"--shard-{a} {n}" for a, n in axes)
                             + f" needs {ranks} devices, have {n_dev}")
    print(f"data-parallel mesh: {shard} ranks on {device_type}" if not axes
          else f"{len(axes) + 1}-D mesh: {max(1, shard)} data x "
               + " x ".join(f"{n} {a}" for a, n in axes) + f" ranks on {device_type}")
    try:
        launch(_run_rank, ranks, (fn, list(argv) if argv is not None else None),
               device_type=device_type, backend=backend, device_ids=device_ids,
               timeout=24 * 3600.0, sigterm_rank=sigterm_rank)
    except (RuntimeError, TimeoutError) as e:
        raise SystemExit(f"--shard {shard}: {e}") from None
    return True


def check_shard_batches(shard: int, *batch_sizes: int) -> None:
    if shard < 0:
        raise SystemExit(f"--shard must be >= 0, got {shard}")
    for b in batch_sizes:
        if b % max(1, shard):
            raise SystemExit(f"batch size {b} not divisible by --shard {shard}")


def setup_mesh(shard: int, *batch_sizes: int, device: torch.device,
               shard_space: int = 0, shard_model: int = 0, shard_pipe: int = 0,
               shard_expert: int = 0, img_size: int | None = None):
    """--shard N into the ("data",) mesh of this process group (None for
    one device). Every batch size must divide by N and the group must have
    exactly N ranks. --shard-space S > 1 (the score model's CLIs) makes the
    ("data", "space") mesh of N x S ranks (the caller checks the image size
    against S: parallel/spatial.py `check_stem_divisibility`), --shard-model
    M > 1 the ("data", "model") mesh of N x M ranks, both JAX's 3-D ("data",
    "space", "model") mesh of N x S x M ranks (JAX's checks and line: the
    device count, then `img_size` against S where given), and the prior's
    --shard-pipe S / --shard-expert E the ("data", "pipe") / ("data",
    "expert") mesh of N x S / N x E ranks."""
    from toycrystals_torch.parallel import mesh as pm
    from toycrystals_torch.parallel.multihost import process_count
    from toycrystals_torch.parallel.spatial import check_spatial_divisibility

    check_shard_batches(shard, *batch_sizes)
    world = process_count()
    if shard_space > 1 and shard_model > 1:
        n_data = max(1, shard)
        need = n_data * shard_space * shard_model
        if need != world:
            raise SystemExit(f"--shard {shard} x --shard-space {shard_space} x --shard-model "
                             f"{shard_model} needs {need} devices, have {world} (one per rank)")
        if img_size is not None:
            try:
                check_spatial_divisibility(img_size, shard_space)
            except ValueError as e:
                raise SystemExit(str(e)) from None
        from toycrystals_torch.parallel.multihost import is_primary

        if is_primary():
            print(f"3-D mesh: {n_data} data x {shard_space} space x {shard_model} model "
                  f"devices")
        return pm.make_mesh_3d(n_data, shard_space, shard_model, torch.device(device).type)
    for axis, n, make in (("model", shard_model, pm.make_mesh_tp),
                          ("space", shard_space, pm.make_mesh_2d),
                          ("pipe", shard_pipe, pm.make_mesh_pp),
                          ("expert", shard_expert, pm.make_mesh_ep)):
        if n > 1:
            need = max(1, shard) * n
            if need != world:
                raise SystemExit(f"--shard {shard} x --shard-{axis} {n} needs {need} "
                                 f"devices, have {world} (one per rank)")
            return make(max(1, shard), n, torch.device(device).type)
    if shard in (0, 1) and world == 1:
        return None
    if shard != world:
        # one device per process: a process group of `world` ranks sees `world`
        raise SystemExit(f"--shard {shard} but only {world} devices visible (one per rank: "
                         f"the CLI's main spawns --shard ranks, or start them with the "
                         f"cluster flags)")
    return pm.make_mesh(shard, torch.device(device).type)


def any_rank(mesh, flag: bool, device) -> bool:
    """True on every rank when `flag` is true on any (a preemption signal
    that reached one rank stops them all at the same epoch)."""
    if mesh is None:
        return bool(flag)
    from toycrystals_torch.parallel.mesh import all_reduce_sum

    return bool(all_reduce_sum(mesh, torch.tensor([float(flag)], device=device)).item())


def place_state(mesh, model, state, fsdp: bool = False, what: str = "channel counts",
                n_micro: int = 1):
    """The trainers' placement: DistributedDataParallel, FSDP2 under `fsdp`
    (HSDP on a space axis), the model axis's blocks, or both (2-D weight
    sharding), printing the share of parameter elements that FSDP2 and the
    model axis shard, as JAX does (`what` the flag its warning names); on
    the prior's pipe mesh its stage (`n_micro` microbatches) and on its
    expert mesh the experts' blocks, with JAX's coverage line, where `fsdp`
    changes nothing, as in JAX. mesh=None passes through. Returns (module to
    train, state)."""
    from toycrystals_torch.parallel import fsdp_coverage
    from toycrystals_torch.parallel import place_state as _place
    from toycrystals_torch.parallel.expert import ep_report
    from toycrystals_torch.parallel.mesh import AXIS, EXPERT, MODEL, PIPE, axis_size
    from toycrystals_torch.parallel.multihost import is_primary
    from toycrystals_torch.parallel.tensor import shard_report

    pipe, ep = axis_size(mesh, PIPE), axis_size(mesh, EXPERT)
    # JAX: a no-op without a data axis, and under the pipe and expert axes
    fsdp = fsdp and mesh is not None and axis_size(mesh, AXIS) > 1 and pipe == ep == 1
    m = axis_size(mesh, MODEL)
    if mesh is not None and is_primary():
        if fsdp:
            print(f"fsdp: {fsdp_coverage(axis_size(mesh, AXIS), model, m):.0%} of param "
                  f"elements sharded over 'data'")
        if m > 1:
            print(shard_report(m, model, what))
        if ep > 1:
            print(ep_report(ep, model, model.n_experts))
    return _place(mesh, model, state, fsdp, n_micro)


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
