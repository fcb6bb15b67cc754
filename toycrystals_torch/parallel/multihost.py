"""Multi-process runs: a torch.distributed process group, one process per device.

Counterpart of toycrystals_tpu/parallel/multihost.py, with one deliberate
difference in the process model. A JAX mesh is one process driving N
devices, and `jax.distributed` joins several such processes. Here every
device has a process of its own, so an N-way data mesh is always N
processes in one process group:

- `launch(fn, n, ...)` spawns n local ranks over a file rendezvous that it
  owns, runs `fn(*args)` in each and returns their results. The CLIs' `--shard
  N` uses it when no cluster flags are given: rank r runs on `cuda:r`, or on
  the CPU when the CLI was given `--device cpu`;
- `maybe_initialize(coordinator, num_processes, process_id)` joins a TCP
  rendezvous at `coordinator` (host:port of rank 0), or, with
  `coordinator="auto"`, the `env://` rendezvous that torchrun sets up: the
  counterpart of `jax.distributed.initialize()` with no arguments.

The backend is NCCL for CUDA devices and gloo for the CPU; `launch` takes
another where the caller names one (two ranks on one card over gloo).
Every rendezvous and every collective has a timeout, and the launcher
kills all its ranks and raises when one fails or the time runs out, so a
dead rank never hangs its caller. Exactly one process (rank 0) writes
host-side artefacts (`is_primary`).
"""

from __future__ import annotations

import os
import pickle
import queue
import signal
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

# every rendezvous and collective of a process group made here
COLLECTIVE_TIMEOUT = timedelta(seconds=300)


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def maybe_initialize(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, *, device_type: str = "cuda",
                     backend: str | None = None) -> bool:
    """Join (or form) a process group; True when it has more than one rank.

    - no flags, or num_processes 1: a no-op (one process);
    - coordinator "auto": torchrun's environment (`env://`), and
      num_processes / process_id must not be given;
    - coordinator host:port with num_processes and process_id: a TCP
      rendezvous at rank 0's address.

    A process group that already exists (a rank that `launch` started) is
    kept as it is. `backend` overrides the device type's default (gloo on
    CUDA: ranks that share a card)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is None and num_processes is None and process_id is None:
        return False
    if coordinator == "auto" and (num_processes is not None or process_id is not None):
        raise SystemExit("--coordinator auto detects num_processes/process_id from the "
                         "cluster environment; do not also pass --num-processes/--process-id")
    if num_processes is not None and num_processes <= 1:
        return False
    backend = backend or default_backend(device_type)
    if coordinator == "auto":
        if device_type == "cuda":
            torch.cuda.set_device(local_device_index())
        dist.init_process_group(backend, init_method="env://",
                                timeout=COLLECTIVE_TIMEOUT)
        return dist.get_world_size() > 1
    if coordinator is None or num_processes is None or process_id is None:
        raise SystemExit("--coordinator host:port, --num-processes and --process-id go together")
    if not 0 <= process_id < num_processes:
        raise SystemExit(f"--process-id {process_id} is not in [0, {num_processes})")
    if device_type == "cuda":
        torch.cuda.set_device(local_device_index(process_id))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=COLLECTIVE_TIMEOUT)
    return dist.get_world_size() > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the one process that writes host-side artefacts."""
    return process_index() == 0


def local_device_index(rank: int | None = None) -> int:
    """The CUDA device of this rank on its host: torchrun's LOCAL_RANK where
    it is set, else the rank modulo the devices visible."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = process_index() if rank is None else rank
    return rank % max(torch.cuda.device_count(), 1)


def rank_device(device: torch.device) -> torch.device:
    """The device of this rank for a run asked for on `device`: the CPU
    stays the CPU, and a CUDA device becomes the rank's own (`cuda:r`)
    when a process group spans several ranks."""
    device = torch.device(device)
    if device.type != "cuda" or process_count() == 1:
        return device
    return torch.device("cuda", torch.cuda.current_device())


def global_batch(mesh, batch: Any) -> Any:
    """A host batch holding the whole global content on every rank -> this
    rank's rows of it (parallel/mesh.py `shard_batch`)."""
    from toycrystals_torch.parallel.mesh import shard_batch

    return shard_batch(mesh, batch)


# ---------------------------------------------------------------------------
# The local launcher
# ---------------------------------------------------------------------------


def _exit_with_parent() -> None:
    """End this process when the launcher that started it is gone (killed,
    say): no one would collect its result, and a rank that waits for work
    (a server's follower) would otherwise wait forever."""
    import threading

    parent = os.getppid()

    def watch():
        while True:
            time.sleep(1.0)
            if os.getppid() != parent:
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _rank_main(rank: int, world: int, init_method: str, backend: str, device_type: str,
               device_ids: Sequence[int] | None, call: str, results) -> None:
    import faulthandler

    faulthandler.enable()  # a crash in native code still names its Python frame
    _exit_with_parent()
    torch.set_num_threads(1)
    try:
        with open(call, "rb") as f:
            fn, args = pickle.load(f)
        if device_type == "cuda":
            torch.cuda.set_device(device_ids[rank] if device_ids is not None else rank)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                timeout=COLLECTIVE_TIMEOUT)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the launcher, then the rank exits
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def launch(fn: Callable, nprocs: int, args: tuple = (), *, device_type: str = "cpu",
           backend: str | None = None, device_ids: Sequence[int] | None = None,
           timeout: float = 900.0, sigterm_rank: int | None = None) -> list:
    """Run `fn(*args)` in `nprocs` spawned ranks of one process group and
    return their results, rank by rank.

    `fn` and `args` are pickled, so `fn` lives at module level of a module
    that imports neither JAX nor a test. Each rank sets one CPU thread, its
    CUDA device (`device_ids[rank]`, default the rank) and joins a file
    rendezvous in a temporary directory. When a rank raises, exits or the
    whole run exceeds `timeout` seconds, every rank is killed and this
    raises RuntimeError (TimeoutError) with the failing rank's traceback; a
    rank whose launcher dies exits within a second.
    With `sigterm_rank`, a SIGTERM to this process (from the main thread's
    handler) is sent on to that rank, which decides how the run ends (a
    server drains and stops the others)."""
    import multiprocessing as mp

    backend = backend or default_backend(device_type)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="toycrystals-rdzv-") as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        # fn and args reach the ranks through a file: a spawned process's
        # arguments fill a pipe that `start` writes before it returns, so
        # arguments larger than the pipe would hold each rank's start until the
        # one before it had imported its modules and read them
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, nprocs, init, backend, device_type, device_ids, call,
                                   results))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        old = None
        if sigterm_rank is not None:
            old = signal.signal(signal.SIGTERM,
                                lambda signum, frame: os.kill(procs[sigterm_rank].pid, signum))
        try:
            out = _collect(procs, results, time.monotonic() + timeout)
        finally:
            if old is not None:
                signal.signal(signal.SIGTERM, old)
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return out


def _collect(procs, results, deadline: float) -> list:
    """The ranks' results, draining the queue before any join; kills every
    rank and raises on the first failure, death or the deadline."""
    got: dict[int, Any] = {}
    while len(got) < len(procs):
        try:
            rank, ok, value = results.get(timeout=0.2)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode not in (None, 0)]
            if dead:
                _kill(procs)
                raise RuntimeError(f"rank {dead[0]} died with exit code "
                                   f"{procs[dead[0]].exitcode}") from None
            if time.monotonic() > deadline:
                _kill(procs)
                raise TimeoutError(f"ranks {sorted(set(range(len(procs))) - set(got))} did "
                                   f"not finish in time") from None
            continue
        if not ok:
            _kill(procs)
            raise RuntimeError(f"rank {rank} failed:\n{value}")
        got[rank] = value
    return [got[r] for r in range(len(procs))]


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
