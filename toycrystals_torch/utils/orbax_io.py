"""Sharded checkpoints: the port's `--ckpt-format orbax` format.

Counterpart of toycrystals_tpu/utils/orbax_io.py, with its names and flag,
but the directories are torch.distributed.checkpoint (DCP) directories, not
orbax's: the card machine has neither orbax nor tensorstore. So sharded
checkpoints do not pass between the two packages. A directory that the JAX
package wrote is refused here with a message that says so and points to
msgpack (utils/checkpoint.py), which both packages read and write
(NotImplementedError).

- per-shard IO: under FSDP2 (HSDP too) each rank writes and reads its own
  shards of every DTensor, and on a model axis its blocks (parallel/tensor.py;
  given to DCP as a ShardedTensor of the whole leaf with one local shard per
  piece, so a qkv placed by head is read back by any layout); replicated
  tensors and blocks held by several data ranks are written once;
- resharding restore: `restore_onto` loads into whatever layout the target
  state has (FSDP over N ranks, DistributedDataParallel, one process), so a
  checkpoint saved on two ranks restores on one and the other way round;
- step-managed layout and retention: one step directory per save, written
  under `<step>.tmp` and renamed when complete, so a crash mid-save keeps
  the previous step; the newest `max_to_keep` steps are kept;
- asynchronous: `save` stages the tensors to the host and writes them on a
  thread (`dcp.async_save`) over a gloo group of its own, so the training
  collectives never interleave with the checkpoint's; `wait()` is the
  durability barrier. DCP's stager cannot copy a ShardedTensor, so a state
  with model blocks is copied to the host here and written before `save`
  returns (`dcp.save`).

Layout on disk: `<path>/<step>/state/` (DCP: `.metadata` and one `.distcp`
file per writing rank) holding the `TrainState` under torch names
(`params.<name>`, `mu.<name>`, `nu.<name>`, `ema.<name>` and `counters` =
[step, count, notfinite_count, total_notfinite]), and
`<path>/<step>/meta.json`: `epoch_next`, `loss_hist`, `config` (the
self-describing payload of the msgpack format) and `opt_layout`, the
optimizer flags that shape the optax-layout `opt_state`.

`load_orbax_payload` reads a directory in one process, with no process group,
into the payload that `load_checkpoint` gives for a msgpack file, so every
consumer CLI reads either format.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist

_JAX_ORBAX = ("{} was written by the JAX package (orbax/tensorstore), which this package "
              "cannot read: the port's sharded checkpoints are torch.distributed.checkpoint "
              "directories (a deliberate difference, ROADMAP.md section 3). Convert it to "
              "msgpack, which both packages read (the JAX package's load_orbax_payload, then "
              "its save_checkpoint).")


def is_orbax_checkpoint(path: str | Path) -> bool:
    """True for a step-managed checkpoint directory (vs a msgpack file)."""
    p = Path(path)
    return p.is_dir() and any(c.is_dir() and c.name.isdigit() for c in p.iterdir())


def _steps(path: Path) -> list[int]:
    if not path.is_dir():
        return []
    return sorted(int(c.name) for c in path.iterdir() if c.is_dir() and c.name.isdigit())


def _step_dir(path: str | Path, step: int | None) -> Path:
    """The directory of `step` (default the newest); refuses an empty
    directory and one the JAX package wrote."""
    path = Path(path).absolute()
    steps = _steps(path)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoint steps under {path}")
        step = steps[-1]
    d = path / str(int(step))
    if not (d / "state" / ".metadata").is_file() or not (d / "meta.json").is_file():
        if d.is_dir():
            raise NotImplementedError(_JAX_ORBAX.format(path))
        raise FileNotFoundError(f"no checkpoint step {step} under {path}")
    return d


def _state_dict(state, host: bool = False) -> dict[str, torch.Tensor]:
    """The tensors of a `TrainState` (train/state.py) under DCP keys, as
    they are laid out (DTensors stay sharded, model blocks become
    ShardedTensors over their storage, or with `host` over copies of them on
    the host; a block that FSDP2 shards becomes one over its local shard)."""
    from toycrystals_torch.parallel.fsdp import is_sharded
    from toycrystals_torch.parallel.tensor import block_of, sharded_tensor

    def laid(t):
        blk = block_of(t)
        if blk is None:
            return t.detach().to("cpu", copy=True) if host and not is_sharded(t) else t
        return sharded_tensor(t, blk, host)

    opt = state.opt_state
    dev = next(iter(state.params.values())).device
    sd: dict[str, torch.Tensor] = {f"params.{k}": laid(v) for k, v in state.params.items()}
    sd.update({f"mu.{k}": laid(m) for k, m in zip(state.params, opt.mu)})
    sd.update({f"nu.{k}": laid(v) for k, v in zip(state.params, opt.nu)})
    if state.ema_params is not None:
        sd.update({f"ema.{k}": laid(v) for k, v in state.ema_params.items()})
    sd["counters"] = torch.tensor([state.step, opt.count, opt.notfinite_count,
                                   opt.total_notfinite], dtype=torch.int64, device=dev)
    return sd


def _has_blocks(state) -> bool:
    from toycrystals_torch.parallel.tensor import block_of

    return any(block_of(p) is not None for p in state.params.values())


def _opt_layout(tx) -> dict:
    return {"schedule": callable(tx.lr), "clip": tx.clip_grad_norm > 0.0,
            "skip_nonfinite": tx.skip_nonfinite > 0}


class ShardedCheckpointManager:
    """Step-per-save DCP manager holding the newest `max_to_keep` steps.

    Every rank of the process group (if there is one) constructs it, calls
    `save` and `restore_onto` together, and leaves it by `close()` (or the
    context manager). `save(step, state, tx, meta)` starts an asynchronous
    write; `wait()` blocks until it is complete and committed."""

    def __init__(self, path: str | Path, max_to_keep: int = 1):
        self.path = Path(path).absolute()
        self.max_to_keep = int(max_to_keep)
        self._group = dist.new_group(backend="gloo") if dist.is_initialized() else None
        self._primary = not dist.is_initialized() or dist.get_rank() == 0
        self._pending: tuple[Any, int, dict] | None = None

    def _dcp_kw(self) -> dict:
        return {"process_group": self._group} if self._group is not None else {"no_dist": True}

    def save(self, step: int, state, tx, meta: dict) -> None:
        """Start writing `state` (a TrainState of `tx`'s optimizer, sharded
        or not) and the JSON-able `meta` as step `step`; a save still in
        flight is completed first."""
        import torch.distributed.checkpoint as dcp

        self.wait()
        step = int(step)
        tmp = self.path / f"{step}.tmp"
        if self._primary:
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(parents=True)
        if self._group is not None:
            dist.barrier(group=self._group)
        if _has_blocks(state):
            from concurrent.futures import Future

            dcp.save(_state_dict(state, host=True), checkpoint_id=str(tmp / "state"),
                     **self._dcp_kw())
            fut = Future()
            fut.set_result(None)
        else:
            fut = dcp.async_save(_state_dict(state), checkpoint_id=str(tmp / "state"),
                                 **self._dcp_kw())
        self._pending = (fut, step, {**meta, "opt_layout": _opt_layout(tx)})

    def wait(self) -> None:
        """Durability barrier: block until the save in flight is on disk and
        committed (renamed into place, older steps pruned)."""
        if self._pending is None:
            return
        fut, step, meta = self._pending
        self._pending = None
        fut.result()
        if self._primary:
            tmp, final = self.path / f"{step}.tmp", self.path / str(step)
            (tmp / "meta.json").write_text(json.dumps(meta))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in _steps(self.path)[:-self.max_to_keep]:
                shutil.rmtree(self.path / str(old), ignore_errors=True)
        if self._group is not None:
            dist.barrier(group=self._group)

    def latest_step(self) -> int | None:
        """The newest committed step (a save in flight commits at `wait`)."""
        steps = _steps(self.path)
        return steps[-1] if steps else None

    def restore_onto(self, state, step: int | None = None):
        """(state, meta): the newest (or the given) step loaded in place into
        `state`'s tensors, whatever their layout: the saving run's ranks and
        sharding do not matter."""
        import torch.distributed.checkpoint as dcp

        d = _step_dir(self.path, step)
        sd = _state_dict(state)
        dcp.load(sd, checkpoint_id=str(d / "state"), **self._dcp_kw())
        step_, count, nf, tnf = (int(v) for v in sd["counters"].tolist())
        state.step = step_
        state.opt_state.count = count
        state.opt_state.notfinite_count, state.opt_state.total_notfinite = nf, tnf
        return state, _read_meta(d)

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "ShardedCheckpointManager":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # as AsyncCheckpointer: always complete the write; on an exception in
        # the body report a failed commit instead of masking the original
        try:
            self.close()
        except BaseException as werr:  # noqa: BLE001
            if exc is None:
                raise
            print(f"warning: sharded checkpoint commit failed during shutdown: {werr!r}",
                  file=sys.stderr)


def _read_meta(step_dir: Path) -> dict:
    return json.loads((step_dir / "meta.json").read_text())


def load_orbax_meta(path: str | Path, step: int | None = None) -> dict:
    """Only the JSON sidecar (epoch_next, loss_hist, config, opt_layout): the
    trainer's --resume peek before the model is built."""
    return _read_meta(_step_dir(path, step))


def load_orbax_payload(path: str | Path, step: int | None = None) -> dict:
    """A checkpoint directory as the payload `load_checkpoint` gives for a
    msgpack file: `{"state": {"step", "params", "opt_state",
    "ema_params"}, **meta}`, with the flax-layout trees of the score model
    and the optax `opt_state` of the saving run's flags. One process, no
    process group; every tensor lands on the CPU."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    from toycrystals_torch.train.state import OptState, Optimizer, TrainState
    from toycrystals_torch.utils.params import train_state_to_checkpoint

    d = _step_dir(path, step)
    reader = FileSystemReader(str(d / "state"))
    md = reader.read_metadata()
    sd = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
          for k, m in md.state_dict_metadata.items() if isinstance(m, TensorStorageMetadata)}
    dcp.load(sd, storage_reader=reader, no_dist=True)
    meta = _read_meta(d)
    layout = meta.pop("opt_layout")

    def part(prefix: str) -> dict[str, torch.Tensor]:
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    params = part("params.")
    names = list(params)
    mu, nu, ema = part("mu."), part("nu."), part("ema.")
    step_, count, nf, tnf = (int(v) for v in sd["counters"].tolist())
    state = TrainState(step_, params, OptState(count, [mu[k] for k in names],
                                               [nu[k] for k in names], nf, tnf),
                       ema or None)
    tx = Optimizer((lambda c: 0.0) if layout["schedule"] else 0.0,
                   clip_grad_norm=1.0 if layout["clip"] else 0.0,
                   skip_nonfinite=1 if layout["skip_nonfinite"] else 0)
    return {"state": train_state_to_checkpoint(state, tx), **meta}
