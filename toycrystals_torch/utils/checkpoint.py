"""Single-file msgpack checkpoints, in the JAX package's format.

Counterpart of toycrystals_tpu/utils/checkpoint.py. A checkpoint is one
msgpack file holding a nested dict of numpy arrays and Python scalars, as
`flax.serialization.msgpack_serialize(to_state_dict(tree))` writes it; the
codec is the port's own (utils/msgpack_codec.py), so files pass both ways
between the two packages. Before encoding, a tree is made plain as flax's
`to_state_dict` and the JAX `_to_plain` make it: tensors become numpy arrays
copied to the host, numpy scalars 0-d arrays, lists and tuples dicts keyed
"0", "1", ...

`load_checkpoint(path)` returns the raw nested dict; `load_score_payload`
reads any score-model checkpoint the consumers accept.
"""

from __future__ import annotations

import os
import sys
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from toycrystals_torch.utils.msgpack_codec import Bfloat16Array, packb, unpackb


def _host(t: torch.Tensor):
    """A tensor as a numpy array that owns a copy of its values on the host
    (the train state is updated in place, so a view would change under a
    writer that is still encoding it)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return Bfloat16Array(t.view(torch.int16).numpy().view(np.uint16))
    return t.numpy()


def _to_plain(tree: Any) -> Any:
    """`tree` with tensors copied to the host as numpy, numpy scalars as 0-d
    arrays and lists and tuples as dicts keyed by position."""
    if isinstance(tree, torch.Tensor):
        return _host(tree)
    if isinstance(tree, np.generic):
        return np.asarray(tree)
    if isinstance(tree, dict):
        return {str(k): _to_plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _to_plain(v) for i, v in enumerate(tree)}
    return tree


def _atomic_write(path: Path, payload: bytes) -> None:
    """Write to a temporary file, then rename: a crash mid-write leaves any
    checkpoint already at `path` intact."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(payload)
    os.replace(tmp, path)


def save_checkpoint(path: str | Path, tree: Any) -> None:
    """Atomically write `tree` (a nested dict) as msgpack."""
    _atomic_write(Path(path), packb(_to_plain(tree)))


class AsyncCheckpointer:
    """Overlap a checkpoint's encoding and disk write with training.

    `save()` copies every tensor of the tree to the host before it returns
    (the train state is updated in place by the next step), then encodes and
    writes on a background thread. At most one write is in flight: a second
    `save()` first joins the previous one. A failed write re-raises from the
    next `save()` or `wait()`. Use as a context manager, so the process
    cannot exit between "checkpoint saved" and the bytes reaching the disk.
    """

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, path: str | Path, tree: Any) -> None:
        """Copy `tree` to the host, then write it to `path` in the background."""
        self.wait()
        plain = _to_plain(tree)

        def _write() -> None:
            try:
                _atomic_write(Path(path), packb(plain))
            except BaseException as e:  # noqa: BLE001 - re-raised at wait()
                self._error = e

        self._thread = threading.Thread(target=_write, name="async-checkpoint", daemon=False)
        self._thread.start()

    def wait(self) -> None:
        """Block until the write in flight, if any, is on disk; re-raise its
        failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            # unwinding on an exception from the body (the divergence guard's
            # SystemExit, ^C): join the writer, but report a failed write
            # instead of letting it replace the body's exception
            try:
                self.wait()
            except BaseException as werr:  # noqa: BLE001
                print(f"warning: async checkpoint write failed during shutdown: {werr!r}",
                      file=sys.stderr)
            return
        self.wait()


def float_list(value) -> list[float]:
    """A list of floats that a checkpoint stored (restored as a dict keyed
    "0", "1", ...) or that a caller holds as a list."""
    return [float(v) for v in (value.values() if isinstance(value, dict) else value)]


def load_checkpoint(path: str | Path) -> Any:
    """Read a msgpack checkpoint as its raw nested dict (numpy leaves)."""
    return unpackb(Path(path).read_bytes())


def load_score_payload(path: str | Path) -> dict:
    """Read a score-model checkpoint in any format the consumers accept,
    shaped like `load_checkpoint` of a msgpack file
    (`{"state": {...}, "config": {...}, "epoch_next": N, ...}`):

    - `*.pt`: the reference torch layout (utils/torch_interop.py);
    - a directory: a `--ckpt-format orbax` checkpoint of the port
      (utils/orbax_io.py; one written by the JAX package is refused);
    - anything else: msgpack.
    """
    p = str(path)
    if p.endswith(".pt"):
        from toycrystals_torch.utils.torch_interop import load_torch_score_checkpoint

        return load_torch_score_checkpoint(p)
    if os.path.isdir(p):
        from toycrystals_torch.utils.orbax_io import load_orbax_payload

        return load_orbax_payload(p)
    return load_checkpoint(p)
