"""Streaming a dataset archive from host memory to the card, a few batches ahead.

Counterpart of toycrystals_tpu/data/stream.py and data/native_gather.py. The
trainers' default disk path keeps the whole u8 archive on the device
(scripts/_common.py:ResidentDiskDataset); this one keeps it on the host, for
archives that outgrow the card but fit host memory:

- `StreamingDiskDataset` holds the archive (`load_archive`: .npz or the
  reference's torch dict) on the host as u8 tensors, page-locked when the
  target is a CUDA device;
- `take_rows` gathers a batch's rows with `torch.index_select(src, 0, idx,
  out=buffer)`, which runs on ATen's intra-op threads (the JAX package
  compiles a threaded C++ gather for numpy, `_native/gather.cpp`). There is
  no fallback: the gather always runs in torch;
- `prefetch_to_device` keeps `size` batches in flight: each is copied with
  `non_blocking=True` on a side CUDA stream, and the compute stream waits on
  that copy's event before the batch is used. Each batch's host buffer is a
  fresh page-locked tensor from torch's caching host allocator, which hands
  a block out again only after the copies that read it have completed; each
  device tensor is marked with `record_stream` for the compute stream, so its
  memory is not reused while a step still reads it;
- `to_f01` turns u8 into f32 / 255 on the device, the same op as the
  resident path's gather, so both paths give the same bits.
"""

from __future__ import annotations

from collections import deque
from pathlib import Path
from typing import Callable, Iterable, Iterator

import torch

from toycrystals_torch.data.datasets import load_archive

Batch = tuple[torch.Tensor, ...]


def take_rows(src: torch.Tensor, idx, out: torch.Tensor | None = None) -> torch.Tensor:
    """`src[idx]` along axis 0, gathered on ATen's intra-op threads into
    `out` (allocated when None). An index out of range raises IndexError."""
    idx = torch.as_tensor(idx, dtype=torch.int64)
    if idx.ndim != 1:
        raise ValueError(f"idx must be 1-D, got shape {tuple(idx.shape)}")
    return torch.index_select(src, 0, idx, out=out)


def to_f01(x_u8: torch.Tensor) -> torch.Tensor:
    """u8 [0, 255] -> f32 [0, 1], on the tensor's device."""
    return x_u8.to(torch.float32) / 255.0


class StreamingDiskDataset:
    """A dataset archive on the host, streamed to `device` batch by batch.
    `host_batch(idx)` gathers (x_u8 [B, H, W, 1], y_cat, y_cont) on the host
    (page-locked for a CUDA device); `device_batches` streams an epoch."""

    def __init__(self, path: str | Path, device="cuda") -> None:
        self.device = torch.device(device)
        self.pin = self.device.type == "cuda"
        arrays = (torch.from_numpy(a) for a in load_archive(path))
        self.x_u8, self.y_cat, self.y_cont = (a.pin_memory() if self.pin else a for a in arrays)

    def __len__(self) -> int:
        return int(self.x_u8.shape[0])

    def host_batch(self, idx) -> Batch:
        idx = torch.as_tensor(idx, dtype=torch.int64)
        return tuple(take_rows(a, idx, out=torch.empty((len(idx), *a.shape[1:]), dtype=a.dtype,
                                                        pin_memory=self.pin))
                     for a in (self.x_u8, self.y_cat, self.y_cont))

    def device_batches(self, index_batches: Iterable, size: int = 2) -> Iterator[Batch]:
        """(x f32 [B, H, W, 1] in [0, 1], y_cat, y_cont) on the device for
        each index batch, `size` copies ahead of the consumer."""
        host = (self.host_batch(idx) for idx in index_batches)
        for x_u8, y_cat, y_cont in prefetch_to_device(host, size, CopyToDevice(self.device)):
            yield to_f01(x_u8), y_cat, y_cont


class CopyToDevice:
    """place(batch) for `prefetch_to_device`: starts the copy of a tuple of
    host tensors to `device` and returns (device tensors, ready event). On a
    CUDA device the copy runs on a side stream of its own and the event
    marks its end; on the CPU the copy is synchronous and the event None."""

    def __init__(self, device="cuda") -> None:
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def __call__(self, batch: Batch) -> tuple[Batch, torch.cuda.Event | None]:
        if self.stream is None:
            return tuple(t.to(self.device) for t in batch), None
        with torch.cuda.stream(self.stream):
            out = tuple(t.to(self.device, non_blocking=True) for t in batch)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return out, ready


def prefetch_to_device(batches: Iterable[Batch], size: int = 2,
                       place: Callable[[Batch], tuple[Batch, object]] | None = None
                       ) -> Iterator[Batch]:
    """Yield each of `batches` on the device, `size` copies ahead of the
    consumer. `place(batch) -> (device batch, ready event or None)`
    (default: `CopyToDevice("cuda")`). Before a batch is yielded, the
    current stream waits on its event and each tensor is recorded on that
    stream."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    put = place if place is not None else CopyToDevice("cuda")
    queue: deque = deque()

    def ready(item) -> Batch:
        out, event = item
        if event is not None:
            stream = torch.cuda.current_stream(out[0].device)
            stream.wait_event(event)
            for t in out:
                t.record_stream(stream)
        return out

    for batch in batches:
        queue.append(put(batch))
        if len(queue) > size:
            yield ready(queue.popleft())
    while queue:
        yield ready(queue.popleft())
