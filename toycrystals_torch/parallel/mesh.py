"""The data mesh: a batch split by rows over the ranks of a process group.

Counterpart of toycrystals_tpu/parallel/mesh.py. A JAX mesh lays one
array's batch dim over N devices and GSPMD inserts the collectives; here the
mesh is a 1-D `torch.distributed.DeviceMesh` named ("data",) over N ranks,
each rank holds its own rows of every batch, and the gradient all-reduce
comes from DistributedDataParallel or FSDP2 (parallel/fsdp.py
`place_state`).

Global-batch semantics keep the numbers of the single-device run: every rank
draws the whole batch's randomness from the same generator and keeps its
rows [r B / N, (r + 1) B / N) (`row_generator`; the draws are
utils/rng.py's, re-exported here), as JAX's sharded draws do, so a sharded step differs from the unsharded one
only in the order of its reductions.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from toycrystals_torch.utils.rng import RowGenerator, rand, randint, randn  # noqa: F401

AXIS = "data"
DEFERRED = "ROADMAP.md queue 1, module 5: parallel axes"


def make_mesh(n: int | None = None, device_type: str = "cuda"):
    """The 1-D ("data",) mesh over all n ranks of the process group."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n is None else int(n)
    if not dist.is_initialized() or n != world:
        raise ValueError(f"a data mesh of {n} spans every rank of a process group; "
                         f"{'none is initialised' if not dist.is_initialized() else world}")
    return init_device_mesh(device_type, (n,), mesh_dim_names=(AXIS,))


def check_data_mesh(mesh) -> None:
    """Only the ("data",) axis is ported: any other axis raises."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if names != (AXIS,):
        raise NotImplementedError(f"a mesh with axes {names} is not ported yet ({DEFERRED}): "
                                  f"only the ('data',) axis is")


def mesh_size(mesh) -> int:
    return 1 if mesh is None else mesh.size()


def mesh_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank()


def data_sharding(mesh, n: int) -> slice:
    """The rows [r n / N, (r + 1) n / N) of a global batch of n that live on
    rank r of the N; mesh=None: all n."""
    size = mesh_size(mesh)
    if n % size:
        raise ValueError(f"batch size {n} not divisible by the mesh's {size} ranks")
    b = n // size
    return slice(mesh_rank(mesh) * b, (mesh_rank(mesh) + 1) * b)


def shard_batch(mesh, batch: Any) -> Any:
    """This rank's rows of every tensor or array in `batch` (a tensor, an
    array, or a tuple, list or dict of them); scalars pass through, and
    mesh=None is a passthrough."""
    if mesh is None:
        return batch
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return batch if batch.ndim == 0 else batch[data_sharding(mesh, batch.shape[0])]
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return batch


def replicate(mesh, tensors) -> None:
    """Broadcast every tensor of the iterable from the mesh's rank 0, in
    place, so that all ranks hold rank 0's values; mesh=None does nothing."""
    if mesh is None:
        return
    group = mesh.get_group()
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)


def allgather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of x, concatenated in rank order, on every rank:
    the counterpart of `process_allgather`. mesh=None returns x."""
    if mesh is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group())
    return torch.cat(parts, dim=0)


def all_reduce_sum(mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the mesh's ranks (a new tensor); mesh=None returns x."""
    if mesh is None:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group())
    return x


def row_generator(mesh, generator: torch.Generator, local_rows: int) -> RowGenerator:
    """The `RowGenerator` of this rank's `local_rows` rows of the global batch."""
    lo = mesh_rank(mesh) * int(local_rows)
    return RowGenerator(generator, lo, lo + int(local_rows), int(local_rows) * mesh_size(mesh))
