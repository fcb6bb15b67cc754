"""The data mesh, and the 2-D (data, space) mesh of parallel/spatial.py.

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

`make_mesh_2d(D, S)` lays the ranks out as a ("data", "space") mesh, "space"
varying fastest as in JAX's `make_mesh_2d`: rank d S + s holds rows
[d B / D, (d + 1) B / D) of the batch and rows [s H / S, (s + 1) H / S) of
the image height. The samplers, `sample_chunked`, inpainting, the service and
training (the step and epoch factories and `place_state`, under DDP over all
D S ranks, or HSDP under FSDP2) take it.

`make_mesh_tp(D, M)` lays them out as a ("data", "model") mesh, "model"
varying fastest as in JAX's `make_mesh_tp`: rank d M + m holds rows
[d B / D, (d + 1) B / D) of the batch and block m of every weight that
parallel/tensor.py shards. The model ranks of one data coordinate hold the
same rows and draw the same noise (`row_generator` reads the data rank).

`make_mesh_3d(D, S, M)` composes the two as JAX's `make_mesh_3d` does: a
("data", "space", "model") mesh, "model" varying fastest, then "space": rank
(d S + s) M + m holds rows [d B / D, (d + 1) B / D) of the batch, rows
[s H / S, (s + 1) H / S) of the image height and block m of every weight
that parallel/tensor.py shards. The model ranks of a (data, space)
coordinate hold the same rows; the D S ranks of a model coordinate hold the
same blocks, and they average a step's gradients and metrics together (the
flattened "data_space" sub-mesh, `DATA_SPACE`).

`make_mesh_pp(D, S)` and `make_mesh_ep(D, N)` lay them out as ("data",
"pipe") and ("data", "expert") meshes, the second axis varying fastest as in
JAX's `make_mesh_pp` / `make_mesh_ep`: rank d S + s runs stage s of the
prior's blocks on rows [d B / D, (d + 1) B / D) (parallel/pipeline.py), rank
d N + e holds expert block e of the MoE prior (parallel/expert.py). The pipe
and expert ranks of one data coordinate hold the same rows and draw the same
noise, as the model axis's do.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from toycrystals_torch.utils.rng import RowGenerator, rand, randint, randn  # noqa: F401

AXIS = "data"
SPACE = "space"
MODEL = "model"
PIPE = "pipe"
EXPERT = "expert"
DATA_SPACE = "data_space"  # the D S ranks of a 3-D mesh's model coordinate
UNOFFERED = "JAX's CLIs offer no such mesh"


def make_mesh(n: int | None = None, device_type: str = "cuda"):
    """The 1-D ("data",) mesh over all n ranks of the process group."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n is None else int(n)
    if not dist.is_initialized() or n != world:
        raise ValueError(f"a data mesh of {n} spans every rank of a process group; "
                         f"{'none is initialised' if not dist.is_initialized() else world}")
    return init_device_mesh(device_type, (n,), mesh_dim_names=(AXIS,))


def make_mesh_2d(n_data: int, n_space: int, device_type: str = "cuda"):
    """The ("data", "space") mesh over all n_data * n_space ranks of the
    process group, "space" varying fastest (H-neighbours are adjacent ranks)."""
    from torch.distributed.device_mesh import init_device_mesh

    need = int(n_data) * int(n_space)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() or need != world:
        raise ValueError(f"asked for {need} devices, have {world} (a (data, space) mesh of "
                         f"{n_data} x {n_space} spans every rank of a process group)")
    return init_device_mesh(device_type, (int(n_data), int(n_space)),
                            mesh_dim_names=(AXIS, SPACE))


def _make_mesh_2(n_data: int, n: int, axis: str, device_type: str):
    """The ("data", `axis`) mesh over all n_data * n ranks of the process
    group, `axis` varying fastest."""
    from torch.distributed.device_mesh import init_device_mesh

    need = int(n_data) * int(n)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() or need != world:
        raise ValueError(f"asked for {need} devices, have {world} (a (data, {axis}) mesh of "
                         f"{n_data} x {n} spans every rank of a process group)")
    return init_device_mesh(device_type, (int(n_data), int(n)), mesh_dim_names=(AXIS, axis))


def make_mesh_tp(n_data: int, n_model: int, device_type: str = "cuda"):
    """The ("data", "model") mesh over all n_data * n_model ranks of the
    process group, "model" varying fastest (a weight's blocks sit on adjacent
    ranks; the gradient average over "data" is once per step)."""
    return _make_mesh_2(n_data, n_model, MODEL, device_type)


def make_mesh_pp(n_data: int, n_pipe: int, device_type: str = "cuda"):
    """The ("data", "pipe") mesh over all n_data * n_pipe ranks of the
    process group, "pipe" varying fastest (neighbouring stages are adjacent
    ranks, so each tick's hand-off is one hop)."""
    return _make_mesh_2(n_data, n_pipe, PIPE, device_type)


def make_mesh_ep(n_data: int, n_expert: int, device_type: str = "cuda"):
    """The ("data", "expert") mesh over all n_data * n_expert ranks of the
    process group, "expert" varying fastest (each block's combine sums over
    adjacent ranks; the gradient average over "data" is once per step)."""
    return _make_mesh_2(n_data, n_expert, EXPERT, device_type)


def make_mesh_3d(n_data: int, n_space: int, n_model: int, device_type: str = "cuda"):
    """The ("data", "space", "model") mesh over all n_data * n_space *
    n_model ranks of the process group, "model" varying fastest, then
    "space" (JAX's `make_mesh_3d`), with its "data" and "space" dims also
    flattened into the 1-D `DATA_SPACE` sub-mesh of each model coordinate
    (a collective: every rank calls it)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (int(n_data), int(n_space), int(n_model))
    need = shape[0] * shape[1] * shape[2]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() or need != world:
        raise ValueError(f"asked for {need} devices, have {world} (a (data, space, model) "
                         f"mesh of {' x '.join(map(str, shape))} spans every rank of a "
                         f"process group)")
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=(AXIS, SPACE, MODEL))
    # kept on the mesh: slicing a flattened dim from the root mesh is deprecated
    mesh.flat_data_space = mesh[AXIS, SPACE]._flatten(DATA_SPACE)
    return mesh


def mesh_axes(mesh) -> tuple[str, ...]:
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def check_data_mesh(mesh, space: bool = False, model: bool = False, pipe: bool = False,
                    expert: bool = False) -> None:
    """The meshes a caller takes, as JAX's CLIs build them: ("data",)
    always, ("data", "space") where `space` (the score model's sampling,
    serving and training), ("data", "model") where `model` (those, and the
    VAE's and the prior's training), the 3-D ("data", "space", "model")
    where both (the score model's), and ("data", "pipe") and ("data",
    "expert") where `pipe` and `expert` (the prior's step, epoch and
    placement). Any other mesh raises: JAX's CLIs build none for that
    caller (the VAE's and the prior's trainers take no --shard-space)."""
    names = mesh_axes(mesh)
    allowed = [(AXIS,)] + [(AXIS, a) for a, on in ((SPACE, space), (MODEL, model),
                                                   (PIPE, pipe), (EXPERT, expert)) if on]
    if space and model:
        allowed.append((AXIS, SPACE, MODEL))
    if names in allowed:
        return
    taken = [str(a) for a in allowed]
    raise NotImplementedError(f"a mesh with axes {names} is not taken here ({UNOFFERED} for "
                              f"this path): the meshes taken here are {', '.join(taken)}")


def axis_size(mesh, axis: str) -> int:
    """The size of `axis` in the mesh (1 where it has none, or for no mesh)."""
    return mesh.size(mesh_axes(mesh).index(axis)) if axis in mesh_axes(mesh) else 1


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along `axis` (0 where the mesh has none)."""
    return mesh.get_local_rank(axis) if axis in mesh_axes(mesh) else 0


def mesh_group(mesh):
    """The process group of every rank of the mesh (a 2-D `DeviceMesh` has no
    single group of its own: its ranks are the whole process group's)."""
    return mesh.get_group() if mesh.ndim == 1 else dist.group.WORLD


def axis_group(mesh, axis: str):
    """The process group of this rank's line along `axis`: on a ("data",
    "model") mesh, `axis_group(mesh, AXIS)` holds the ranks with this rank's
    block of every weight (its gradient average), `axis_group(mesh, MODEL)`
    the ranks that hold the blocks of this rank's rows; on a 3-D mesh
    `axis_group(mesh, DATA_SPACE)` holds the D S ranks with this rank's
    blocks, ordered by data rank, then space rank."""
    if axis == DATA_SPACE:
        return mesh.flat_data_space.get_group()
    return mesh.get_group(axis) if mesh.ndim > 1 else mesh.get_group()


def replica_group(mesh) -> tuple[object, int]:
    """(group, size) over which a step's metrics and gradients are averaged,
    and over which the parts of the images lie: every rank of the mesh,
    except that the model, pipe and expert ranks of a data coordinate hold
    the same rows and compute the same loss, so a ("data", "model"),
    ("data", "pipe") or ("data", "expert") mesh averages over "data" only,
    and a ("data", "space", "model") mesh over the D S ranks of the rank's
    model coordinate (`DATA_SPACE`)."""
    axes = set(mesh_axes(mesh))
    if {SPACE, MODEL} <= axes:
        return axis_group(mesh, DATA_SPACE), axis_size(mesh, AXIS) * axis_size(mesh, SPACE)
    if {MODEL, PIPE, EXPERT} & axes:
        return axis_group(mesh, AXIS), axis_size(mesh, AXIS)
    return mesh_group(mesh), mesh.size()


def mesh_size(mesh) -> int:
    """The ranks of the data axis (a batch splits over these)."""
    return 1 if mesh is None else axis_size(mesh, AXIS)


def mesh_rank(mesh) -> int:
    return 0 if mesh is None else axis_rank(mesh, AXIS)


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
    place, so that all ranks hold rank 0's values; mesh=None does nothing.
    A tensor whose bytes are all zero on rank 0 (a fresh state's Adam
    moments) is zeroed on every rank instead of sent: one flag per tensor
    travels, not its bytes."""
    if mesh is None:
        return
    tensors = [t.data for t in tensors]
    if not tensors:
        return
    group = mesh_group(mesh)
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        zero = torch.stack([t.reshape(-1).view(torch.uint8).any().eq(0).to(tensors[0].device)
                            for t in tensors]).to(torch.uint8)
        dist.broadcast(zero, src=src, group=group)
        for t, z in zip(tensors, zero.tolist()):
            if z:
                t.zero_()
            else:
                dist.broadcast(t, src=src, group=group)


def all_reduce_sum(mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the mesh's ranks (a new tensor); mesh=None returns x."""
    if mesh is None:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh_group(mesh))
    return x


def row_generator(mesh, generator: torch.Generator, local_rows: int,
                  local_height: int | None = None) -> RowGenerator:
    """The `RowGenerator` of this rank's `local_rows` rows of the global batch
    and, on a mesh with a space axis, of its `local_height` rows of the image
    height (4-D draws: images [b, h, W, C])."""
    lo = mesh_rank(mesh) * int(local_rows)
    hs = ()
    n_space = axis_size(mesh, SPACE)
    if n_space > 1 and local_height is not None:
        h = int(local_height)
        h_lo = axis_rank(mesh, SPACE) * h
        hs = (h_lo, h_lo + h, h * n_space)
    return RowGenerator(generator, lo, lo + int(local_rows), int(local_rows) * mesh_size(mesh),
                        *hs)
