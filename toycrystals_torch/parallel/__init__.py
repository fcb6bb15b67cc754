"""The port's parallelism (counterpart of toycrystals_tpu/parallel/): process
groups, the data mesh, FSDP2 placement, and the space axis of sampling and
serving (`spatial`, on a ("data", "space") mesh). Training under space and
the tensor, pipeline and expert axes are not ported yet (ROADMAP.md queue 1,
module 5)."""

from toycrystals_torch.parallel.fsdp import (
    fsdp_coverage,
    fsdp_sharding,
    place_state,
    shard_params_fsdp,
)
from toycrystals_torch.parallel.mesh import (
    RowGenerator,
    check_data_mesh,
    data_sharding,
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_batch,
)
from toycrystals_torch.parallel.multihost import (
    global_batch,
    is_primary,
    launch,
    maybe_initialize,
    process_count,
)

__all__ = [
    "RowGenerator",
    "check_data_mesh",
    "data_sharding",
    "fsdp_coverage",
    "fsdp_sharding",
    "global_batch",
    "is_primary",
    "launch",
    "make_mesh",
    "make_mesh_2d",
    "maybe_initialize",
    "place_state",
    "process_count",
    "replicate",
    "shard_batch",
    "shard_params_fsdp",
]
