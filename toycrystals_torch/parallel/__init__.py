"""The data axis of the port's parallelism: process groups, the data mesh,
FSDP2 placement (counterpart of toycrystals_tpu/parallel/). The model axes
(tensor, spatial, pipeline, expert) are not ported yet (ROADMAP.md queue 1,
module 5)."""

from toycrystals_torch.parallel.fsdp import (
    fsdp_coverage,
    fsdp_sharding,
    place_state,
    shard_params_fsdp,
)
from toycrystals_torch.parallel.mesh import (
    RowGenerator,
    allgather_rows,
    check_data_mesh,
    data_sharding,
    make_mesh,
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
    "allgather_rows",
    "check_data_mesh",
    "data_sharding",
    "fsdp_coverage",
    "fsdp_sharding",
    "global_batch",
    "is_primary",
    "launch",
    "make_mesh",
    "maybe_initialize",
    "place_state",
    "process_count",
    "replicate",
    "shard_batch",
    "shard_params_fsdp",
]
