"""The port's parallelism (counterpart of toycrystals_tpu/parallel/): process
groups, the data mesh, FSDP2 placement (HSDP on a space axis, 2-D weight
sharding on a model axis), the space axis (`spatial`, on a ("data",
"space") mesh), the "model" axis of the score model, the VAE and the priors
(`tensor`, on a ("data", "model") mesh), and the FiLM prior's pipeline
(`pipeline`, on a ("data", "pipe") mesh) and the MoE prior's experts over
ranks (`expert`, on a ("data", "expert") mesh), and JAX's 3-D ("data",
"space", "model") mesh of the score model, which composes the space and
model axes."""

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
    make_mesh_3d,
    make_mesh_ep,
    make_mesh_pp,
    make_mesh_tp,
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
    "make_mesh_3d",
    "make_mesh_ep",
    "make_mesh_pp",
    "make_mesh_tp",
    "maybe_initialize",
    "place_state",
    "process_count",
    "replicate",
    "shard_batch",
    "shard_params_fsdp",
]
