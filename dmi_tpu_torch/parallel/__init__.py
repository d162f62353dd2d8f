"""Parallelism layer: device meshes, sharding rules and the collectives of
tensor- and data-parallel serving and training (counterpart of
dmi_tpu/parallel/).

dmi_tpu lays a jax.sharding.Mesh over the chips and lets XLA insert the
psum and all-gather collectives.  The port runs one process a rank
(torch.distributed): each rank holds its shard of the weights
(shard_llm_params), slices its rows of a batch (shard_batch), and the model
code calls the collectives itself (collectives.Shard), differentiable
where training needs them.
"""

from dmi_tpu_torch.parallel.distributed import (
    batch_axes,
    init_distributed,
    launch_device,
    make_multihost_mesh,
    require_mesh,
)
from dmi_tpu_torch.parallel.mesh import make_mesh
from dmi_tpu_torch.parallel.sharding import (
    batch_sharding,
    replicate,
    shard_batch,
    shard_llm_params,
    shard_params,
)

__all__ = [
    "make_mesh",
    "init_distributed",
    "launch_device",
    "require_mesh",
    "make_multihost_mesh",
    "batch_axes",
    "batch_sharding",
    "replicate",
    "shard_batch",
    "shard_llm_params",
    "shard_params",
]
