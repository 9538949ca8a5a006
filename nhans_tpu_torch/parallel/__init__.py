"""Several devices: process groups, the (data, model) mesh and the
model-axis sharding rules."""

from nhans_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    initialize_multihost,
    local_batch_size,
    make_mesh,
    process_shard,
    shard_batch,
)
