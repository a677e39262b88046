"""Device meshes, sharded steps and the multi-process runtime (data
parallel over objects; the model axis sharded on the 2-D mesh and the
ring)."""

from .distributed import (  # noqa: F401
    initialize_distributed,
    launch_local_cluster,
    shutdown_distributed,
)
from .io import (  # noqa: F401
    catalog_batches,
    catalog_from_process_shards,
    process_shard_bounds,
)
from .mesh import (  # noqa: F401
    Mesh,
    Sharded,
    check_mesh,
    make_mesh,
    make_mesh_2d,
    model_sharded_fit_predict_step,
    replicate,
    ring_fit_predict_step,
    shard_models,
    shard_objects,
    sharded_fit_predict_step,
    sharded_logprob,
    stacked_nz,
)
