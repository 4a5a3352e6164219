"""The (data, space) device mesh, its shardings and the batched and
sharded stereo-stream pipelines.

Every name of the JAX package's ``parallel`` exports. ``parallel.sgm_sharded``
(the row-band SGM over ``space``) is a module of its own, as in the JAX
package, not exported here.
"""

from stereo_vision_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPACE_AXIS,
    batch_rows_sharding,
    batch_sharding,
    create_mesh,
    host_cpu_mesh,
    replicated,
)
from stereo_vision_tpu_torch.parallel.streaming import (
    StereoStreamProcessor,
    batched_stereo_pipeline,
    make_sharded_pipeline,
)

__all__ = [
    "DATA_AXIS",
    "SPACE_AXIS",
    "create_mesh",
    "host_cpu_mesh",
    "batch_sharding",
    "batch_rows_sharding",
    "replicated",
    "batched_stereo_pipeline",
    "make_sharded_pipeline",
    "StereoStreamProcessor",
]
