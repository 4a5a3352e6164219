"""The (data, space) device mesh and the batched stereo-stream pipelines.

The JAX package's sharding helpers (``host_cpu_mesh``, ``batch_sharding``,
``batch_rows_sharding``, ``replicated``) come with several cards.
"""

from stereo_vision_tpu_torch.parallel.mesh import DATA_AXIS, SPACE_AXIS, create_mesh
from stereo_vision_tpu_torch.parallel.streaming import (
    StereoStreamProcessor,
    batched_stereo_pipeline,
    make_sharded_pipeline,
)

__all__ = [
    "DATA_AXIS",
    "SPACE_AXIS",
    "create_mesh",
    "batched_stereo_pipeline",
    "make_sharded_pipeline",
    "StereoStreamProcessor",
]
