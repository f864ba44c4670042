"""Multi-device / multi-host parallelism (the reference's mpi.hpp, in JAX)."""

from .sharding import (
    make_ray_mesh,
    render_frame_sharded,
    render_frame_wavefront_sharded,
    training_step,
)
from .distributed import (
    init_multihost,
    make_global_mesh,
    local_shard_rows,
    measure_scaling,
)

__all__ = [
    "make_ray_mesh",
    "render_frame_sharded",
    "render_frame_wavefront_sharded",
    "training_step",
    "init_multihost",
    "make_global_mesh",
    "local_shard_rows",
    "measure_scaling",
]
