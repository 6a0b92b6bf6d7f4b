"""Data parallelism over several GPUs: the mesh, batch sharding, the
collectives of the training steps and process-group setup, under the JAX
package's names (``ocrs_models_tpu/parallel``)."""

from .distributed import initialize_multihost, spawn
from .mesh import (
    Mesh,
    all_reduce,
    create_mesh,
    pmean,
    psum,
    psum_differentiable,
    replicate_tree,
    shard_batch,
)

__all__ = [
    "Mesh",
    "all_reduce",
    "create_mesh",
    "initialize_multihost",
    "pmean",
    "psum",
    "psum_differentiable",
    "replicate_tree",
    "shard_batch",
    "spawn",
]
