"""Data parallelism over several GPUs (the mesh, batch sharding, the
collectives of the training steps, process-group setup) and the layout
model's tensor parallelism over a data x model mesh, under the JAX
package's names (``ocrs_models_tpu/parallel``)."""

from .distributed import initialize_multihost, spawn
from .mesh import (
    Mesh,
    Mesh2D,
    all_reduce,
    create_mesh,
    create_mesh_2d,
    layout_tp_spec,
    pmean,
    psum,
    psum_differentiable,
    replicate_tree,
    shard_batch,
)
from .tp import gather_layout_state, shard_layout_model

__all__ = [
    "Mesh",
    "Mesh2D",
    "all_reduce",
    "create_mesh",
    "create_mesh_2d",
    "gather_layout_state",
    "initialize_multihost",
    "layout_tp_spec",
    "pmean",
    "psum",
    "psum_differentiable",
    "replicate_tree",
    "shard_batch",
    "shard_layout_model",
    "spawn",
]
