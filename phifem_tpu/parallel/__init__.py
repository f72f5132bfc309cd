"""SPMD parallelism over device meshes (replaces the reference's MPI layer).

The reference inherits MPI domain decomposition from dolfinx (every mesh on
``MPI.COMM_WORLD``, collective assembly/solve; SURVEY.md section 2c) and its
own tagging is not yet parallel-safe (``mesh_scripts.py:264``,
``ROADMAP.md:9``).  Here distribution is first-class and single-program:
DoF vectors and entity batches are sharded over a ``jax.sharding.Mesh`` and
XLA inserts the collectives (psum for CG dot products, halo exchanges for
the gathers) over ICI/DCN.
"""

from .halo import HaloOperator, UnsupportedFieldError, halo_solve
from .lattice import ShardedLatticeMG, build_sharded_lattice_mg, sharded_lattice_solve
from .lattice3 import (
    ShardedLattice3MG,
    build_sharded_lattice3_mg,
    sharded_lattice3_solve,
)
from .sharding import (
    make_mesh,
    shard_vector,
    sharded_matvec_fn,
    sharded_solve,
)
from .uop import (
    ElementShardedOperator,
    PartitionedUOperator,
    element_sharded_solve,
    partitioned_solve,
)

__all__ = [
    "HaloOperator",
    "ShardedLatticeMG",
    "build_sharded_lattice_mg",
    "sharded_lattice_solve",
    "ShardedLattice3MG",
    "build_sharded_lattice3_mg",
    "sharded_lattice3_solve",
    "UnsupportedFieldError",
    "ElementShardedOperator",
    "PartitionedUOperator",
    "element_sharded_solve",
    "partitioned_solve",
    "halo_solve",
    "make_mesh",
    "shard_vector",
    "sharded_matvec_fn",
    "sharded_solve",
]
