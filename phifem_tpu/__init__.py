"""phifem_tpu — a phi-FEM (immersed-boundary FEM) framework in JAX.

Re-design of the capabilities of the reference PhiFEM/phiFEM package
(pure-Python layer over dolfinx/PETSc) as a standalone JAX/XLA stack:
structured background grids, vectorized level-set tagging, autodiff element
kernels, matrix-free preconditioned Krylov solvers, and SPMD sharding over
device meshes.

Double precision is enabled by default (the reference runs float64
throughout via PETSc); set ``PHIFEM_X64=0`` before import to stay in
float32.

The persistent XLA compilation cache lives where
``JAX_COMPILATION_CACHE_DIR`` says when it is set, and otherwise in
``.jax_cache`` at the root of the checkout.
"""

import os as _os

from jax import config as _config

if _os.environ.get("PHIFEM_X64", "1") == "1":
    _config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: assembly/solver programs are identical
# across runs, so cold-start cost collapses after the first run.  JAX reads
# JAX_COMPILATION_CACHE_DIR itself; the fallback path is fixed because the
# directory is part of what a later run must find again.
_cache_dir = _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)
_config.update("jax_compilation_cache_dir", _cache_dir)
_config.update("jax_persistent_cache_min_entry_size_bytes", -1)
_config.update("jax_persistent_cache_min_compile_time_secs", 0.1)

from .grid import CellType, Grid
from .grid3 import Grid3
from .elements import dg0_element, lagrange_element
from .spaces import Function, Space, interpolate
from .tagging import EntityTags, TagsMeasures, compute_tags_measures, tag_cells, tag_facets
from .measures import BoundaryMeasure, FacetSideList
from .umesh import UDiscreteLevelset, UMesh, USideList, USubmesh
from .umesh3 import UDiscreteLevelset3, UMesh3
from .uassembly import UFunction, USpace
from .uassembly import interpolate as interpolate_u

__version__ = "0.1.0"

__all__ = [
    "CellType",
    "Grid",
    "Grid3",
    "Space",
    "Function",
    "interpolate",
    "EntityTags",
    "TagsMeasures",
    "compute_tags_measures",
    "tag_cells",
    "tag_facets",
    "BoundaryMeasure",
    "FacetSideList",
    "UMesh",
    "UMesh3",
    "UDiscreteLevelset3",
    "UDiscreteLevelset",
    "USideList",
    "USubmesh",
    "USpace",
    "UFunction",
    "interpolate_u",
    "lagrange_element",
    "dg0_element",
]
