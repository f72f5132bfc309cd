"""Structured Cartesian background grids for phi-FEM.

phi-FEM solves PDEs on a simple *background* mesh that does not fit the
physical boundary; every demo of the reference builds that mesh with
``dolfinx.mesh.create_rectangle`` (e.g. reference
``demo/weak-dirichlet/flower/main.py:46``).  This module replaces the whole
dolfinx mesh + topology stack the reference consumes (connectivity queries at
``src/phifem/mesh_scripts.py:149-159, 244-251, 306-315, 418-422``) with a
*structured* Cartesian grid on which every connectivity query is closed-form
index arithmetic.  Nothing ragged, nothing dynamic: all entity counts are
static functions of ``(nx, ny, cell_type)``, which is exactly what XLA wants.

Connectivity/geometry *tables* are host-side preprocessing: they are built
once in numpy (no XLA compiles, no device round-trips) and uploaded to the
device as constants.  Only the traced compute path (``map_to_physical``,
``cell_jacobians`` consumers) runs under jit.

Entity numbering (fixed, documented convention — this framework defines its
own canonical numbering, it does not reproduce dolfinx's):

* cells: a block ``(ix, iy)`` (``ix`` fastest) is one quadrilateral cell, or
  two triangles (``lower`` = 2*block, ``upper`` = 2*block+1).  The lower
  triangle is ``(v00, v10, v11)`` and the upper ``(v00, v11, v01)`` — i.e.
  the square is split along the "right" diagonal from the bottom-left to the
  top-right corner, matching dolfinx's default ``DiagonalType.right``.
* vertices: ``v(ix, iy) = iy*(nx+1) + ix`` with ``ix in [0, nx]``.
* facets: vertical facets first (``(nx+1)*ny``), then horizontal
  (``nx*(ny+1)``), then (triangles only) diagonal (``nx*ny``).

Facet orientation convention: each facet stores the two adjacent cells as
``(cell_minus, cell_plus)`` and a *base* unit normal pointing from
``cell_minus`` to ``cell_plus``: ``+x`` for vertical facets, ``+y`` for
horizontal, ``(-hy, hx)/l`` for diagonals (pointing from the lower into the
upper triangle).  A missing neighbour (domain boundary) is ``-1``.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from functools import cached_property
from typing import Tuple

import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

__all__ = ["CellType", "Grid"]


class CellType(str, enum.Enum):
    """Cell type of the background grid (reference supports the same two:
    ``mesh_scripts.py:320-329``)."""

    triangle = "triangle"
    quadrilateral = "quadrilateral"



def _const(x) -> Array:
    """Upload a host table as a device constant, escaping any active trace
    (cached_property tables may first be touched inside a jit trace; without
    this the cache would capture a tracer and leak it)."""
    import jax

    with jax.ensure_compile_time_eval():
        return jnp.asarray(x)

def _as_cell_type(cell_type) -> CellType:
    if isinstance(cell_type, CellType):
        return cell_type
    return CellType(str(cell_type))


def _x64() -> bool:
    from jax import config

    return bool(config.jax_enable_x64)


def _np_float():
    return np.float64 if _x64() else np.float32


@dataclasses.dataclass(frozen=True)
class Grid:
    """A uniform rectangular background grid on ``bbox`` with ``nx * ny``
    blocks.

    Hashable static metadata: instances can be closed over by ``jax.jit``
    functions; all array producers below are pure functions of the static
    fields with static shapes.
    """

    nx: int
    ny: int
    bbox: Tuple[Tuple[float, float], Tuple[float, float]] = ((0.0, 0.0), (1.0, 1.0))
    cell_type: CellType = CellType.triangle

    def __post_init__(self):
        object.__setattr__(self, "cell_type", _as_cell_type(self.cell_type))
        if self.nx < 1 or self.ny < 1:
            raise ValueError("Grid needs nx >= 1 and ny >= 1.")
        (x0, y0), (x1, y1) = self.bbox
        if not (x1 > x0 and y1 > y0):
            raise ValueError("bbox must be ((x0, y0), (x1, y1)) with x1 > x0, y1 > y0.")

    # ------------------------------------------------------------------ sizes
    @property
    def is_simplex(self) -> bool:
        return self.cell_type == CellType.triangle

    @property
    def cells_per_block(self) -> int:
        return 2 if self.is_simplex else 1

    @property
    def num_blocks(self) -> int:
        return self.nx * self.ny

    @property
    def num_cells(self) -> int:
        return self.cells_per_block * self.num_blocks

    @property
    def num_vertices(self) -> int:
        return (self.nx + 1) * (self.ny + 1)

    @property
    def num_vfacets(self) -> int:
        return (self.nx + 1) * self.ny

    @property
    def num_hfacets(self) -> int:
        return self.nx * (self.ny + 1)

    @property
    def num_dfacets(self) -> int:
        return self.nx * self.ny if self.is_simplex else 0

    @property
    def num_facets(self) -> int:
        return self.num_vfacets + self.num_hfacets + self.num_dfacets

    @property
    def num_vertices_per_cell(self) -> int:
        return 3 if self.is_simplex else 4

    @property
    def num_facets_per_cell(self) -> int:
        return 3 if self.is_simplex else 4

    # --------------------------------------------------------------- geometry
    @property
    def x0(self) -> float:
        return float(self.bbox[0][0])

    @property
    def y0(self) -> float:
        return float(self.bbox[0][1])

    @property
    def hx(self) -> float:
        return (float(self.bbox[1][0]) - float(self.bbox[0][0])) / self.nx

    @property
    def hy(self) -> float:
        return (float(self.bbox[1][1]) - float(self.bbox[0][1])) / self.ny

    @property
    def cell_volume(self) -> float:
        """Area of one cell (uniform across the grid)."""
        a = self.hx * self.hy
        return a / 2.0 if self.is_simplex else a

    @property
    def cell_diameter(self) -> float:
        """UFL ``CellDiameter`` analogue (largest vertex distance), uniform.

        Replaces ``ufl.CellDiameter(mesh)`` used by every reference scheme
        (e.g. ``demo/weak-dirichlet/flower/main.py:108``); on a right triangle
        or a rectangle this is the diagonal length.
        """
        return math.hypot(self.hx, self.hy)

    @property
    def diag_length(self) -> float:
        return math.hypot(self.hx, self.hy)

    def refine(self) -> "Grid":
        """Uniform refinement: halve h (replaces ``dfx.mesh.refine`` used by
        the interface-elasticity convergence loop,
        ``demo/interface-elasticity/main.py:389-390``)."""
        return Grid(self.nx * 2, self.ny * 2, self.bbox, self.cell_type)

    # --------------------------------------------- numpy index arithmetic
    def _block_ij_np(self, cells: np.ndarray):
        if self.is_simplex:
            block, which = cells // 2, cells % 2
        else:
            block, which = cells, np.zeros_like(cells)
        return block % self.nx, block // self.nx, which

    def _vid(self, ix, iy):
        return iy * (self.nx + 1) + ix

    def _vf(self, ix, iy):
        return iy * (self.nx + 1) + ix

    def _hf(self, ix, iy):
        return self.num_vfacets + iy * self.nx + ix

    def _df(self, ix, iy):
        return self.num_vfacets + self.num_hfacets + iy * self.nx + ix

    # ----------------------------------------------------- host-side tables
    @cached_property
    def vertex_coords_np(self) -> np.ndarray:
        ft = _np_float()
        ii = np.arange(self.num_vertices, dtype=np.int64)
        ix, iy = ii % (self.nx + 1), ii // (self.nx + 1)
        return np.stack(
            [self.x0 + ix.astype(ft) * ft(self.hx), self.y0 + iy.astype(ft) * ft(self.hy)],
            axis=-1,
        ).astype(ft)

    @cached_property
    def cell_vertices_np(self) -> np.ndarray:
        cells = np.arange(self.num_cells, dtype=np.int64)
        ix, iy, which = self._block_ij_np(cells)
        v00 = self._vid(ix, iy)
        v10 = self._vid(ix + 1, iy)
        v01 = self._vid(ix, iy + 1)
        v11 = self._vid(ix + 1, iy + 1)
        if self.is_simplex:
            lower = np.stack([v00, v10, v11], axis=-1)
            upper = np.stack([v00, v11, v01], axis=-1)
            return np.where(which[:, None] == 0, lower, upper).astype(np.int32)
        return np.stack([v00, v10, v01, v11], axis=-1).astype(np.int32)

    @cached_property
    def cell_orientations_np(self) -> np.ndarray:
        cells = np.arange(self.num_cells, dtype=np.int64)
        return (cells % 2 if self.is_simplex else np.zeros_like(cells)).astype(np.int32)

    @cached_property
    def cell_origins_np(self) -> np.ndarray:
        ft = _np_float()
        cells = np.arange(self.num_cells, dtype=np.int64)
        ix, iy, _ = self._block_ij_np(cells)
        return np.stack(
            [self.x0 + ix.astype(ft) * ft(self.hx), self.y0 + iy.astype(ft) * ft(self.hy)],
            axis=-1,
        ).astype(ft)

    @cached_property
    def c2f_np(self) -> np.ndarray:
        cells = np.arange(self.num_cells, dtype=np.int64)
        ix, iy, which = self._block_ij_np(cells)
        if self.is_simplex:
            lower = np.stack(
                [self._hf(ix, iy), self._vf(ix + 1, iy), self._df(ix, iy)], axis=-1
            )
            upper = np.stack(
                [self._df(ix, iy), self._hf(ix, iy + 1), self._vf(ix, iy)], axis=-1
            )
            return np.where(which[:, None] == 0, lower, upper).astype(np.int32)
        return np.stack(
            [self._vf(ix, iy), self._vf(ix + 1, iy), self._hf(ix, iy), self._hf(ix, iy + 1)],
            axis=-1,
        ).astype(np.int32)

    @cached_property
    def f2c_np(self) -> np.ndarray:
        nvf, nhf = self.num_vfacets, self.num_hfacets
        f = np.arange(nvf, dtype=np.int64)
        ix, iy = f % (self.nx + 1), f // (self.nx + 1)
        if self.is_simplex:
            left = 2 * (iy * self.nx + (ix - 1))  # lower tri owns the right edge
            right = 2 * (iy * self.nx + ix) + 1  # upper tri owns the left edge
        else:
            left = iy * self.nx + (ix - 1)
            right = iy * self.nx + ix
        vpairs = np.stack(
            [np.where(ix > 0, left, -1), np.where(ix < self.nx, right, -1)], axis=-1
        )

        f = np.arange(nhf, dtype=np.int64)
        ix, iy = f % self.nx, f // self.nx
        if self.is_simplex:
            below = 2 * ((iy - 1) * self.nx + ix) + 1  # upper tri owns the top edge
            above = 2 * (iy * self.nx + ix)  # lower tri owns the bottom edge
        else:
            below = (iy - 1) * self.nx + ix
            above = iy * self.nx + ix
        hpairs = np.stack(
            [np.where(iy > 0, below, -1), np.where(iy < self.ny, above, -1)], axis=-1
        )

        pairs = [vpairs, hpairs]
        if self.is_simplex:
            block = np.arange(self.num_dfacets, dtype=np.int64)
            pairs.append(np.stack([2 * block, 2 * block + 1], axis=-1))
        return np.concatenate(pairs, axis=0).astype(np.int32)

    @cached_property
    def facet_kind_np(self) -> np.ndarray:
        kinds = [
            np.zeros(self.num_vfacets, np.int32),
            np.ones(self.num_hfacets, np.int32),
        ]
        if self.is_simplex:
            kinds.append(np.full(self.num_dfacets, 2, np.int32))
        return np.concatenate(kinds)

    @cached_property
    def facet_base_normals_np(self) -> np.ndarray:
        ft = _np_float()
        normals = [
            np.tile(np.array([1.0, 0.0], ft), (self.num_vfacets, 1)),
            np.tile(np.array([0.0, 1.0], ft), (self.num_hfacets, 1)),
        ]
        if self.is_simplex:
            l = self.diag_length
            nd = np.array([-self.hy / l, self.hx / l], ft)
            normals.append(np.tile(nd, (self.num_dfacets, 1)))
        return np.concatenate(normals, axis=0).astype(ft)

    @cached_property
    def facet_lengths_np(self) -> np.ndarray:
        ft = _np_float()
        lens = [
            np.full(self.num_vfacets, self.hy, ft),
            np.full(self.num_hfacets, self.hx, ft),
        ]
        if self.is_simplex:
            lens.append(np.full(self.num_dfacets, self.diag_length, ft))
        return np.concatenate(lens)

    @cached_property
    def facet_endpoints_np(self) -> np.ndarray:
        """(num_facets, 2, 2): start/end coordinates.  Parametrization t in
        [0,1]: vertical bottom->top, horizontal left->right, diagonal
        v00->v11."""
        ft = _np_float()
        hx, hy = ft(self.hx), ft(self.hy)

        f = np.arange(self.num_vfacets, dtype=np.int64)
        ix, iy = f % (self.nx + 1), f // (self.nx + 1)
        x = self.x0 + ix.astype(ft) * hx
        y = self.y0 + iy.astype(ft) * hy
        segs = [np.stack([np.stack([x, y], -1), np.stack([x, y + hy], -1)], axis=1)]

        f = np.arange(self.num_hfacets, dtype=np.int64)
        ix, iy = f % self.nx, f // self.nx
        x = self.x0 + ix.astype(ft) * hx
        y = self.y0 + iy.astype(ft) * hy
        segs.append(np.stack([np.stack([x, y], -1), np.stack([x + hx, y], -1)], axis=1))

        if self.is_simplex:
            f = np.arange(self.num_dfacets, dtype=np.int64)
            ix, iy = f % self.nx, f // self.nx
            x = self.x0 + ix.astype(ft) * hx
            y = self.y0 + iy.astype(ft) * hy
            segs.append(
                np.stack([np.stack([x, y], -1), np.stack([x + hx, y + hy], -1)], axis=1)
            )
        return np.concatenate(segs, axis=0).astype(ft)

    @cached_property
    def boundary_facet_mask_np(self) -> np.ndarray:
        """Facets on the boundary of the background box (replaces
        ``dfx.mesh.locate_entities_boundary`` with an all-true predicate,
        reference ``mesh_scripts.py:430-432``)."""
        return np.any(self.f2c_np < 0, axis=1)

    def local_facet_index_np(self, cells: np.ndarray, facets: np.ndarray) -> np.ndarray:
        """For pairs (cell, facet) return the local index k with
        ``c2f[cell, k] == facet`` (used to emit dolfinx-style one-sided
        integration entity pairs, reference ``mesh_scripts.py:137-192``)."""
        rows = self.c2f_np[np.asarray(cells)]
        return np.argmax(rows == np.asarray(facets)[:, None], axis=1).astype(np.int32)

    # ----------------------------------------------------- device constants
    @cached_property
    def vertex_coords(self) -> Array:
        # device-generated from iotas: the lattice is an affine function
        # of the index, so no 164 MB host table is uploaded at 10M
        # vertices (matches vertex_coords_np bit-exactly: same ops/order)
        import jax

        ft = _np_float()
        with jax.ensure_compile_time_eval():
            xs = self.x0 + jnp.arange(self.nx + 1, dtype=ft) * ft(self.hx)
            ys = self.y0 + jnp.arange(self.ny + 1, dtype=ft) * ft(self.hy)
            X = jnp.broadcast_to(xs[None, :], (self.ny + 1, self.nx + 1))
            Y = jnp.broadcast_to(ys[:, None], (self.ny + 1, self.nx + 1))
            return jnp.stack([X, Y], axis=-1).reshape(-1, 2)

    @cached_property
    def cell_vertices(self) -> Array:
        return _const(self.cell_vertices_np)

    @cached_property
    def cell_orientations(self) -> Array:
        return _const(self.cell_orientations_np)

    @cached_property
    def cell_origins(self) -> Array:
        return _const(self.cell_origins_np)

    @cached_property
    def cell_vertex_coords(self) -> Array:
        return _const(self.vertex_coords_np[self.cell_vertices_np])

    @cached_property
    def cell_midpoints(self) -> Array:
        return _const(self.vertex_coords_np[self.cell_vertices_np].mean(axis=1))

    @cached_property
    def c2f(self) -> Array:
        return _const(self.c2f_np)

    @cached_property
    def f2c(self) -> Array:
        return _const(self.f2c_np)

    @cached_property
    def facet_kind(self) -> Array:
        return _const(self.facet_kind_np)

    @cached_property
    def facet_base_normals(self) -> Array:
        return _const(self.facet_base_normals_np)

    @cached_property
    def facet_lengths(self) -> Array:
        return _const(self.facet_lengths_np)

    @cached_property
    def facet_endpoints(self) -> Array:
        return _const(self.facet_endpoints_np)

    @cached_property
    def facet_midpoints(self) -> Array:
        return _const(self.facet_endpoints_np.mean(axis=1))

    @cached_property
    def boundary_facet_mask(self) -> Array:
        return _const(self.boundary_facet_mask_np)

    def local_facet_index(self, cells, facets) -> Array:
        return _const(
            self.local_facet_index_np(np.asarray(cells), np.asarray(facets))
        )

    # ------------------------------------------------------ traced mapping
    def orientation_of(self, cells: Array) -> Array:
        """Per-cell orientation, closed form on-device (no table upload)."""
        cells = jnp.asarray(cells)
        if self.is_simplex:
            return (cells % 2).astype(jnp.int32)
        return jnp.zeros(cells.shape, jnp.int32)

    def cell_vertex_coords_of(self, cells: Array) -> Array:
        """(len(cells), nv, 2) vertex coordinates, computed on-device from
        closed-form index arithmetic — NOT a gather from the materialized
        (num_cells, nv, 2) table (``cell_vertex_coords``), whose host build
        + upload is ~1 GB at 10M DoFs.  Traced (jit-safe)."""
        ft = jnp.float64 if _x64() else jnp.float32
        cells = jnp.asarray(cells)
        if self.is_simplex:
            block, which = cells // 2, cells % 2
        else:
            block, which = cells, jnp.zeros_like(cells)
        ix, iy = block % self.nx, block // self.nx
        # corner coords (same op order as vertex_coords_np for bit parity)
        def vc(jx, jy):
            return jnp.stack(
                [
                    self.x0 + jx.astype(ft) * ft(self.hx),
                    self.y0 + jy.astype(ft) * ft(self.hy),
                ],
                axis=-1,
            )

        v00, v10 = vc(ix, iy), vc(ix + 1, iy)
        v01, v11 = vc(ix, iy + 1), vc(ix + 1, iy + 1)
        if not self.is_simplex:
            return jnp.stack([v00, v10, v01, v11], axis=1)
        lower = jnp.stack([v00, v10, v11], axis=1)
        upper = jnp.stack([v00, v11, v01], axis=1)
        return jnp.where((which == 0)[:, None, None], lower, upper)

    def map_to_physical(self, cells: Array, ref_pts: Array) -> Array:
        """Map reference-cell points to physical space, batched over cells.

        ``ref_pts``: (npts, 2) on the reference square [0,1]^2 (quads) or the
        reference triangle conv{(0,0),(1,0),(0,1)} (triangles).  Returns
        (len(cells), npts, 2).  Traced (jit-safe) path.
        """
        ft = jnp.float64 if _x64() else jnp.float32
        ref_pts = jnp.asarray(ref_pts, ft)
        r, s = ref_pts[None, :, 0:1], ref_pts[None, :, 1:2]
        verts = self.cell_vertex_coords_of(cells)  # (nc, nv, 2)
        # barycentric / bilinear combination x = sum_k psi_k(X) p_k — the
        # same arithmetic FFCx-generated kernels use to push quadrature
        # points forward, so knife-edge level-set signs at mapped points
        # match the reference bit-for-bit wherever rounding allows.
        if not self.is_simplex:
            return (
                (1 - r) * (1 - s) * verts[:, 0, None, :]
                + r * (1 - s) * verts[:, 1, None, :]
                + (1 - r) * s * verts[:, 2, None, :]
                + r * s * verts[:, 3, None, :]
            )
        return (
            (1 - r - s) * verts[:, 0, None, :]
            + r * verts[:, 1, None, :]
            + s * verts[:, 2, None, :]
        )

    def cell_jacobians(self) -> Tuple[Array, Array]:
        """Per-orientation affine Jacobian J (2,2) and |det J|.

        Returns (J, detJ) with J of shape (num_orientations, 2, 2).  For this
        uniform grid the Jacobian only depends on the orientation, never on
        the cell — the hook XLA needs to turn assembly into batched matmuls.
        """
        ft = jnp.float64 if _x64() else jnp.float32
        hx, hy = self.hx, self.hy
        if not self.is_simplex:
            J = jnp.array([[[hx, 0.0], [0.0, hy]]], ft)
            return J, jnp.array([hx * hy], ft)
        # lower (v00,v10,v11): e1=(hx,0), e2=(hx,hy); upper (v00,v11,v01):
        # e1=(hx,hy), e2=(0,hy).  Columns of J are e1, e2.
        J = jnp.array(
            [[[hx, hx], [0.0, hy]], [[hx, 0.0], [hy, hy]]],
            ft,
        )
        det = jnp.abs(jnp.linalg.det(J))
        return J, det
