"""Structured 3D hexahedral background grid (z-axis extension).

The reference framework is 2D-only (`/root/reference/src/phifem/
mesh_scripts.py` classifies triangle/quadrilateral meshes exclusively);
this module extends the implicit-structured-grid design of
:mod:`phifem_tpu.grid` to 3D boxes of Q1 hex cells.  All connectivity is
closed-form index arithmetic; vertex coordinates are generated ON DEVICE
from iotas (tables are never built on the host nor uploaded).

Vertex raveling: ``index = (z * (ny+1) + y) * (nx+1) + x`` — the
``(nz+1, ny+1, nx+1)`` lattice, x fastest (matches
:mod:`phifem_tpu.ops.lattice3`).  Cell raveling likewise with cell counts.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class Grid3:
    """``nx x ny x nz`` hexahedral cells over an axis-aligned box."""

    nx: int
    ny: int
    nz: int
    bbox: Tuple[Tuple[float, float, float], Tuple[float, float, float]] = (
        (0.0, 0.0, 0.0),
        (1.0, 1.0, 1.0),
    )

    @property
    def spacing(self) -> Tuple[float, float, float]:
        (x0, y0, z0), (x1, y1, z1) = self.bbox
        return (
            (x1 - x0) / self.nx,
            (y1 - y0) / self.ny,
            (z1 - z0) / self.nz,
        )

    @property
    def lattice_shape(self) -> Tuple[int, int, int]:
        return (self.nz + 1, self.ny + 1, self.nx + 1)

    @property
    def num_vertices(self) -> int:
        return (self.nx + 1) * (self.ny + 1) * (self.nz + 1)

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny * self.nz

    def vertex_coords_lattice(self, dtype=jnp.float64) -> Tuple[Array, Array, Array]:
        """Per-axis coordinate lattices (broadcastable (D, R, C) iotas),
        generated on device — combine as needed without materializing an
        (N, 3) table."""
        (x0, y0, z0), _ = self.bbox
        hx, hy, hz = self.spacing
        D, R, C = self.lattice_shape
        z = z0 + hz * jnp.arange(D, dtype=dtype)[:, None, None]
        y = y0 + hy * jnp.arange(R, dtype=dtype)[None, :, None]
        x = x0 + hx * jnp.arange(C, dtype=dtype)[None, None, :]
        return x, y, z

    def eval_at_vertices(self, fn, dtype=jnp.float64) -> Array:
        """``fn((..., 3) coords) -> (...)`` evaluated on the full vertex
        lattice, returned in lattice shape (D, R, C)."""
        x, y, z = self.vertex_coords_lattice(dtype)
        D, R, C = self.lattice_shape
        pts = jnp.stack(
            [
                jnp.broadcast_to(x, (D, R, C)),
                jnp.broadcast_to(y, (D, R, C)),
                jnp.broadcast_to(z, (D, R, C)),
            ],
            axis=-1,
        )
        return fn(pts)

    def refine(self) -> "Grid3":
        return Grid3(2 * self.nx, 2 * self.ny, 2 * self.nz, self.bbox)

    def boundary_mask_lattice(self) -> np.ndarray:
        """(D, R, C) bool: True on the box-boundary shell (Dirichlet)."""
        D, R, C = self.lattice_shape
        m = np.zeros((D, R, C), bool)
        m[0], m[-1] = True, True
        m[:, 0], m[:, -1] = True, True
        m[:, :, 0], m[:, :, -1] = True, True
        return m
