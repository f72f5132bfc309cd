"""Stencil specialization of uniform P1 cell terms.

A geometry-uniform term (stiffness, mass) on a structured grid has ONE
element matrix per cell orientation; its matvec is then a fixed-coefficient
stencil on the vertex lattice with a per-cell region mask.  Instead of the
generic gather -> batched matmul -> scatter (index gathers from device
memory), this path is pure shifted elementwise arithmetic on (ny+1, nx+1)
lattices, which XLA fuses into bandwidth-bound loops; it is trivially
shardable as a halo-1 stencil.

For an nloc-node cell: y[v_i] += mask_cell * sum_j A[i,j] x[v_j], where
v_i are lattice offsets of the cell's local nodes, so the whole batch is
nloc^2 scaled shifted adds (quads: 16; triangles: 2 orientations x 9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import jax.numpy as jnp
import numpy as np

from ..grid import CellType, Grid

Array = jnp.ndarray

# local-node lattice offsets (dx, dy) matching Grid.cell_vertices order
_QUAD_OFFS = ((0, 0), (1, 0), (0, 1), (1, 1))  # v00, v10, v01, v11
_TRI_OFFS = (
    ((0, 0), (1, 0), (1, 1)),  # lower: v00, v10, v11
    ((0, 0), (1, 1), (0, 1)),  # upper: v00, v11, v01
)


@dataclasses.dataclass
class StencilCellBatch:
    """Drop-in Batch for a single-scalar-P1-field uniform cell term.

    ``masks is None`` means the term covers EVERY cell (the pure-Poisson /
    full-box case): the matvec then skips all mask reads — on a 10M-DoF
    lattice that halves the memory traffic.
    """

    grid: Grid
    field: str
    matrices: Array  # (norient, nloc, nloc)
    masks: Array | None  # (norient, ny, nx) region masks, or None == all-ones

    @staticmethod
    def build(grid: Grid, field: str, mats: Array, cell_tags, region) -> "StencilCellBatch":
        ny, nx = grid.ny, grid.nx
        if region is None:
            sel = np.ones(grid.num_cells, bool)
        else:
            sel = np.isin(np.asarray(cell_tags), np.asarray(region))
        if sel.all():
            return StencilCellBatch(grid, field, mats, None)
        if grid.is_simplex:
            masks = np.stack(
                [
                    sel[0::2].reshape(ny, nx).astype(np.float64),
                    sel[1::2].reshape(ny, nx).astype(np.float64),
                ]
            )
        else:
            masks = sel.reshape(1, ny, nx).astype(np.float64)
        return StencilCellBatch(grid, field, mats, jnp.asarray(masks))

    def masks_or_ones(self) -> np.ndarray:
        """Materialized region masks (for consumers that need them, e.g.
        the halo decomposition's sharded mask tables)."""
        if self.masks is not None:
            return np.asarray(self.masks)
        no = 2 if self.grid.is_simplex else 1
        return np.ones((no, self.grid.ny, self.grid.nx))

    def _offs(self, o: int):
        return _TRI_OFFS[o] if self.grid.is_simplex else _QUAD_OFFS

    def matvec_into(self, x: Dict[str, Array], y: Dict[str, Array]) -> Dict[str, Array]:
        g = self.grid
        ny, nx = g.ny, g.nx
        X = x[self.field].reshape(ny + 1, nx + 1)
        Y = y[self.field].reshape(ny + 1, nx + 1)
        for o in range(self.matrices.shape[0]):
            offs = self._offs(o)
            A = self.matrices[o]
            xl = [X[dy : dy + ny, dx : dx + nx] for (dx, dy) in offs]
            for i, (dxi, dyi) in enumerate(offs):
                zi = sum(A[i, j] * xl[j] for j in range(len(offs)))
                if self.masks is not None:
                    zi = self.masks[o] * zi
                Y = Y.at[dyi : dyi + ny, dxi : dxi + nx].add(zi)
        y[self.field] = Y.reshape(-1)
        return y

    def diagonal_into(self, d: Dict[str, Array]) -> Dict[str, Array]:
        g = self.grid
        ny, nx = g.ny, g.nx
        D = d[self.field].reshape(ny + 1, nx + 1)
        for o in range(self.matrices.shape[0]):
            offs = self._offs(o)
            A = self.matrices[o]
            M = 1.0 if self.masks is None else self.masks[o]
            for i, (dxi, dyi) in enumerate(offs):
                D = D.at[dyi : dyi + ny, dxi : dxi + nx].add(M * A[i, i])
        d[self.field] = D.reshape(-1)
        return d

    def add_dense_restricted(
        self, A: np.ndarray, offsets: Dict[str, int], idx_of: np.ndarray, m: int
    ) -> None:
        """Vectorized restricted dense accumulation (see Batch) — only cells
        whose mask is set and that touch a selected DoF contribute."""
        g = self.grid
        off = offsets[self.field]
        cv = np.asarray(g.cell_vertices_np)
        orient = np.asarray(g.cell_orientations_np)
        mats = np.asarray(self.matrices)
        if self.masks is None:
            active = np.ones(g.num_cells, bool)
        else:
            masks = np.asarray(self.masks).reshape(self.masks.shape[0], -1)
            block = np.arange(g.num_cells) // (2 if g.is_simplex else 1)
            active = masks[orient, block] > 0.0
        gidx = off + cv  # (nc, nloc) — scalar field
        l = idx_of[gidx]
        keep = active & (l >= 0).any(axis=1)
        if not keep.any():
            return
        l = np.where(l >= 0, l, m)[keep]
        np.add.at(A, (l[:, :, None], l[:, None, :]), mats[orient[keep]])

    def add_coo_restricted(
        self, triplets, offsets: Dict[str, int], idx_of: np.ndarray
    ) -> None:
        """Append restricted (row, col, val) triplets (see Batch)."""
        g = self.grid
        off = offsets[self.field]
        cv = np.asarray(g.cell_vertices_np)
        orient = np.asarray(g.cell_orientations_np)
        mats = np.asarray(self.matrices)
        if self.masks is None:
            active = np.ones(g.num_cells, bool)
        else:
            masks = np.asarray(self.masks).reshape(self.masks.shape[0], -1)
            block = np.arange(g.num_cells) // (2 if g.is_simplex else 1)
            active = masks[orient, block] > 0.0
        l = idx_of[off + cv]
        keep = active & (l >= 0).any(axis=1)
        if not keep.any():
            return
        l = l[keep]
        m = mats[orient[keep]]
        rows = np.broadcast_to(l[:, :, None], m.shape)
        cols = np.broadcast_to(l[:, None, :], m.shape)
        valid = (rows >= 0) & (cols >= 0)
        triplets[0].append(rows[valid])
        triplets[1].append(cols[valid])
        triplets[2].append(m[valid])

    def add_dense(self, A: np.ndarray, offsets: Dict[str, int]) -> None:
        g = self.grid
        off = offsets[self.field]
        cv = np.asarray(g.cell_vertices)
        orient = np.asarray(g.cell_orientations)
        masks = self.masks_or_ones()
        mats = np.asarray(self.matrices)
        ny, nx = g.ny, g.nx
        for c in range(g.num_cells):
            o = orient[c]
            block = c // (2 if g.is_simplex else 1)
            m = masks[o, block // nx, block % nx]
            if m == 0.0:
                continue
            gi = off + cv[c]
            np.add.at(A, (gi[:, None], gi[None, :]), mats[o])
