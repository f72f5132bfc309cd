"""Function spaces, DoF maps, functions and interpolation on structured grids.

Replaces the dolfinx ``functionspace`` / ``Function`` / ``interpolate``
machinery the reference consumes (``dfx.fem.functionspace`` +
``Function.interpolate`` at e.g. reference
``demo/weak-dirichlet/flower/main.py:50-100``, mixed spaces at
``demo/neumann/square/main.py:74-82``).

Design:

* A scalar Lagrange space of degree k on the structured grid numbers DoFs
  vertices first, then (k-1) nodes per facet, then interior nodes per cell —
  all closed-form index arithmetic, so the cell->dof gather map is computed
  vectorized (no host loops over cells).
* Vector/tensor spaces share the scalar DoF map; components are trailing
  axes of the coefficient array (block layout, never interleaved — keeps
  gathers contiguous and XLA-friendly).
* Mixed spaces are *tuples* of spaces; mixed coefficient "vectors" are
  pytrees (lists of per-field arrays).  Solvers operate on pytrees, which is
  the JAX-native replacement for dolfinx's block DoF maps.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Callable, Sequence, Tuple, Union

import jax.numpy as jnp
import numpy as np

from .elements import Element, classify_nodes, dg0_element, lagrange_element
from .grid import CellType, Grid

Array = jnp.ndarray

__all__ = ["Space", "Function", "interpolate"]


def _float_dtype():
    from jax import config

    return jnp.float64 if config.jax_enable_x64 else jnp.float32


@dataclasses.dataclass(frozen=True)
class Space:
    """A (possibly vector/tensor-valued) Lagrange or DG0 space."""

    grid: Grid
    element: Element
    value_shape: Tuple[int, ...] = ()

    @staticmethod
    def lagrange(grid: Grid, degree: int, value_shape: Tuple[int, ...] = ()) -> "Space":
        return Space(grid, lagrange_element(grid.cell_type.value, degree), value_shape)

    @staticmethod
    def dg0(grid: Grid, value_shape: Tuple[int, ...] = ()) -> "Space":
        return Space(grid, dg0_element(grid.cell_type.value), value_shape)

    # ------------------------------------------------------------------ sizes
    @property
    def degree(self) -> int:
        return self.element.degree

    @property
    def nloc(self) -> int:
        return self.element.nloc

    @property
    def value_size(self) -> int:
        return int(np.prod(self.value_shape)) if self.value_shape else 1

    @property
    def num_scalar_dofs(self) -> int:
        g, k = self.grid, self.degree
        if self.element.family == "DG":
            return g.num_cells
        n_int = {
            "triangle": (k - 1) * (k - 2) // 2,
            "quadrilateral": (k - 1) ** 2,
        }[self.element.cell]
        return g.num_vertices + g.num_facets * (k - 1) + g.num_cells * n_int

    @property
    def num_dofs(self) -> int:
        """Total DoFs including value components (dolfinx index-map analogue)."""
        return self.num_scalar_dofs * self.value_size

    @property
    def dof_shape(self) -> Tuple[int, ...]:
        return (self.num_scalar_dofs,) + tuple(self.value_shape)

    # --------------------------------------------------------------- dof maps
    @cached_property
    def cell_dofs_np(self) -> np.ndarray:
        """(num_cells, nloc) int32 global scalar-DoF ids per local node.

        Host-side numpy (preprocessing — no device compiles).  Edge nodes
        are oriented along the *global* facet parametrization so that
        neighbouring cells agree; the only direction flip on this grid is
        the upper triangle's top edge (local facet 1), whose local direction
        p1->p2 runs right-to-left against the global horizontal
        left-to-right convention.
        """
        g, k = self.grid, self.degree
        if self.element.family == "DG":
            return np.arange(g.num_cells, dtype=np.int32)[:, None]

        kind, entity, param = classify_nodes(self.element)
        nV = g.num_vertices
        edge_base = nV
        cell_base = nV + g.num_facets * (k - 1)
        n_int = int(np.sum(kind == 2))

        cols = []
        cells = np.arange(g.num_cells, dtype=np.int64)
        orient = g.cell_orientations_np
        cv = g.cell_vertices_np
        c2f = g.c2f_np
        for m in range(self.nloc):
            if kind[m] == 0:
                col = cv[:, int(entity[m])]
            elif kind[m] == 1:
                lf = int(entity[m])
                t = float(param[m])
                facet = c2f[:, lf]
                # node index along the facet in *local* direction
                idx_local = int(round(t * k)) - 1
                idx_rev = (k - 1) - 1 - idx_local
                if g.is_simplex and lf == 1:
                    # upper triangles reverse local facet 1 (top edge)
                    idx = np.where(orient == 1, idx_rev, idx_local)
                else:
                    idx = np.full_like(cells, idx_local)
                col = edge_base + facet * (k - 1) + idx
            else:
                col = cell_base + cells * n_int + int(entity[m])
            cols.append(col.astype(np.int32))
        return np.stack(cols, axis=-1)

    @cached_property
    def cell_dofs(self) -> Array:
        from .grid import _const

        return _const(self.cell_dofs_np)

    @cached_property
    def dof_coords_np(self) -> np.ndarray:
        """(num_scalar_dofs, 2) physical coordinates of scalar DoFs."""
        g, k = self.grid, self.degree
        if self.element.family == "DG":
            return g.vertex_coords_np[g.cell_vertices_np].mean(axis=1)
        coords = [g.vertex_coords_np]
        if k > 1:
            ends = g.facet_endpoints_np  # (nf, 2, 2)
            ts = np.asarray([(m + 1) / k for m in range(k - 1)])
            fac = (
                ends[:, None, 0, :] * (1 - ts)[None, :, None]
                + ends[:, None, 1, :] * ts[None, :, None]
            )
            coords.append(fac.reshape(-1, 2))
            kind, entity, _ = classify_nodes(self.element)
            int_nodes = self.element.nodes[kind == 2]
            if len(int_nodes):
                # physical positions of cell-interior lattice nodes
                verts = g.vertex_coords_np[g.cell_vertices_np]  # (nc, nv, 2)
                if g.is_simplex:
                    p0 = verts[:, 0, :]
                    e1 = verts[:, 1, :] - p0
                    e2 = verts[:, 2, :] - p0
                    pts = (
                        p0[:, None, :]
                        + int_nodes[None, :, 0:1] * e1[:, None, :]
                        + int_nodes[None, :, 1:2] * e2[:, None, :]
                    )
                else:
                    scale = np.array([g.hx, g.hy])
                    pts = g.cell_origins_np[:, None, :] + int_nodes[None] * scale
                coords.append(pts.reshape(-1, 2))
        return np.concatenate(coords, axis=0)

    @cached_property
    def dof_coords(self) -> Array:
        if self.element.family == "Lagrange" and self.degree == 1:
            # P1 scalar DoFs ARE the vertices — reuse the device-generated
            # lattice (no 10M-row host->device upload, see Grid.vertex_coords)
            return self.grid.vertex_coords
        from .grid import _const

        return _const(self.dof_coords_np)

    # --------------------------------------------------- jnp basis evaluation
    def _basis_jnp(self, ref_pts: Array, deriv: int = 0) -> Array:
        """Evaluate basis (or ref-gradient) at traced reference points.

        deriv=0 -> (npts, nloc); deriv=1 -> (npts, nloc, 2).
        Monomial evaluation with static exponents — jit/vmap friendly.
        """
        e = self.element
        exps = np.asarray(e._exps)
        coeffs = jnp.asarray(e._coeffs, _float_dtype())
        r, s = ref_pts[..., 0:1], ref_pts[..., 1:2]
        kmax = int(exps.max())

        def powers(base):  # (..., 1) -> (..., kmax+1); base**0 := 1 exactly
            cols = [jnp.ones_like(base)]
            for _ in range(kmax):
                cols.append(cols[-1] * base)
            return jnp.concatenate(cols, axis=-1)

        rpow, spow = powers(r), powers(s)

        def mono(dr, ds):
            ci = np.ones(len(exps))
            ei = exps[:, 0].astype(np.int64).copy()
            for _ in range(dr):
                ci, ei = ci * ei, np.maximum(ei - 1, 0)
            cj = np.ones(len(exps))
            ej = exps[:, 1].astype(np.int64).copy()
            for _ in range(ds):
                cj, ej = cj * ej, np.maximum(ej - 1, 0)
            coef = jnp.asarray(ci * cj, _float_dtype())
            return coef * rpow[..., ei] * spow[..., ej]

        if deriv == 0:
            return mono(0, 0) @ coeffs
        gr = mono(1, 0) @ coeffs
        gs = mono(0, 1) @ coeffs
        return jnp.stack([gr, gs], axis=-1)

    def locate(self, pts: Array) -> Tuple[Array, Array]:
        """Point location on the structured grid: points -> (cell, ref_pt).

        Replaces dolfinx's bounding-box-tree point location; closed form here.
        """
        g = self.grid
        x = (pts[..., 0] - g.x0) / g.hx
        y = (pts[..., 1] - g.y0) / g.hy
        bx = jnp.clip(jnp.floor(x), 0, g.nx - 1).astype(jnp.int32)
        by = jnp.clip(jnp.floor(y), 0, g.ny - 1).astype(jnp.int32)
        r = x - bx
        s = y - by
        block = by * g.nx + bx
        if not g.is_simplex:
            return block, jnp.stack([r, s], axis=-1)
        lower = s <= r
        cell = jnp.where(lower, 2 * block, 2 * block + 1)
        ref = jnp.where(
            lower[..., None],
            jnp.stack([r - s, s], axis=-1),
            jnp.stack([r, s - r], axis=-1),
        )
        return cell, ref


def _wrap_values(space: Space, vals: Array, npts: int) -> Array:
    if space.value_shape:
        return jnp.reshape(vals, (npts,) + tuple(space.value_shape))
    return jnp.reshape(vals, (npts,))


@dataclasses.dataclass
class Function:
    """A discrete field: coefficients of shape ``space.dof_shape``.

    Replaces ``dolfinx.fem.Function`` (reference usage everywhere, e.g.
    ``demo/weak-dirichlet/flower/main.py:91-100``).
    """

    space: Space
    data: Array

    @staticmethod
    def zeros(space: Space) -> "Function":
        return Function(space, jnp.zeros(space.dof_shape, _float_dtype()))

    def copy(self) -> "Function":
        return Function(self.space, self.data)

    def eval(self, pts: Array) -> Array:
        """Evaluate at arbitrary physical points (n, 2)."""
        cells, ref = self.space.locate(pts)
        basis = self.space._basis_jnp(ref)  # (n, nloc)
        nodal = self.data[self.space.cell_dofs[cells]]  # (n, nloc, *vs)
        return jnp.einsum("nl,nl...->n...", basis, nodal)

    def eval_grad(self, pts: Array) -> Array:
        """Gradient at arbitrary physical points: (n, *value_shape, 2)."""
        cells, ref = self.space.locate(pts)
        gref = self.space._basis_jnp(ref, deriv=1)  # (n, nloc, 2)
        J, _ = self.space.grid.cell_jacobians()
        Jinv = jnp.linalg.inv(J)  # (norient, 2, 2)
        Jinv_c = Jinv[self.space.grid.orientation_of(cells)]
        gphys = jnp.einsum("nlr,nrx->nlx", gref, Jinv_c)
        nodal = self.data[self.space.cell_dofs[cells]]
        return jnp.einsum("nlx,nl...->n...x", gphys, nodal)


def locate_dofs(space: Space, predicate: Callable) -> Array:
    """Boolean mask over scalar DoFs where ``predicate(x: (n,2)) -> bool``
    holds at the DoF coordinate (replaces ``locate_dofs_topological`` /
    geometrical, reference ``demo/interface-elasticity/main.py:173-176``,
    N15)."""
    return jnp.asarray(predicate(space.dof_coords), bool)


def boundary_dof_mask(space: Space, tol: float = 1e-12) -> Array:
    """Mask of scalar DoFs on the background-box boundary."""
    g = space.grid
    (x0, y0), (x1, y1) = g.bbox

    def pred(x):
        return (
            (jnp.abs(x[:, 0] - x0) < tol)
            | (jnp.abs(x[:, 0] - x1) < tol)
            | (jnp.abs(x[:, 1] - y0) < tol)
            | (jnp.abs(x[:, 1] - y1) < tol)
        )

    return locate_dofs(space, pred)


def interpolate(
    f: Union[Callable, Function],
    space: Space,
) -> Function:
    """Interpolate a callable ``f(x: (n,2)) -> (n, *value_shape)`` or another
    :class:`Function` onto ``space`` (dolfinx ``Function.interpolate``
    analogue, reference ``demo/weak-dirichlet/flower/main.py:91-100`` and
    P1<->Pk transfers at ``demo/strong-dirichlet/flower/main.py:159-165``)."""
    coords = space.dof_coords
    if isinstance(f, Function):
        vals = f.eval(coords)
    else:
        vals = jnp.asarray(f(coords), _float_dtype())
        if space.value_shape and vals.shape[: len(space.value_shape)] == tuple(
            space.value_shape
        ):
            # tolerate reference-style (*value_shape, n) returns
            vals = jnp.moveaxis(vals, -1, 0)
    expected = (coords.shape[0],) + tuple(space.value_shape)
    vals = jnp.broadcast_to(vals, expected) if vals.shape != expected else vals
    return Function(space, vals)
