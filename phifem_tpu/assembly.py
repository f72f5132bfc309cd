"""Variational-form assembly as batched autodiff element kernels.

Replaces UFL + FFCx + dolfinx assembly (reference N6/N7/N8: forms at e.g.
``demo/weak-dirichlet/flower/main.py:112-151``, ``assemble_matrix`` /
``assemble_vector`` / ``assemble_scalar`` usage throughout the demos).

Design (no symbolic layer):

* A scheme *term* is a plain JAX integrand evaluated at one quadrature
  point: ``integrand(u, v, data, x, ctx) -> scalar`` where ``u``/``v`` map
  field names to :class:`FieldEval` (value / physical gradient / physical
  Hessian).  Because every phi-FEM form is bilinear in (trial, test), the
  exact element matrix is the (forward-over-reverse) Hessian of the local
  energy — ``jax.jacfwd(jax.grad(...))`` — vmapped over cells/facets.  JAX
  autodiff replaces UFL symbolic differentiation; XLA fuses the tiny fixed
  per-entity contractions into batched matmuls.
* Terms declare the entity set they act on via cell-tag / facet-tag regions
  (the ``dx(2)`` / ``dS((2,3))`` restrictions of the reference demos).
  Entity lists are frozen host-side after tagging, so assembled operators
  have fully static shapes.
* ``uniform=True`` terms (geometry-only integrands: stiffness, mass) store
  one element matrix per cell orientation instead of per cell — O(1) memory
  for the bulk of the operator.

The assembled operator is matrix-free: ``matvec`` gathers local DoFs,
applies batched dense element matrices, and scatter-adds — the structure a
Jacobi/Chebyshev-preconditioned Krylov solver consumes directly (replacing
PETSc/MUMPS, reference N9).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .grid import Grid
from .measures import FacetSideList
from .ops import HIGHEST
from .quadrature import cell_rule, segment_rule
from .spaces import Function, Space

Array = jnp.ndarray

__all__ = [
    "FieldEval",
    "System",
    "CellTerm",
    "FacetTerm",
    "BoundaryTerm",
    "assemble_operator",
    "assemble_vector",
    "assemble_scalar",
    "Operator",
]


def _float_dtype():
    from jax import config

    return jnp.float64 if config.jax_enable_x64 else jnp.float32


@dataclasses.dataclass
class FieldEval:
    """Point evaluation of a field: value, physical gradient, physical
    Hessian (shapes ``vs``, ``vs+(2,)``, ``vs+(2,2)``)."""

    val: Array
    grad: Array
    hess: Array

    @property
    def lap(self) -> Array:
        """Laplacian (trace of the Hessian) — ``div(grad(.))`` in the
        reference's stabilization terms."""
        return jnp.trace(self.hess, axis1=-2, axis2=-1)


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-term context passed to integrands."""

    h: float  # cell diameter (uniform on this grid; ufl.CellDiameter)


class System:
    """Ordered collection of named fields — the mixed-space analogue
    (reference ``basix.ufl.mixed_element``, N4).  Solution vectors are dicts
    ``{name: (ndofs_scalar, *value_shape)}`` (pytrees)."""

    def __init__(self, fields: Dict[str, Space]):
        self.fields: Dict[str, Space] = dict(fields)
        self.names: Tuple[str, ...] = tuple(self.fields.keys())

    def zeros(self) -> Dict[str, Array]:
        return {
            n: jnp.zeros(s.dof_shape, _float_dtype()) for n, s in self.fields.items()
        }

    @property
    def num_dofs(self) -> int:
        return sum(s.num_dofs for s in self.fields.values())

    def offsets(self) -> Dict[str, int]:
        off, cur = {}, 0
        for n, s in self.fields.items():
            off[n] = cur
            cur += s.num_dofs
        return off


# ------------------------------------------------------------------- terms
@dataclasses.dataclass(frozen=True)
class CellTerm:
    """``integrand(u, v, data, x, ctx) * dx(region)``; set ``v=None`` usage
    via assemble_vector/scalar (then integrand signature drops ``u``)."""

    integrand: Callable
    region: Optional[Tuple[int, ...]] = None  # cell tags; None = all cells
    degree: int = 4
    uniform: bool = False  # True: no data/x dependence -> per-orientation matrix


@dataclasses.dataclass(frozen=True)
class FacetTerm:
    """Interior-facet term ``integrand(u0, u1, v0, v1, data0, data1, x, n,
    ctx) * dS(region)``.  ``n`` points from side 0 to side 1 (side 0 is the
    UFL '+' restriction)."""

    integrand: Callable
    region: Tuple[int, ...] = (2, 3)
    npts: int = 3


@dataclasses.dataclass(frozen=True)
class BoundaryTerm:
    """One-sided facet term ``integrand(u, v, data, x, n, ctx) * ds`` over a
    :class:`FacetSideList` (box-mode ids 100/101 or submesh exterior).
    ``n`` is outward w.r.t. the chosen cell."""

    integrand: Callable
    facets: FacetSideList
    npts: int = 3


# ----------------------------------------------------------- tabulations
def _cell_tabs(space: Space, ref_pts: np.ndarray, grid: Grid):
    """Static basis tabulations at reference points: VAL (nq, nloc),
    GRAD (norient, nq, nloc, 2) physical, HESS (norient, nq, nloc, 2, 2)."""
    e = space.element
    val = e.tabulate(ref_pts)  # (nq, nloc)
    gref = e.tabulate_grad(ref_pts)  # (nq, nloc, 2)
    href = e.tabulate_hess(ref_pts)  # (nq, nloc, 2, 2)
    J, _ = grid.cell_jacobians()
    Jinv = np.linalg.inv(np.asarray(J))  # (no, 2, 2); d ref/d phys
    gphys = np.einsum("qlr,orx->oqlx", gref, Jinv)
    hphys = np.einsum("ory,qlrs,osx->oqlyx", Jinv, href, Jinv)
    ft = _float_dtype()
    return jnp.asarray(val, ft), jnp.asarray(gphys, ft), jnp.asarray(hphys, ft)


def _facet_ref_points(grid: Grid, t: np.ndarray) -> np.ndarray:
    """(norient, nfpc, nq, 2) reference coords of facet points, indexed by
    the *global* facet parameter t (flips baked in where the local edge runs
    against the global direction — only (upper tri, local facet 1))."""
    out = []
    for o in range(2 if grid.is_simplex else 1):
        rows = []
        nfpc = grid.num_facets_per_cell
        for k in range(nfpc):
            tt = t
            if grid.is_simplex and o == 1 and k == 1:
                tt = 1.0 - t
            z, on = np.zeros_like(tt), np.ones_like(tt)
            if grid.is_simplex:
                table = [
                    np.stack([tt, z], -1),  # p0->p1
                    np.stack([1.0 - tt, tt], -1),  # p1->p2
                    np.stack([z, tt], -1),  # p0->p2
                ]
            else:
                table = [
                    np.stack([z, tt], -1),  # left
                    np.stack([on, tt], -1),  # right
                    np.stack([tt, z], -1),  # bottom
                    np.stack([tt, on], -1),  # top
                ]
            rows.append(table[k])
        out.append(np.stack(rows))
    return np.stack(out)  # (no, nfpc, nq, 2)


def _facet_tabs(space: Space, grid: Grid, t: np.ndarray):
    """VAL (no, nfpc, nq, nloc), GRAD (no, nfpc, nq, nloc, 2) physical,
    HESS (no, nfpc, nq, nloc, 2, 2)."""
    refs = _facet_ref_points(grid, t)  # (no, nfpc, nq, 2)
    e = space.element
    no, nfpc, nq, _ = refs.shape
    flat = refs.reshape(-1, 2)
    val = e.tabulate(flat).reshape(no, nfpc, nq, e.nloc)
    gref = e.tabulate_grad(flat).reshape(no, nfpc, nq, e.nloc, 2)
    href = e.tabulate_hess(flat).reshape(no, nfpc, nq, e.nloc, 2, 2)
    J, _ = grid.cell_jacobians()
    Jinv = np.linalg.inv(np.asarray(J))
    gphys = np.einsum("ofqlr,orx->ofqlx", gref, Jinv)
    hphys = np.einsum("ory,ofqlrs,osx->ofqlyx", Jinv, href, Jinv)
    ft = _float_dtype()
    return jnp.asarray(val, ft), jnp.asarray(gphys, ft), jnp.asarray(hphys, ft)


# ------------------------------------------------------------- local layout
def _layout(system: System) -> List[Tuple[str, int, Tuple[int, ...], int]]:
    """[(field, nloc_scalar, value_shape, flat_len)] in system order."""
    out = []
    for n, s in system.fields.items():
        out.append((n, s.nloc, tuple(s.value_shape), s.nloc * s.value_size))
    return out


def _unpack(flat: Array, layout) -> Dict[str, Array]:
    out, cur = {}, 0
    for name, nloc, vs, ln in layout:
        out[name] = flat[cur : cur + ln].reshape((nloc,) + vs)
        cur += ln
    return out


def _eval_field(u_loc: Array, valq: Array, gradq: Array, hessq: Array) -> FieldEval:
    return FieldEval(
        val=jnp.einsum("l,l...->...", valq, u_loc),
        grad=jnp.einsum("lx,l...->...x", gradq, u_loc),
        hess=jnp.einsum("lxy,l...->...xy", hessq, u_loc),
    )


def _normalize_data(data: Optional[Dict]) -> Dict:
    return dict(data) if data else {}


# --------------------------------------------------------------- cell batch
def _cell_local_fn(system: System, term: CellTerm, grid: Grid, data: Dict):
    """Builds (local_fn, cell_data_fn, ntot).  ``local_fn(uflat, vflat, cd)``
    is the per-cell energy; ``cd`` carries orientation, quad coords and
    gathered data-field DoFs."""
    cellname = grid.cell_type.value
    ref_pts, wq = cell_rule(cellname, term.degree)
    _, detJ = grid.cell_jacobians()
    layout = _layout(system)
    ntot = sum(l[-1] for l in layout)
    tabs = {n: _cell_tabs(s, ref_pts, grid) for n, s in system.fields.items()}
    fn_data = {k: v for k, v in data.items() if isinstance(v, Function)}
    call_data = {k: v for k, v in data.items() if not isinstance(v, Function)}
    dtabs = {k: _cell_tabs(v.space, ref_pts, grid) for k, v in fn_data.items()}
    ctx = Ctx(h=grid.cell_diameter)
    wq_j = jnp.asarray(wq, _float_dtype())
    detJ_j = jnp.asarray(detJ, _float_dtype())

    def cell_static(cells: Array) -> Dict:
        """Data-INDEPENDENT per-cell tables: orientation, physical quad
        coords, gathered DoF indices and callable-data values.  Hoisted out
        of the jitted rebuild cores and evaluated eagerly at batch
        construction: staged under jit (omnistaging), these gathers bake
        the FULL (ncells, nloc) dof map / facet coordinate tables into the
        HLO as literals — ~1.3 GB at n=3200."""
        st = {
            "orient": grid.orientation_of(cells),
            "x": grid.map_to_physical(cells, ref_pts),
        }
        for k, f in fn_data.items():
            st["dofs_" + k] = f.space.cell_dofs[cells]
        for k, f in call_data.items():
            vals = f(st["x"].reshape(-1, 2))
            st["c_" + k] = jnp.reshape(vals, st["x"].shape[:2] + vals.shape[1:])
        return st

    def cell_data(cells: Array, arrays: Optional[Dict] = None,
                  static: Optional[Dict] = None) -> Dict:
        st = cell_static(cells) if static is None else static
        cd = {k: v for k, v in st.items() if not k.startswith("dofs_")}
        for k, f in fn_data.items():
            dat = arrays[k] if arrays is not None else f.data
            cd["d_" + k] = dat[st["dofs_" + k]]
        return cd

    cell_data.static = cell_static

    def local(uflat, vflat, cd):
        o = cd["orient"]
        u_locs = _unpack(uflat, layout) if uflat is not None else None
        v_locs = _unpack(vflat, layout)

        def at_point(q_tabs, q_dtabs, q_call, xpt, w):
            if u_locs is not None:
                u_ev = {
                    n: _eval_field(u_locs[n], *q_tabs[n]) for n in system.names
                }
            v_ev = {n: _eval_field(v_locs[n], *q_tabs[n]) for n in system.names}
            d_ev = {
                k: _eval_field(cd["d_" + k], *q_dtabs[k]) for k in fn_data
            }
            for k in call_data:
                d_ev[k] = FieldEval(q_call[k], None, None)
            if u_locs is not None:
                return w * term.integrand(u_ev, v_ev, d_ev, xpt, ctx)
            return w * term.integrand(v_ev, d_ev, xpt, ctx)

        q_tabs = {n: (t[0], t[1][o], t[2][o]) for n, t in tabs.items()}
        q_dtabs = {k: (t[0], t[1][o], t[2][o]) for k, t in dtabs.items()}
        q_call = {k: cd["c_" + k] for k in call_data}
        w_all = wq_j * detJ_j[o]
        contrib = jax.vmap(at_point)(q_tabs, q_dtabs, q_call, cd["x"], w_all)
        return jnp.sum(contrib)

    return local, cell_data, ntot, layout, fn_data


def _region_cells(grid: Grid, cell_tags, region) -> np.ndarray:
    if region is None:
        return np.arange(grid.num_cells, dtype=np.int32)
    tags = np.asarray(cell_tags)
    return np.where(np.isin(tags, np.asarray(region)))[0].astype(np.int32)


# -------------------------------------------------------------- facet batch
def _facet_local_fn(system: System, term, grid: Grid, data: Dict, one_sided: bool):
    tq, wq = segment_rule(term.npts)
    layout = _layout(system)
    n_one = sum(l[-1] for l in layout)
    ntot = n_one if one_sided else 2 * n_one
    tabs = {n: _facet_tabs(s, grid, tq) for n, s in system.fields.items()}
    fn_data = {k: v for k, v in data.items() if isinstance(v, Function)}
    call_data = {k: v for k, v in data.items() if not isinstance(v, Function)}
    dtabs = {k: _facet_tabs(v.space, grid, tq) for k, v in fn_data.items()}
    ctx = Ctx(h=grid.cell_diameter)
    wq_j = jnp.asarray(wq, _float_dtype())
    tq_j = jnp.asarray(tq, _float_dtype())

    def facet_static(facets: Array, cells_sides, locals_sides, normals) -> Dict:
        """Data-independent per-facet tables — see ``cell_static`` for why
        these are hoisted out of the jitted rebuild cores (full-grid
        ``facet_endpoints``/``facet_lengths``/dof-map literals in the HLO
        otherwise)."""
        ends = grid.facet_endpoints[facets]  # (ne, 2, 2)
        x = ends[:, None, 0, :] * (1 - tq_j)[None, :, None] + ends[
            :, None, 1, :
        ] * tq_j[None, :, None]
        st = {
            "x": x,
            "n": normals,
            "len": grid.facet_lengths[facets],
        }
        for s, (cells, locs) in enumerate(zip(cells_sides, locals_sides)):
            st[f"orient{s}"] = grid.orientation_of(cells)
            st[f"lf{s}"] = locs
            for k, f in fn_data.items():
                st[f"dofs{s}_" + k] = f.space.cell_dofs[cells]
        for k, f in call_data.items():
            vals = f(x.reshape(-1, 2))
            st["c_" + k] = jnp.reshape(vals, x.shape[:2] + vals.shape[1:])
        return st

    def facet_data(facets: Array = None, cells_sides=None, locals_sides=None,
                   normals=None, arrays: Optional[Dict] = None,
                   static: Optional[Dict] = None) -> Dict:
        st = (facet_static(facets, cells_sides, locals_sides, normals)
              if static is None else static)
        cd = {k: v for k, v in st.items() if not k.startswith("dofs")}
        for s in range(1 if one_sided else 2):
            for k, f in fn_data.items():
                dat = arrays[k] if arrays is not None else f.data
                cd[f"d{s}_" + k] = dat[st[f"dofs{s}_" + k]]
        return cd

    facet_data.static = facet_static

    def local(uflat, vflat, cd):
        has_u = uflat is not None
        nsides = 1 if one_sided else 2
        u_sides, v_sides, d_sides = [], [], []
        for s in range(nsides):
            o, k = cd[f"orient{s}"], cd[f"lf{s}"]
            sl = slice(s * n_one, (s + 1) * n_one)
            if has_u:
                u_sides.append(_unpack(uflat[sl], layout))
            v_sides.append(_unpack(vflat[sl], layout))
            d_sides.append(s)

        def at_point(q_idx_tabs, xpt, w):
            evs_u, evs_v, evs_d = [], [], []
            for s in range(nsides):
                o, k = cd[f"orient{s}"], cd[f"lf{s}"]
                u_ev = v_ev = None
                tq_tabs = {
                    n: (
                        q_idx_tabs[f"v{s}_" + n],
                        q_idx_tabs[f"g{s}_" + n],
                        q_idx_tabs[f"h{s}_" + n],
                    )
                    for n in system.names
                }
                if has_u:
                    evs_u.append(
                        {n: _eval_field(u_sides[s][n], *tq_tabs[n]) for n in system.names}
                    )
                evs_v.append(
                    {n: _eval_field(v_sides[s][n], *tq_tabs[n]) for n in system.names}
                )
                dd = {}
                for kk in fn_data:
                    dd[kk] = _eval_field(
                        cd[f"d{s}_" + kk],
                        q_idx_tabs[f"dv{s}_" + kk],
                        q_idx_tabs[f"dg{s}_" + kk],
                        q_idx_tabs[f"dh{s}_" + kk],
                    )
                for kk in call_data:
                    dd[kk] = FieldEval(q_idx_tabs["c_" + kk], None, None)
                evs_d.append(dd)
            n_vec = cd["n"]
            if one_sided:
                if has_u:
                    return w * term.integrand(
                        evs_u[0], evs_v[0], evs_d[0], xpt, n_vec, ctx
                    )
                return w * term.integrand(evs_v[0], evs_d[0], xpt, n_vec, ctx)
            if has_u:
                return w * term.integrand(
                    evs_u[0], evs_u[1], evs_v[0], evs_v[1], evs_d[0], evs_d[1],
                    xpt, n_vec, ctx,
                )
            return w * term.integrand(
                evs_v[0], evs_v[1], evs_d[0], evs_d[1], xpt, n_vec, ctx
            )

        # gather per-point tabulations for vmap: dict of (nq, ...) arrays
        q_idx_tabs = {}
        for s in range(nsides):
            o, k = cd[f"orient{s}"], cd[f"lf{s}"]
            for n, t in tabs.items():
                q_idx_tabs[f"v{s}_" + n] = t[0][o, k]
                q_idx_tabs[f"g{s}_" + n] = t[1][o, k]
                q_idx_tabs[f"h{s}_" + n] = t[2][o, k]
            for kk, t in dtabs.items():
                q_idx_tabs[f"dv{s}_" + kk] = t[0][o, k]
                q_idx_tabs[f"dg{s}_" + kk] = t[1][o, k]
                q_idx_tabs[f"dh{s}_" + kk] = t[2][o, k]
        for kk in call_data:
            q_idx_tabs["c_" + kk] = cd["c_" + kk]
        w_all = wq_j * cd["len"]
        contrib = jax.vmap(at_point, in_axes=(0, 0, 0))(q_idx_tabs, cd["x"], w_all)
        return jnp.sum(contrib)

    return local, facet_data, ntot, layout, fn_data


# ---------------------------------------------------------------- operator
@dataclasses.dataclass
class Batch:
    """One assembled entity batch of an operator."""

    segments: List[Tuple[str, Array, Tuple[int, ...]]]  # (field, dofs (ne, nloc), vshape)
    matrices: Array  # (ne, n, n) or (norient, n, n) if uniform
    orient: Optional[Array] = None  # (ne,) for uniform batches
    rebuild: Optional[Callable] = None  # () -> fresh matrices (data-dependent batches)
    rebuild_core: Optional[Callable] = None  # (arrays dict) -> matrices (jittable)
    rebuild_data: Optional[Dict] = None  # {name: Function} current data sources
    cells: Optional[np.ndarray] = None  # covered cell ids (uniform cell batches)

    def gather(self, x: Dict[str, Array]) -> Array:
        parts = []
        ne = self.segments[0][1].shape[0]
        for name, dofs, vs in self.segments:
            parts.append(x[name][dofs].reshape(ne, -1))
        return jnp.concatenate(parts, axis=1)

    def scatter_add(self, y: Dict[str, Array], y_loc: Array) -> Dict[str, Array]:
        cur = 0
        ne = y_loc.shape[0]
        for name, dofs, vs in self.segments:
            nloc = dofs.shape[1]
            vsz = int(np.prod(vs)) if vs else 1
            seg = y_loc[:, cur : cur + nloc * vsz].reshape((ne, nloc) + tuple(vs))
            y[name] = y[name].at[dofs].add(seg)
            cur += nloc * vsz
        return y

    def matvec_into(
        self, x: Dict[str, Array], y: Dict[str, Array], mats: Optional[Array] = None
    ) -> Dict[str, Array]:
        if mats is None:
            mats = self.matrices
        x_loc = self.gather(x)
        if self.orient is None:
            y_loc = jnp.einsum("eij,ej->ei", mats, x_loc, precision=HIGHEST)
        else:
            # uniform batch: one matrix per orientation — apply both and
            # select, never materializing per-entity matrices (O(1) memory)
            y_loc = jnp.matmul(x_loc, mats[0].T, precision=HIGHEST)
            for o in range(1, mats.shape[0]):
                y_loc = jnp.where(
                    (self.orient == o)[:, None],
                    jnp.matmul(x_loc, mats[o].T, precision=HIGHEST),
                    y_loc,
                )
        return self.scatter_add(y, y_loc)

    def diagonal_into(self, d: Dict[str, Array], mats: Optional[Array] = None) -> Dict[str, Array]:
        if mats is None:
            mats = self.matrices
        if self.orient is None:
            dloc = jnp.diagonal(mats, axis1=-2, axis2=-1)
        else:
            diags = jnp.diagonal(mats, axis1=-2, axis2=-1)  # (no, n)
            dloc = diags[self.orient]
        ne = self.segments[0][1].shape[0]
        dloc = jnp.broadcast_to(dloc, (ne, dloc.shape[-1]))
        return self.scatter_add(d, dloc)

    def entity_global_dofs(self, offsets: Dict[str, int]) -> np.ndarray:
        """(ne, L) global flat DoF ids per entity (system-offset layout)."""
        ne = self.segments[0][1].shape[0]
        gidx = []
        for name, dofs, vs in self.segments:
            vsz = int(np.prod(vs)) if vs else 1
            base = offsets[name] + np.asarray(dofs)[..., None] * vsz
            comp = np.arange(vsz)[None, None, :]
            gidx.append((base + comp).reshape(ne, -1))
        return np.concatenate(gidx, axis=1)

    def add_dense_restricted(
        self, A: np.ndarray, offsets: Dict[str, int], idx_of: np.ndarray, m: int
    ) -> None:
        """Accumulate this batch's entries into the (m+1, m+1) padded dense
        submatrix over selected flat DoFs (idx_of maps global flat id ->
        compact index, -1 = unselected -> padded slot m)."""
        gidx = self.entity_global_dofs(offsets)
        ne = gidx.shape[0]
        l = idx_of[gidx]
        keep = (l >= 0).any(axis=1)
        if not keep.any():
            return
        l = np.where(l >= 0, l, m)[keep]
        if self.orient is None:
            mats = np.asarray(self.matrices)
            mats = np.broadcast_to(mats, (ne,) + mats.shape[-2:])[keep]
        else:
            mats = np.asarray(self.matrices)[np.asarray(self.orient)[keep]]
        np.add.at(A, (l[:, :, None], l[:, None, :]), mats)

    def add_coo_restricted(
        self, triplets: Tuple[list, list, list], offsets: Dict[str, int], idx_of: np.ndarray
    ) -> None:
        """Append (row, col, val) triplets of this batch restricted to the
        selected DoFs (both endpoints selected) — the O(nnz) alternative to
        :meth:`add_dense_restricted` for large interface blocks."""
        gidx = self.entity_global_dofs(offsets)
        ne = gidx.shape[0]
        l = idx_of[gidx]
        keep = (l >= 0).any(axis=1)
        if not keep.any():
            return
        l = l[keep]
        if self.orient is None:
            mats = np.asarray(self.matrices)
            mats = np.broadcast_to(mats, (ne,) + mats.shape[-2:])[keep]
        else:
            mats = np.asarray(self.matrices)[np.asarray(self.orient)[keep]]
        rows = np.broadcast_to(l[:, :, None], mats.shape)
        cols = np.broadcast_to(l[:, None, :], mats.shape)
        valid = (rows >= 0) & (cols >= 0)
        triplets[0].append(rows[valid])
        triplets[1].append(cols[valid])
        triplets[2].append(np.asarray(mats)[valid])

    def add_dense(self, A: np.ndarray, offsets: Dict[str, int]) -> None:
        mats = np.asarray(
            self.matrices if self.orient is None else self.matrices[np.asarray(self.orient)]
        )
        ne = self.segments[0][1].shape[0]
        gidx = []
        for name, dofs, vs in self.segments:
            vsz = int(np.prod(vs)) if vs else 1
            base = offsets[name] + np.asarray(dofs)[..., None] * vsz
            comp = np.arange(vsz)[None, None, :]
            gidx.append((base + comp).reshape(ne, -1))
        gidx = np.concatenate(gidx, axis=1)
        # np.add.at accumulates duplicate indices (a facet batch's two cells
        # share DoFs; fancy-index += would drop those)
        np.add.at(
            A,
            (gidx[:, :, None], gidx[:, None, :]),
            np.broadcast_to(mats, (ne,) + mats.shape[-2:]),
        )


@dataclasses.dataclass
class Operator:
    """Matrix-free assembled operator: sum of entity batches."""

    system: System
    batches: List[Batch]

    def matvec(self, x: Dict[str, Array]) -> Dict[str, Array]:
        y = self.system.zeros()
        for b in self.batches:
            y = b.matvec_into(x, y)
        return y

    def __call__(self, x):
        return self.matvec(x)

    def diagonal(self, overrides: Optional[Dict[int, Array]] = None) -> Dict[str, Array]:
        """Jacobi diagonal.  ``overrides`` maps batch index -> matrices to
        use instead of the stored ones (traced jit arguments, so a
        compiled consumer survives :meth:`reassemble`)."""
        d = self.system.zeros()
        for i, b in enumerate(self.batches):
            if overrides is not None and i in overrides:
                d = b.diagonal_into(d, mats=overrides[i])
            else:
                d = b.diagonal_into(d)
        return d

    def dynamic_batch_ids(self) -> Tuple[int, ...]:
        """Indices of data-dependent (rebuildable) batches."""
        return tuple(
            i
            for i, b in enumerate(self.batches)
            if getattr(b, "rebuild", None) is not None
        )

    def lattice_form(self):
        """Tap-form lattice representation (:mod:`phifem_tpu.ops.taps`) of
        this operator, or None when unsupported (degree >= 2 fields) or
        pointless (pure uniform-stencil operators).  Built once (structure
        is data-independent) and value-refreshed after :meth:`reassemble`.
        Disable with ``PHIFEM_TAPS=0``."""
        import os

        if os.environ.get("PHIFEM_TAPS", "1") != "1":
            return None
        top = getattr(self, "_tap_form", None)
        if top is None:
            if getattr(self, "_tap_unsupported", False):
                return None
            from .ops.taps import build_tap_operator

            top = build_tap_operator(self)
            if top is None:
                self._tap_unsupported = True
                return None
            self._tap_form = top
        if top.data_version != self.data_version:
            top.refresh(self)
        return top

    @property
    def data_version(self) -> int:
        """Monotone counter bumped by every :meth:`reassemble` — cache keys
        that bake in element-matrix values (preconditioners, compiled
        solver runners) must include it to avoid serving stale data."""
        return getattr(self, "_data_version", 0)

    def _bump_version(self) -> None:
        self._data_version = self.data_version + 1
        # solve()'s runners take the data-dependent values as traced
        # ARGUMENTS and survive reassembles; solve_ir's ("ir"-keyed) bake
        # them at trace time and must be dropped
        cache = getattr(self, "_solve_cache", None)
        if cache:
            for k in [k for k in cache if k[0] == "ir"]:
                del cache[k]

    def reassemble(self) -> None:
        """Recompute data-dependent element matrices in place (jit cache
        hits -> device execution only).  Geometry-uniform batches are
        constants and cost nothing — the production inner loop when the
        level set / coefficients change on a fixed mesh.

        All rebuilds run as ONE jitted call (data arrays passed as
        arguments): one dispatch instead of one per batch."""
        entries = [
            (i, b)
            for i, b in enumerate(self.batches)
            if getattr(b, "rebuild", None) is not None
        ]
        if not entries:
            return
        fused = getattr(self, "_reassemble_fused", None)
        if fused is None or len(entries) != len(fused[0]):
            idxs = [i for i, _ in entries]
            cores = [b.rebuild_core for _, b in entries]
            if any(c is None for c in cores):
                for _, b in entries:  # legacy closure path
                    b.matrices = b.rebuild()
                self._bump_version()
                return

            @jax.jit
            def _run(datas):
                return tuple(c(d) for c, d in zip(cores, datas))

            fused = self._reassemble_fused = (idxs, _run)
        idxs, _run = fused
        datas = [
            {k: f.data for k, f in b.rebuild_data.items()} for _, b in entries
        ]
        mats = _run(datas)
        for i, m in zip(idxs, mats):
            self.batches[i].matrices = m
        self._bump_version()

    def restricted_dense(self, sel: Dict[str, np.ndarray]):
        """Dense submatrix of the operator over selected DoFs (boolean
        masks per field, shaped like the DoF arrays).  Used for the exact
        interface (cut-block) solve in the multigrid preconditioner."""
        off, ids, idx_of = self._selection_ids(sel)
        m = len(ids)
        A = np.zeros((m + 1, m + 1))
        for b in self.batches:
            b.add_dense_restricted(A, off, idx_of, m)
        return A[:m, :m], ids

    def _selection_ids(self, sel: Dict[str, np.ndarray]):
        off = self.system.offsets()
        n = self.system.num_dofs
        gsel = np.zeros(n, bool)
        for name, s in self.system.fields.items():
            gsel[off[name] : off[name] + s.num_dofs] = np.broadcast_to(
                np.asarray(sel[name]), s.dof_shape
            ).reshape(-1)
        ids = np.where(gsel)[0]
        idx_of = -np.ones(n, np.int64)
        idx_of[ids] = np.arange(len(ids))
        return off, ids, idx_of

    def restricted_csr(self, sel: Dict[str, np.ndarray]):
        """Sparse (CSR) submatrix of the operator over selected DoFs —
        O(nnz) memory, used by the scalable interface-block preconditioner
        (the dense variant caps out on fine grids)."""
        import scipy.sparse as sp

        off, ids, idx_of = self._selection_ids(sel)
        m = len(ids)
        triplets = ([], [], [])
        for b in self.batches:
            b.add_coo_restricted(triplets, off, idx_of)
        if triplets[0]:
            rows = np.concatenate(triplets[0])
            cols = np.concatenate(triplets[1])
            vals = np.concatenate(triplets[2])
        else:
            rows = cols = np.zeros(0, np.int64)
            vals = np.zeros(0)
        A = sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()
        return A, ids

    def to_dense(self) -> np.ndarray:
        """Dense global matrix (small problems / tests only)."""
        off = self.system.offsets()
        A = np.zeros((self.system.num_dofs, self.system.num_dofs))
        for b in self.batches:
            b.add_dense(A, off)
        return A


# ------------------------------------------------------------ entry points
def uniform_element_matrices(
    system: System, grid: Grid, integrand, degree: int
) -> Array:
    """(norient, nloc, nloc) element matrices of a geometry-uniform
    bilinear cell term — the raw material for vertex-stencil aggregation
    (:func:`phifem_tpu.ops.lattice.vertex_stencil_weights`)."""
    term = CellTerm(integrand, None, degree=degree, uniform=True)
    local, cell_data, ntot, _, _ = _cell_local_fn(system, term, grid, {})
    zeros = jnp.zeros(ntot, _float_dtype())
    mat_fn = jax.jacfwd(jax.grad(local, argnums=1), argnums=0)
    norient = 2 if grid.is_simplex else 1
    rep = jnp.arange(norient, dtype=jnp.int32)
    return jax.jit(jax.vmap(lambda c: mat_fn(zeros, zeros, c)))(cell_data(rep))


def _segments_for_cells(system: System, cells: Array):
    return [
        (n, s.cell_dofs[cells], tuple(s.value_shape))
        for n, s in system.fields.items()
    ]


def _prune_batch(segments, mats: Array):
    """Drop local-vector segments whose rows AND columns are identically
    zero (a term on a mixed space only touches its own fields — e.g. the
    S5 bulk stiffness uses 1 of 5 fields, 36 of 1764 matrix entries).
    Shrinks both the gathers and the batched matmuls on the hot path."""
    M = np.asarray(mats)
    nz = np.abs(M).sum(axis=0)  # (n, n) aggregated over entities
    row_any = nz.sum(axis=1) > 0.0
    col_any = nz.sum(axis=0) > 0.0
    used = row_any | col_any
    keep_segments, keep_idx, cur = [], [], 0
    for name, dofs, vs in segments:
        vsz = int(np.prod(vs)) if vs else 1
        ln = dofs.shape[1] * vsz
        if used[cur : cur + ln].any():
            keep_segments.append((name, dofs, vs))
            keep_idx.extend(range(cur, cur + ln))
        cur += ln
    if len(keep_idx) == M.shape[-1]:
        return segments, mats, None
    idx = np.asarray(keep_idx, np.int64)
    return keep_segments, jnp.asarray(M[:, idx][:, :, idx]), idx


def assemble_operator(
    system: System,
    grid: Grid,
    cell_terms: Sequence[Tuple[CellTerm, Dict]] = (),
    facet_terms: Sequence[Tuple[FacetTerm, Dict]] = (),
    boundary_terms: Sequence[Tuple[BoundaryTerm, Dict]] = (),
    cell_tags=None,
    facet_tags=None,
) -> Operator:
    """Assemble a bilinear operator.  Each term comes with its own ``data``
    dict (Functions / callables available to the integrand)."""
    batches: List[Batch] = []

    for term, data in cell_terms:
        data = _normalize_data(data)
        local, cell_data, ntot, layout, fn_data = _cell_local_fn(system, term, grid, data)
        zeros = jnp.zeros(ntot, _float_dtype())
        mat_fn = jax.jacfwd(jax.grad(local, argnums=1), argnums=0)
        if term.uniform:
            norient = 2 if grid.is_simplex else 1
            rep = jnp.arange(norient, dtype=jnp.int32)  # cells 0..norient-1
            cd = cell_data(rep)
            mats = jax.jit(jax.vmap(lambda c: mat_fn(zeros, zeros, c)))(cd)
            # decide pruning / the stencil fast path from the layout alone
            # BEFORE materializing per-cell DoF tables: at 10M DoFs the
            # (ncells, nloc) gather is ~250 MB of traffic the stencil path
            # would immediately discard
            nz = np.abs(np.asarray(mats)).sum(axis=0)
            used_cols = (nz.sum(axis=1) > 0.0) | (nz.sum(axis=0) > 0.0)
            fields_used, cur = [], 0
            for name, nloc, vs, ln in layout:
                if used_cols[cur : cur + ln].any():
                    fields_used.append((name, vs))
                cur += ln
            if not fields_used:
                continue  # term is identically zero (e.g. P1 Laplacian stab)
            if (
                len(fields_used) == 1
                and not fields_used[0][1]  # scalar field
                and system.fields[fields_used[0][0]].element.family == "Lagrange"
                and system.fields[fields_used[0][0]].degree == 1
            ):
                # stencil fast path: pure shifted adds on the vertex lattice
                from .ops.stencil import StencilCellBatch

                _, mats_p, _ = _prune_batch(
                    [(n, np.zeros((1, system.fields[n].nloc), np.int32), vs)
                     for n, nloc, vs, ln in layout], mats
                )
                batches.append(
                    StencilCellBatch.build(
                        grid, fields_used[0][0], mats_p, cell_tags, term.region
                    )
                )
                continue
            cells = _region_cells(grid, cell_tags, term.region)
            cells_j = jnp.asarray(cells)
            segs, mats, _ = _prune_batch(_segments_for_cells(system, cells_j), mats)
            batches.append(
                Batch(segs, mats, orient=grid.orientation_of(cells_j), cells=cells)
            )
        else:
            cells = _region_cells(grid, cell_tags, term.region)
            cells_j = jnp.asarray(cells)
            fn = jax.jit(jax.vmap(lambda c: mat_fn(zeros, zeros, c)))
            # eager: per-batch static tables only (not the full-grid maps)
            # land in the rebuild core's closure / HLO
            st = cell_data.static(cells_j)
            mats = fn(cell_data(cells_j, static=st))
            segs, mats, keep = _prune_batch(_segments_for_cells(system, cells_j), mats)
            if segs:
                core = jax.jit(
                    lambda arrays, _cd=cell_data, _st=st, _f=fn, _k=keep: (
                        _f(_cd(None, arrays, static=_st))
                        if _k is None
                        else _f(_cd(None, arrays, static=_st))[:, _k][:, :, _k]
                    )
                )

                def rebuild(core=core, fn_data=fn_data):
                    return core({k: f.data for k, f in fn_data.items()})

                batches.append(Batch(segs, mats, rebuild=rebuild,
                                     rebuild_core=core, rebuild_data=fn_data))

    f2c_np = None
    for term, data in facet_terms:
        data = _normalize_data(data)
        if f2c_np is None:
            f2c_np = grid.f2c_np
        ftags = np.asarray(facet_tags)
        sel = np.isin(ftags, np.asarray(term.region))
        sel &= np.all(f2c_np >= 0, axis=1)  # interior facets only (dS semantics)
        facets = np.where(sel)[0].astype(np.int32)
        facets_j = jnp.asarray(facets)
        c0 = jnp.asarray(f2c_np[facets, 0])
        c1 = jnp.asarray(f2c_np[facets, 1])
        k0 = grid.local_facet_index(c0, facets_j)
        k1 = grid.local_facet_index(c1, facets_j)
        normals = grid.facet_base_normals[facets_j]

        local, facet_data, ntot, layout, fn_data = _facet_local_fn(
            system, term, grid, data, one_sided=False
        )
        st = facet_data.static(facets_j, (c0, c1), (k0, k1), normals)
        cd = facet_data(static=st)
        zeros = jnp.zeros(ntot, _float_dtype())
        mat_fn = jax.jacfwd(jax.grad(local, argnums=1), argnums=0)
        fn = jax.jit(jax.vmap(lambda c: mat_fn(zeros, zeros, c)))
        mats = fn(cd)
        segs = [
            (n, s.cell_dofs[c0], tuple(s.value_shape))
            for n, s in system.fields.items()
        ] + [
            (n, s.cell_dofs[c1], tuple(s.value_shape))
            for n, s in system.fields.items()
        ]
        segs, mats, keep = _prune_batch(segs, mats)
        if segs:
            core = jax.jit(
                lambda arrays, _fd=facet_data, _st=st, _f=fn, _k=keep: (
                    _f(_fd(arrays=arrays, static=_st))
                    if _k is None
                    else _f(_fd(arrays=arrays, static=_st))[:, _k][:, :, _k]
                )
            )

            def rebuild(core=core, fn_data=fn_data):
                return core({k: f.data for k, f in fn_data.items()})

            batches.append(Batch(segs, mats, rebuild=rebuild,
                                 rebuild_core=core, rebuild_data=fn_data))

    for term, data in boundary_terms:
        data = _normalize_data(data)
        fl = term.facets
        local, facet_data, ntot, layout, fn_data = _facet_local_fn(
            system, term, grid, data, one_sided=True
        )
        normals = fl.normals
        st = facet_data.static(fl.facets, (fl.cells,), (fl.local_facets,), normals)
        cd = facet_data(static=st)
        zeros = jnp.zeros(ntot, _float_dtype())
        mat_fn = jax.jacfwd(jax.grad(local, argnums=1), argnums=0)
        fn = jax.jit(jax.vmap(lambda c: mat_fn(zeros, zeros, c)))
        mats = fn(cd)
        segs, mats, keep = _prune_batch(_segments_for_cells(system, fl.cells), mats)
        if segs:
            core = jax.jit(
                lambda arrays, _fd=facet_data, _st=st, _f=fn, _k=keep: (
                    _f(_fd(arrays=arrays, static=_st))
                    if _k is None
                    else _f(_fd(arrays=arrays, static=_st))[:, _k][:, :, _k]
                )
            )

            def rebuild(core=core, fn_data=fn_data):
                return core({k: f.data for k, f in fn_data.items()})

            batches.append(Batch(segs, mats, rebuild=rebuild,
                                 rebuild_core=core, rebuild_data=fn_data))

    return Operator(system, batches)


def _try_stencil_rhs(system, grid, term, data, cell_tags, b):
    """Vertex-stencil fast path for a LINEAR cell term that is
    geometry-uniform (``term.uniform``) and linear in a single P1 data
    field: the assembled vector is then ``b += B_o @ f_loc`` summed over
    region cells — a per-orientation stencil applied to the data field's
    nodal lattice (:class:`~phifem_tpu.ops.stencil.StencilCellBatch`
    masked matvec), with NO per-cell tables.

    The generic path gathers ``(ncells_region, nloc)`` data/DoF tables,
    O(ncells) device memory at the 10M-cell scale; the stencil path needs
    none.  Linearity is VERIFIED numerically at the
    representative orientation cells — any mismatch falls back to the
    generic path, so a mis-flagged nonlinear term cannot assemble wrong.

    Returns the updated vector dict, or None when ineligible."""
    from .ops.stencil import StencilCellBatch

    fn_data = {k: v for k, v in data.items() if isinstance(v, Function)}
    call_data = {k: v for k, v in data.items() if not isinstance(v, Function)}
    if len(fn_data) != 1 or call_data:
        return None
    ((dk, f),) = fn_data.items()
    fs = f.space
    if fs.value_shape or fs.degree != 1 or fs.element.family != "Lagrange":
        return None
    local, cell_data, ntot, layout, _ = _cell_local_fn(system, term, grid, data)
    norient = 2 if grid.is_simplex else 1
    rep = jnp.arange(norient, dtype=jnp.int32)
    cd = cell_data(rep)
    zeros_v = jnp.zeros(ntot, _float_dtype())
    ft = _float_dtype()

    def one(cd_o):
        def wrt_f(dvals):
            c2 = dict(cd_o)
            c2["d_" + dk] = dvals
            return jax.grad(lambda v: local(None, v, c2))(zeros_v)

        return jax.jacfwd(wrt_f)(jnp.zeros(fs.nloc, ft))  # (ntot, nloc_f)

    M = np.asarray(jax.jit(jax.vmap(one))(cd))
    # verify exact linearity in the data field on the representative cells
    # (their cd carries the real nodal data)
    exact = np.asarray(
        jax.jit(
            jax.vmap(lambda c: jax.grad(lambda v: local(None, v, c))(zeros_v))
        )(cd)
    )
    lin = np.einsum("oif,of->oi", M, np.asarray(cd["d_" + dk]))
    scale = np.abs(exact).max() + np.abs(lin).max() + 1e-300
    if np.abs(exact - lin).max() > 1e-12 * scale:
        return None

    nz = np.abs(M).sum(axis=(0, 2))  # per-row usage
    fields_used, cur = [], 0
    for name, nloc, vs, ln in layout:
        if nz[cur : cur + ln].any():
            fields_used.append((name, vs, cur, ln))
        cur += ln
    if not fields_used:
        return b  # term contributes nothing (e.g. P1 test-Laplacian term)
    if len(fields_used) != 1:
        return None
    name, vs, cur, ln = fields_used[0]
    sp = system.fields[name]
    if vs or sp.degree != 1 or sp.element.family != "Lagrange":
        return None
    B = jnp.asarray(M[:, cur : cur + ln, :], ft)  # (norient, nloc_v, nloc_f)
    sb = StencilCellBatch.build(grid, name, B, cell_tags, term.region)
    return sb.matvec_into({name: f.data}, b)


def assemble_vector(
    system: System,
    grid: Grid,
    cell_terms: Sequence[Tuple[CellTerm, Dict]] = (),
    facet_terms: Sequence[Tuple[FacetTerm, Dict]] = (),
    boundary_terms: Sequence[Tuple[BoundaryTerm, Dict]] = (),
    cell_tags=None,
    facet_tags=None,
) -> Dict[str, Array]:
    """Assemble a linear form into a DoF vector (reference
    ``assemble_vector``, N7).  Integrand signatures drop the trial dict:
    cell ``integrand(v, data, x, ctx)``, interior facet
    ``integrand(v0, v1, data0, data1, x, n, ctx)``, boundary
    ``integrand(v, data, x, n, ctx)``."""
    b = system.zeros()

    for term, data in cell_terms:
        data = _normalize_data(data)
        if term.uniform:
            nb = _try_stencil_rhs(system, grid, term, data, cell_tags, b)
            if nb is not None:
                b = nb
                continue
        local, cell_data, ntot, layout, fn_data = _cell_local_fn(system, term, grid, data)
        cells = _region_cells(grid, cell_tags, term.region)
        cells_j = jnp.asarray(cells)
        cd = cell_data(cells_j)
        zeros = jnp.zeros(ntot, _float_dtype())
        vec_fn = jax.grad(lambda v, c: local(None, v, c), argnums=0)
        vecs = jax.jit(jax.vmap(lambda c: vec_fn(zeros, c)))(cd)
        batch = Batch(_segments_for_cells(system, cells_j), None)
        b = batch.scatter_add(b, vecs)

    for term, data in facet_terms:
        data = _normalize_data(data)
        f2c_np = grid.f2c_np
        ftags = np.asarray(facet_tags)
        sel = np.isin(ftags, np.asarray(term.region))
        sel &= np.all(f2c_np >= 0, axis=1)  # interior facets only (dS)
        facets = np.where(sel)[0].astype(np.int32)
        facets_j = jnp.asarray(facets)
        c0 = jnp.asarray(f2c_np[facets, 0])
        c1 = jnp.asarray(f2c_np[facets, 1])
        k0 = grid.local_facet_index(c0, facets_j)
        k1 = grid.local_facet_index(c1, facets_j)
        normals = grid.facet_base_normals[facets_j]
        local, facet_data, ntot, layout, fn_data = _facet_local_fn(
            system, term, grid, data, one_sided=False
        )
        cd = facet_data(facets_j, (c0, c1), (k0, k1), normals)
        zeros = jnp.zeros(ntot, _float_dtype())
        vec_fn = jax.grad(lambda v, c: local(None, v, c), argnums=0)
        vecs = jax.jit(jax.vmap(lambda c: vec_fn(zeros, c)))(cd)
        segs = _segments_for_cells(system, c0) + _segments_for_cells(system, c1)
        batch = Batch(segs, None)
        b = batch.scatter_add(b, vecs)

    for term, data in boundary_terms:
        data = _normalize_data(data)
        fl = term.facets
        local, facet_data, ntot, layout, fn_data = _facet_local_fn(
            system, term, grid, data, one_sided=True
        )
        cd = facet_data(fl.facets, (fl.cells,), (fl.local_facets,), fl.normals)
        zeros = jnp.zeros(ntot, _float_dtype())
        vec_fn = jax.grad(lambda v, c: local(None, v, c), argnums=0)
        vecs = jax.jit(jax.vmap(lambda c: vec_fn(zeros, c)))(cd)
        batch = Batch(_segments_for_cells(system, fl.cells), None)
        b = batch.scatter_add(b, vecs)

    return b


def assemble_scalar(
    grid: Grid,
    cell_terms: Sequence[Tuple[CellTerm, Dict]] = (),
    boundary_terms: Sequence[Tuple[BoundaryTerm, Dict]] = (),
    cell_tags=None,
) -> Array:
    """Assemble a functional (reference ``assemble_scalar``, N8).
    Integrand signatures: cell ``integrand(data, x, ctx)``, boundary
    ``integrand(data, x, n, ctx)``."""
    sys0 = System({})
    total = jnp.zeros((), _float_dtype())

    for term, data in cell_terms:
        data = _normalize_data(data)
        wrapped = CellTerm(
            integrand=lambda v_ev, d_ev, x, ctx, _t=term: _t.integrand(d_ev, x, ctx),
            region=term.region,
            degree=term.degree,
        )
        local, cell_data, ntot, layout, fn_data = _cell_local_fn(sys0, wrapped, grid, data)
        cells = _region_cells(grid, cell_tags, term.region)
        cells_j = jnp.asarray(cells)
        cd = cell_data(cells_j)
        zeros = jnp.zeros(ntot, _float_dtype())
        vals = jax.jit(jax.vmap(lambda c: local(None, zeros, c)))(cd)
        total = total + jnp.sum(vals)

    for term, data in boundary_terms:
        data = _normalize_data(data)
        fl = term.facets
        wrapped = BoundaryTerm(
            integrand=lambda v_ev, d_ev, x, n, ctx, _t=term: _t.integrand(
                d_ev, x, n, ctx
            ),
            facets=fl,
            npts=term.npts,
        )
        local, facet_data, ntot, layout, _ = _facet_local_fn(
            sys0, wrapped, grid, data, one_sided=True
        )
        cd = facet_data(fl.facets, (fl.cells,), (fl.local_facets,), fl.normals)
        zeros = jnp.zeros(ntot, _float_dtype())
        vals = jax.jit(jax.vmap(lambda c: local(None, zeros, c)))(cd)
        total = total + jnp.sum(vals)

    return total


def assemble_cellwise(
    grid: Grid,
    term: CellTerm,
    data: Dict,
    cell_tags=None,
) -> Array:
    """Per-cell functional values scattered into a DG0 vector (replaces the
    reference's DG0 test-function localization for error fields,
    ``demo/neumann/square/main.py:221-235``)."""
    sys0 = System({})
    data = _normalize_data(data)
    wrapped = CellTerm(
        integrand=lambda v_ev, d_ev, x, ctx, _t=term: _t.integrand(d_ev, x, ctx),
        region=term.region,
        degree=term.degree,
    )
    local, cell_data, ntot, layout, fn_data = _cell_local_fn(sys0, wrapped, grid, data)
    cells = _region_cells(grid, cell_tags, term.region)
    cells_j = jnp.asarray(cells)
    cd = cell_data(cells_j)
    zeros = jnp.zeros(ntot, _float_dtype())
    vals = jax.jit(jax.vmap(lambda c: local(None, zeros, c)))(cd)
    out = jnp.zeros(grid.num_cells, _float_dtype())
    return out.at[cells_j].add(vals)
