"""Cell/facet classification from a level set — the core of phi-FEM.

Device-side reimplementation of the reference's tagging pipeline
(``src/phifem/mesh_scripts.py``):

* cell tags (``_tag_cells``, :284-390): 1 = strictly inside, 2 = cut,
  3 = strictly outside, decided by the signs of the level set sampled on the
  boundary lattice of every cell;
* ``single_layer_cut`` (:304-315, 349-358): cut cells with no
  vertex-neighbouring interior cell are reclassified as outside.  The
  reference walks ragged v2c/c2v adjacency; here it is two dense passes —
  a scatter-max of the interior indicator onto vertices followed by a
  gather-max back onto cells (a vertex max-pool, embarrassingly parallel);
* facet tags (``_tag_facets``, :393-558): 1 interior, 2 cut (F_h^Gamma),
  3 interior boundary (ghost-penalty set), 4 boundary Gamma_h, 5 exterior,
  6 direct interface.  The reference's global set algebra over c2f maps
  reduces, facet by facet, to a pure function of the two adjacent cell tags
  (every interior facet of this grid has exactly two cells), plus — for
  facets on the background-box boundary — a per-cell "boundary trace cut"
  flag computed from level-set signs on the cell's boundary facets
  (:429-460);
* tag overwriting (``_overwrite_tags``, :561-568) and the public
  orchestrator ``compute_tags_measures`` (:571-653) with both operating
  modes: ``box_mode=True`` returns one-sided boundary measures with ids
  100/101, ``box_mode=False`` extracts the active submesh Omega_h and
  transfers tags onto it (:635-645).

Tagging is *preprocessing*: it runs once per (mesh, level set) as jittable
array ops, then the resulting entity lists are frozen to static shapes for
the solver hot path.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from . import levelset as lsmod
from .grid import Grid
from .measures import (
    BoundaryMeasure,
    FacetSideList,
    one_sided_facets,
    one_sided_facets_multi,
)

Array = jnp.ndarray
LevelSet = lsmod.LevelSet

__all__ = [
    "EntityTags",
    "tag_cells",
    "tag_facets",
    "compute_tags_measures",
    "TagsMeasures",
]


def _debug_mode() -> bool:
    # Same switch as the reference (mesh_scripts.py:22-25).
    return os.environ.get("MODE", "") == "debug"


class _LazyTags:
    """Deferred host fetch of the packed ``_tags_jit`` output.

    ``compute_tags_measures`` dispatches tagging and returns immediately;
    the (cells, facets, degenerate-count) triple crosses to the host in
    ONE ``jax.device_get`` on first access — or packed with other pending
    fetches via :func:`phifem_tpu.utils.fetch_all` (so a warm re-tag +
    solve loop synchronizes exactly once)."""

    __slots__ = ("_dev", "cells", "facets")

    def __init__(self, dev):
        self._dev = dev  # (cells, facets, ndeg) device arrays, or None
        self.cells = None
        self.facets = None

    def _pending(self):
        return self._dev

    def _fetch(self):
        if self._dev is not None:
            self._absorb(jax.device_get(self._dev))

    def _absorb(self, vals) -> None:
        if self._dev is None:
            return
        cells, facets, ndeg = vals
        self._dev = None
        self.cells = np.asarray(cells)
        self.facets = np.asarray(facets)
        if int(ndeg) > 0:
            # stacklevel=4 attributes the warning to the CALLER of the
            # sync point (EntityTags.values / fetch_all), i.e. user code,
            # not these internal _fetch/_absorb frames.
            warnings.warn(
                f"{int(ndeg)} cell(s) have an identically-zero (or NaN) "
                "level set at every detection point; they are classified "
                "as cut (reference degenerate-cell convention, "
                "mesh_scripts.py:121-133).",
                RuntimeWarning,
                stacklevel=4,
            )


class EntityTags:
    """Dense per-entity tag array (dolfinx ``MeshTags`` analogue,
    reference N3 usage at ``mesh_scripts.py:274-279, 386-390``).

    ``values`` may be materialized host/device data, or deferred: tags
    produced by :func:`compute_tags_measures` stay on device until first
    host access (see :class:`_LazyTags`).

    Instances compare by IDENTITY (not by tag values) — they are handles
    to possibly-unfetched device data, so value ``==``/``hash`` would
    force a host sync as a side effect of comparison."""

    __slots__ = ("dim", "_values", "_lazy")

    def __repr__(self) -> str:
        if self._values is not None:
            state = f"n={self._values.shape[0]}"
        elif self._lazy is not None:
            state = "deferred"
        else:
            state = "empty"
        return f"EntityTags(dim={self.dim!r}, {state})"

    def __init__(self, dim: str, values: Optional[Array] = None, _lazy=None):
        self.dim = dim  # "cell" | "facet"
        self._values = values  # (num_entities,) int8
        self._lazy = _lazy

    @property
    def values(self) -> Array:
        if self._values is None:
            self._lazy._fetch()
            self._values = getattr(self._lazy, self.dim + "s")
        return self._values

    def find(self, tag: int) -> np.ndarray:
        """Host-side indices of entities with ``tag`` (``MeshTags.find``)."""
        return np.where(np.asarray(self.values) == tag)[0].astype(np.int32)

    @property
    def indices(self) -> np.ndarray:
        return np.arange(self.values.shape[0], dtype=np.int32)

    def as_numpy(self) -> np.ndarray:
        return np.asarray(self.values)


# --------------------------------------------------------------------- cells
def tag_cells(
    grid: Grid,
    levelset: LevelSet,
    detection_degree: int,
    single_layer_cut: bool = False,
    return_degenerate: bool = False,
):
    """Cell tags 1/2/3 as a dense int8 array (reference ``_tag_cells``,
    ``mesh_scripts.py:284-390``).

    ``return_degenerate=True`` additionally returns the count of
    degenerate cells — every detection value exactly zero (or NaN), which
    the pipeline forces to *cut* and the reference reports with a
    ``RuntimeWarning`` (``mesh_scripts.py:121-133``)."""
    pts = lsmod.detection_points(grid.cell_type, detection_degree)
    # per-point accumulation: no (ncells, npts) intermediate at the
    # 20M-cell scale (see sign_flags_on_cells)
    has_pos, has_neg = lsmod.sign_flags_on_cells(grid, levelset, pts)
    tags = lsmod.classify(has_pos, has_neg)
    n_degenerate = (
        jnp.sum(jnp.logical_and(jnp.logical_not(has_pos), jnp.logical_not(has_neg)))
        if return_degenerate
        else None
    )

    if single_layer_cut:
        # vertex max-pool in LATTICE form (shifted pads/maxima — no
        # scatter/gather): a cut cell stays cut only if it shares a vertex
        # with an interior cell
        ny, nx = grid.ny, grid.nx
        interior = (tags == 1).astype(jnp.int8)

        def padm(a, dy, dx):
            return jnp.pad(a, ((dy, 1 - dy), (dx, 1 - dx)))

        if grid.is_simplex:
            I2 = interior.reshape(ny, nx, 2)
            Lf, Uf = I2[:, :, 0], I2[:, :, 1]
            A = jnp.maximum(Lf, Uf)
            # lower (ix,iy) touches vertices (iy,ix),(iy,ix+1),(iy+1,ix+1);
            # upper touches (iy,ix),(iy+1,ix+1),(iy+1,ix)
            V = jnp.maximum(
                jnp.maximum(padm(A, 0, 0), padm(Lf, 0, 1)),
                jnp.maximum(padm(A, 1, 1), padm(Uf, 1, 0)),
            )  # (ny+1, nx+1) vertex flags
            conn_l = jnp.maximum(
                jnp.maximum(V[:ny, :nx], V[:ny, 1:]), V[1:, 1:]
            )
            conn_u = jnp.maximum(
                jnp.maximum(V[:ny, :nx], V[1:, 1:]), V[1:, :nx]
            )
            connected = jnp.stack([conn_l, conn_u], axis=-1).reshape(-1) > 0
        else:
            I2 = interior.reshape(ny, nx)
            V = jnp.maximum(
                jnp.maximum(padm(I2, 0, 0), padm(I2, 0, 1)),
                jnp.maximum(padm(I2, 1, 1), padm(I2, 1, 0)),
            )
            connected = (
                jnp.maximum(
                    jnp.maximum(V[:ny, :nx], V[:ny, 1:]),
                    jnp.maximum(V[1:, :nx], V[1:, 1:]),
                ).reshape(-1)
                > 0
            )
        isolated_cut = jnp.logical_and(tags == 2, jnp.logical_not(connected))
        tags = jnp.where(isolated_cut, jnp.int8(3), tags)

    if return_degenerate:
        return tags, n_degenerate
    return tags


def _boundary_trace_cut(
    grid: Grid, levelset: LevelSet, detection_degree: int
) -> Array:
    """Per-cell flag: does the level set restricted to the cell's
    background-boundary facets change sign (or vanish identically)?

    Mirrors the reference's facet detection vector (``mesh_scripts.py:434-452``):
    a ``ds``-measure detection assembled into DG0, i.e. signs aggregated over
    *all* boundary facets of each boundary cell; d in (-1, 1) — which
    includes the zero-denominator interior cells forced to 0.5 — becomes
    ``has_pos == has_neg``.
    """
    bmask = grid.boundary_facet_mask_np
    bf = np.where(bmask)[0].astype(np.int32)  # static: grid structure only
    f2c = grid.f2c_np[bf]
    owner = np.max(f2c, axis=1).astype(np.int32)  # the single adjacent cell
    owner_j = jnp.asarray(owner)
    local = jnp.asarray(grid.local_facet_index_np(owner, bf))  # host constants
    ref_table = jnp.asarray(
        lsmod.facet_ref_points(grid.cell_type, detection_degree)
    )  # (nfpc, npts, 2)
    ref_pts = ref_table[local]  # (nbf, npts, 2)
    vals = lsmod.evaluate_at_cell_points(grid, levelset, owner_j, ref_pts)
    fpos, fneg = lsmod.sign_flags(vals)  # per boundary facet

    cpos = jnp.zeros(grid.num_cells, jnp.int8).at[owner_j].max(fpos.astype(jnp.int8))
    cneg = jnp.zeros(grid.num_cells, jnp.int8).at[owner_j].max(fneg.astype(jnp.int8))
    is_boundary_cell = jnp.zeros(grid.num_cells, bool).at[owner_j].set(True)
    trace_cut = cpos == cneg  # mixed signs OR identically zero
    return jnp.logical_and(trace_cut, is_boundary_cell)


# -------------------------------------------------------------------- facets
def tag_facets(
    grid: Grid,
    cell_tags: Array,
    levelset: LevelSet,
    detection_degree: int,
) -> Array:
    """Facet tags 1..6 as dense int8 (reference ``_tag_facets``,
    ``mesh_scripts.py:393-558``).

    Per-facet rules derived from the reference's set algebra (derivation in
    SURVEY.md section 7 "hard parts"); (a, b) = tags of the two adjacent
    cells, t = boundary-trace-cut flag of the owning cell:

      interior facets: (1,1)->1, (1,2)->3, (1,3)->6, (2,2)->2, (2,3)->4,
                       (3,3)->5
      boundary facets, if the mesh has exterior cells (:469-474):
                       a==1 -> 1, a==2 -> (t ? 2 : 4), a==3 -> 5
      boundary facets, no exterior cells anywhere:
                       a==1 -> 4, a==2 -> (t ? 2 : 4)
    """
    trace_cut = _boundary_trace_cut(grid, levelset, detection_degree)

    # LATTICE form: per facet family (vertical / horizontal / diagonal)
    # the two neighbour cell tags are shifted slices of the cell-tag
    # lattice — no f2c table, no 2.5M-facet gathers (measured ~0.2 s of
    # the warm tag kernel at n=800)
    ny, nx = grid.ny, grid.nx
    has_exterior = jnp.any(cell_tags == 3)
    trc = trace_cut.astype(jnp.int8)
    if grid.is_simplex:
        T2 = cell_tags.reshape(ny, nx, 2)
        R2 = trc.reshape(ny, nx, 2)
        L, U = T2[:, :, 0], T2[:, :, 1]  # lower / upper triangle tags
        Ltr, Utr = R2[:, :, 0], R2[:, :, 1]
    else:
        L = U = cell_tags.reshape(ny, nx)
        Ltr = Utr = trc.reshape(ny, nx)

    def pair(lo_, hi_):
        return jnp.where(
            (lo_ == 1) & (hi_ == 1),
            1,
            jnp.where(
                (lo_ == 1) & (hi_ == 2),
                3,
                jnp.where(
                    (lo_ == 1) & (hi_ == 3),
                    6,
                    jnp.where(
                        (lo_ == 2) & (hi_ == 2),
                        2,
                        jnp.where((lo_ == 2) & (hi_ == 3), 4, 5),
                    ),
                ),
            ),
        )

    def family(t0, t1, valid0, valid1, t_owner, a_owner):
        interior_tag = pair(jnp.minimum(t0, t1), jnp.maximum(t0, t1))
        cut_or_bdry = jnp.where(t_owner > 0, 2, 4)
        bdry_with_ext = jnp.where(
            a_owner == 1, 1, jnp.where(a_owner == 2, cut_or_bdry, 5)
        )
        bdry_no_ext = jnp.where(a_owner == 1, 4, cut_or_bdry)
        bdry_tag = jnp.where(has_exterior, bdry_with_ext, bdry_no_ext)
        is_bdry = jnp.logical_or(~valid0, ~valid1)
        return jnp.where(is_bdry, bdry_tag, interior_tag).astype(jnp.int8)

    zc = jnp.zeros((ny, 1), cell_tags.dtype)
    zr = jnp.zeros((1, nx), cell_tags.dtype)
    zct = jnp.zeros((ny, 1), jnp.int8)
    zrt = jnp.zeros((1, nx), jnp.int8)
    col = jnp.arange(nx + 1)[None, :]
    row = jnp.arange(ny + 1)[:, None]

    # vertical facets (ny, nx+1): left = lower tri of block ix-1 (c0),
    # right = upper tri of block ix (c1, larger cell id -> owner)
    tl = jnp.concatenate([zc, L], axis=1)
    tr = jnp.concatenate([U, zc], axis=1)
    t_own_v = jnp.where(
        col < nx,
        jnp.concatenate([Utr, zct], axis=1),
        jnp.concatenate([zct, Ltr], axis=1),
    )
    a_v = jnp.where(col > 0, tl, tr)  # c0 (left) tag if valid else c1
    fv = family(tl, tr, col > 0, col < nx, t_own_v, a_v)

    # horizontal facets (ny+1, nx): below = upper tri of block iy-1 (c0),
    # above = lower tri of block iy (c1, larger cell id -> owner)
    tb = jnp.concatenate([zr, U], axis=0)
    ta = jnp.concatenate([L, zr], axis=0)
    t_own_h = jnp.where(
        row < ny,
        jnp.concatenate([Ltr, zrt], axis=0),
        jnp.concatenate([zrt, Utr], axis=0),
    )
    a_h = jnp.where(row > 0, tb, ta)
    fh = family(tb, ta, row > 0, row < ny, t_own_h, a_h)

    parts = [fv.reshape(-1), fh.reshape(-1)]
    if grid.is_simplex:
        # diagonal facets (ny, nx): lower | upper of the same block,
        # never on the background boundary
        fd = pair(jnp.minimum(L, U), jnp.maximum(L, U)).astype(jnp.int8)
        parts.append(fd.reshape(-1))
    return jnp.concatenate(parts)


# ----------------------------------------------------------------- overwrite
def overwrite_tags(
    tags: EntityTags, new: Dict[int, np.ndarray], reserved: Tuple[int, ...]
) -> EntityTags:
    """Merge user-supplied tags over computed ones, user tags win (reference
    ``_overwrite_tags`` + validation, ``mesh_scripts.py:561-568, 606-615``).

    ``new`` maps tag value -> entity indices.
    """
    vals = np.asarray(tags.values).copy()
    for tag, idx in new.items():
        if int(tag) in reserved:
            raise ValueError(
                f"Cannot overwrite {tags.dim} tags with reserved value {tag}."
            )
        vals[np.asarray(idx, np.int64)] = np.int8(tag)
    return EntityTags(tags.dim, jnp.asarray(vals))


# ----------------------------------------------------------------- submesh
@dataclasses.dataclass(frozen=True)
class Submesh:
    """Active-cell view of the background grid (Omega_h = cells tagged 1|2).

    Replaces ``dfx.mesh.create_submesh`` + ``_transfer_tags`` (reference
    ``mesh_scripts.py:217-281, 635-645``): instead of building a new mesh,
    we keep gather lists into the parent grid — the natural representation
    on an implicit structured grid.
    """

    parent: Grid
    cells: np.ndarray  # (n_active,) parent cell ids, ascending
    facets: np.ndarray  # (n_facets,) parent facet ids touched by active cells
    cell_tags: EntityTags  # over `cells` (submesh numbering)
    facet_tags: EntityTags  # over `facets` (submesh numbering)
    exterior: FacetSideList  # exterior boundary of the submesh

    @property
    def num_cells(self) -> int:
        return len(self.cells)


def _build_submesh(grid: Grid, cell_tags: Array, facet_tags: Array) -> Submesh:
    ct = np.asarray(cell_tags)
    ftags = np.asarray(facet_tags)
    active = np.where((ct == 1) | (ct == 2))[0].astype(np.int32)
    c2f = grid.c2f_np[active]
    facets = np.unique(c2f.reshape(-1)).astype(np.int32)

    # exterior boundary of the submesh: facets with exactly one active cell
    f2c = grid.f2c_np[facets]
    act = np.zeros(grid.num_cells, bool)
    act[active] = True
    a0 = (f2c[:, 0] >= 0) & act[np.maximum(f2c[:, 0], 0)]
    a1 = (f2c[:, 1] >= 0) & act[np.maximum(f2c[:, 1], 0)]
    ext = np.logical_xor(a0, a1)
    ext_facets = facets[ext]
    chosen = np.where(a0[ext], f2c[ext, 0], f2c[ext, 1]).astype(np.int32)
    signs = np.where(a0[ext], 1.0, -1.0)
    cells_j = jnp.asarray(chosen)
    facets_j = jnp.asarray(ext_facets)
    exterior = FacetSideList(
        grid,
        facets_j,
        cells_j,
        grid.local_facet_index(cells_j, facets_j),
        jnp.asarray(signs),
    )

    return Submesh(
        parent=grid,
        cells=active,
        facets=facets,
        cell_tags=EntityTags("cell", jnp.asarray(ct[active])),
        facet_tags=EntityTags("facet", jnp.asarray(ftags[facets])),
        exterior=exterior,
    )


# ------------------------------------------------------------------- public
@dataclasses.dataclass(frozen=True)
class TagsMeasures:
    """Return value of :func:`compute_tags_measures` — mirrors the reference
    5-tuple ``(cells_tags, facets_tags, submesh, boundaries_measure,
    submesh_maps)`` (``mesh_scripts.py:647-653``)."""

    cells_tags: EntityTags
    facets_tags: EntityTags
    submesh: Optional[Submesh]
    boundaries_measure: BoundaryMeasure
    submesh_maps: Optional[List[np.ndarray]]
    _lazy: Optional["_LazyTags"] = None

    # packed-fetch protocol (phifem_tpu.utils.fetch_all): tags stay on
    # device until the caller synchronizes — pack the fetch with e.g. a
    # deferred SolveResult so a warm tag+assemble+solve iteration costs
    # ONE host round trip total
    def _pending(self):
        return self._lazy._pending() if self._lazy is not None else None

    def _absorb(self, vals) -> None:
        if self._lazy is not None:
            self._lazy._absorb(vals)

    def __iter__(self):
        return iter(
            (
                self.cells_tags,
                self.facets_tags,
                self.submesh,
                self.boundaries_measure,
                self.submesh_maps,
            )
        )


from functools import partial


@partial(
    jax.jit,
    static_argnames=("grid", "degree", "single_layer_cut", "ls_call", "ls_space"),
)
def _tags_jit(grid, degree, single_layer_cut, ls_call, ls_space, ls_data):
    """One compiled kernel for the full (cell, facet) tagging pipeline.

    The level set is either a static callable (``ls_call``) or a discrete
    field given by a static space + dynamic coefficient array — keeping
    coefficients dynamic lets a convergence loop re-tag with new data
    without recompiling.
    """
    from .spaces import Function as _Function

    ls = ls_call if ls_call is not None else _Function(ls_space, ls_data)
    cells, ndeg = tag_cells(
        grid, ls, degree, single_layer_cut, return_degenerate=True
    )
    facets = tag_facets(grid, cells, ls, degree)
    return cells, facets, ndeg


def compute_tags_measures(
    grid: Grid,
    levelset: LevelSet,
    detection_degree: int,
    box_mode: bool = False,
    single_layer_cut: bool = False,
    overwrite: Optional[Dict[str, Dict[int, np.ndarray]]] = None,
) -> TagsMeasures:
    """Public entry point — reference ``compute_tags_measures``
    (``mesh_scripts.py:571-653``).

    ``levelset`` is a callable ``phi(x)`` or a discrete
    :class:`~phifem_tpu.spaces.Function`; ``overwrite`` optionally maps
    ``{"cells": {tag: indices}, "facets": {tag: indices}}``.

    ``grid`` may also be an imported unstructured mesh
    (:class:`~phifem_tpu.umesh.UMesh` — the reference's XDMF-mesh path,
    ``tests/test_compute_meshtags.py:136-137``), in which case the
    vectorized host pipeline in :mod:`phifem_tpu.umesh` runs instead.

    Diagnostics are FETCH-DEFERRED on the structured path: the
    degenerate-cell ``RuntimeWarning`` (reference
    ``mesh_scripts.py:121-133``) fires at the first host materialization
    of the tags (``EntityTags.values`` / ``as_numpy`` /
    :func:`phifem_tpu.utils.fetch_all`), not inside this call — a caller
    that never fetches never pays the device round trip and never sees
    the warning.  Under ``MODE=debug`` the invariant checks force the
    fetch here, so the warning is eager again.
    """
    from .spaces import Function as _Function
    from .umesh import UMesh as _UMesh, compute_tags_measures_unstructured
    from .umesh3 import UMesh3 as _UMesh3

    if isinstance(grid, (_UMesh, _UMesh3)):
        return compute_tags_measures_unstructured(
            grid,
            levelset,
            detection_degree,
            box_mode=box_mode,
            single_layer_cut=single_layer_cut,
            overwrite=overwrite,
        )

    if isinstance(levelset, _Function):
        out = _tags_jit(
            grid, detection_degree, single_layer_cut, None,
            levelset.space, levelset.data,
        )
    else:
        out = _tags_jit(
            grid, detection_degree, single_layer_cut, levelset, None, None
        )
    # DEFERRED packed fetch for (cells, facets, degenerate count): tags
    # stay on device until first host access (one device_get for all
    # three — separate fetches each cost a full round trip on a remote
    # device, and a warm re-tag inside a solve loop may never need the
    # host values before the end-of-iteration synchronization at all)
    lazy = _LazyTags(out)
    cells_tags = EntityTags("cell", _lazy=lazy)
    facets_tags = EntityTags("facet", _lazy=lazy)

    if overwrite:
        if "cells" in overwrite:
            cells_tags = overwrite_tags(cells_tags, overwrite["cells"], (1, 2, 3))
        if "facets" in overwrite:
            facets_tags = overwrite_tags(
                facets_tags, overwrite["facets"], (1, 2, 3, 4, 5, 6, 100, 101)
            )

    if _debug_mode():
        _check_invariants(cells_tags, facets_tags)

    if box_mode:
        # id 100: Gamma_h (tag-4 facets) seen from inside Omega_h (cells 1|2)
        # id 101: interior-boundary facets (tag 3) seen from the cut side
        # (cells 2|3) — reference mesh_scripts.py:617-629.
        # LAZY: entity-list prep (incl. the host tag fetch) + the (single
        # batched) upload run on first access only — a warm re-tag in a
        # solve loop re-uses the operator's frozen facet lists and never
        # reads the fresh measure, so building it eagerly costs a full
        # device round trip for nothing
        def _build_measure():
            ct = cells_tags.as_numpy()
            ft = facets_tags.as_numpy()
            return one_sided_facets_multi(
                grid,
                {
                    100: (np.where(ft == 4)[0], (1, 2)),
                    101: (np.where(ft == 3)[0], (2, 3)),
                },
                ct,
            )

        measure = BoundaryMeasure(build=_build_measure)
        return TagsMeasures(cells_tags, facets_tags, None, measure, None, lazy)

    sub = _build_submesh(grid, cells_tags.values, facets_tags.values)
    measure = BoundaryMeasure({0: sub.exterior})
    maps = [sub.cells, sub.facets]
    return TagsMeasures(sub.cell_tags, sub.facet_tags, sub, measure, maps)


def _check_invariants(cells_tags: EntityTags, facets_tags: EntityTags) -> None:
    """Debug-mode invariants (reference ``mesh_scripts.py:360-374,
    499-521``): dense tags are disjoint by construction, so the meaningful
    checks are non-emptiness."""
    ct = cells_tags.as_numpy()
    ft = facets_tags.as_numpy()
    if not np.any(ct == 1):
        raise ValueError("No interior cells (1)!")
    if not np.any(ct == 2):
        warnings.warn("no cut cells computed in the partition.", RuntimeWarning)
    if not np.any(ft == 1):
        raise ValueError("No interior facets (1)!")
    if not np.any(ft == 4):
        raise ValueError("No boundary facets (4)!")
