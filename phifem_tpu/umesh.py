"""Imported (unstructured) meshes: tagging + measures front-end.

The reference reads arbitrary XDMF meshes and runs its tagging pipeline on
them (``tests/test_compute_meshtags.py:136-137`` reads ``disk.xdmf``; 2 of
its 7 golden geometries live on that unstructured triangle mesh).  The
solver stack of this framework is deliberately structured-lattice-native
(see README "Scope"), but the *tagging/measures* layer — the reference
package's actual core, ``src/phifem/mesh_scripts.py`` — only needs cell
vertex coordinates and facet adjacency, so it generalizes to imported
meshes directly.

This module provides that front-end:

* :class:`UMesh` — an explicit simplicial/quad mesh (vertex coordinates +
  cell->vertex table).  Facets are derived as the lexicographically sorted
  unique vertex pairs, which reproduces dolfinx's entity-numbering rule
  (TopologyComputation sorts per-cell entity vertex keys before
  deduplicating), so facet numbering matches a dolfinx mesh with the same
  local vertex numbering.
* :func:`UMesh.from_xdmf` — reads the XDMF/HDF5 mesh layouts the reference
  uses (both meshio-written ``data0/data1`` and dolfinx-written
  ``Mesh/mesh/{geometry,topology}``).
* unstructured twins of the tagging pipeline (cells, facets, one-sided
  measures, submesh transfer), exposed through the SAME public entry point:
  ``compute_tags_measures(umesh, levelset, ...)`` dispatches here.

Everything runs as vectorized host numpy: imported meshes are a
preprocessing/parity surface (hundreds-to-thousands of irregular cells),
not the solve path — the device hot path stays on the implicit lattice where
connectivity is closed-form index arithmetic.

Note on cell numbering parity: dolfinx applies a Gibbs-Poole-Stockmeyer
reordering to cells when a mesh is read (``graph::reorder_gps`` inside
``mesh::create_mesh``), so an imported mesh's dolfinx cell ids are a
permutation of the file's cell order.  Tags themselves are
numbering-independent; the golden parity tests compare per-entity tag
*signatures* across all committed configurations (a permutation-free check
that is strictly stronger than per-config histograms).
"""

from __future__ import annotations

import dataclasses
import os
import warnings
import xml.etree.ElementTree as ET
from functools import cached_property
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from . import levelset as lsmod
from .elements import lagrange_element

__all__ = [
    "UMesh",
    "UDiscreteLevelset",
    "USideList",
    "USubmesh",
    "compute_tags_measures_unstructured",
]

# reference-cell vertex coordinates (tri: dolfinx order; quad: VTK ring)
_TRI_REF = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
_QUAD_REF = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
# local facet -> local vertex pair.  Triangle: edge i opposite vertex i
# (dolfinx convention); quad: VTK ring edges.
_TRI_EDGES = np.array([[1, 2], [0, 2], [0, 1]])
_QUAD_EDGES = np.array([[0, 1], [1, 2], [2, 3], [3, 0]])


@dataclasses.dataclass(frozen=True)
class UMesh:
    """Explicit 2D mesh: ``verts (nv, 2)`` float64, ``cells (nc, 3|4)``
    int32 (triangles in any vertex order; quadrilaterals in VTK ring
    order).  All derived connectivity is cached vectorized numpy."""

    verts: np.ndarray
    cells: np.ndarray

    def __post_init__(self):
        object.__setattr__(
            self, "verts", np.ascontiguousarray(self.verts, np.float64)
        )
        object.__setattr__(
            self, "cells", np.ascontiguousarray(self.cells, np.int32)
        )
        if self.cells.shape[1] not in (3, 4):
            raise ValueError("cells must be (nc, 3) triangles or (nc, 4) quads")

    # ------------------------------------------------------------- basics
    @property
    def dim(self) -> int:
        return 2

    @property
    def is_simplex(self) -> bool:
        return self.cells.shape[1] == 3

    @property
    def cell_name(self) -> str:
        return "triangle" if self.is_simplex else "quadrilateral"

    @property
    def cell_type(self):
        from .grid import CellType

        return CellType.triangle if self.is_simplex else CellType.quadrilateral

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.verts.shape[0]

    @property
    def num_facets(self) -> int:
        return self.facets.shape[0]

    @property
    def _local_edges(self) -> np.ndarray:
        return _TRI_EDGES if self.is_simplex else _QUAD_EDGES

    @property
    def _ref_verts(self) -> np.ndarray:
        return _TRI_REF if self.is_simplex else _QUAD_REF

    # ------------------------------------------------------- connectivity
    @cached_property
    def facets(self) -> np.ndarray:
        """(nf, 2) unique sorted vertex pairs in lexicographic order — the
        dolfinx facet-numbering rule."""
        e = np.sort(self.cells[:, self._local_edges].reshape(-1, 2), axis=1)
        return np.unique(e, axis=0).astype(np.int32)

    @cached_property
    def c2f(self) -> np.ndarray:
        """(nc, nfpc) facet id of each local facet."""
        e = np.sort(self.cells[:, self._local_edges].reshape(-1, 2), axis=1)
        f = self.facets
        # lexicographic rank of each edge within the unique facet table
        pos = np.searchsorted(
            f[:, 0].astype(np.int64) * (self.num_vertices + 1) + f[:, 1],
            e[:, 0].astype(np.int64) * (self.num_vertices + 1) + e[:, 1],
        )
        return pos.reshape(self.num_cells, -1).astype(np.int32)

    @cached_property
    def f2c(self) -> np.ndarray:
        """(nf, 2) adjacent cells, ascending, -1 padded."""
        nfpc = self._local_edges.shape[0]
        cid = np.repeat(np.arange(self.num_cells, dtype=np.int32), nfpc)
        fid = self.c2f.reshape(-1)
        order = np.argsort(fid, kind="stable")  # stable: cells ascending
        fid, cid = fid[order], cid[order]
        out = np.full((self.num_facets, 2), -1, np.int32)
        first = np.searchsorted(fid, np.arange(self.num_facets))
        counts = np.bincount(fid, minlength=self.num_facets)
        out[:, 0] = cid[np.minimum(first, len(cid) - 1)]
        has2 = counts == 2
        out[has2, 1] = cid[first[has2] + 1]
        if (counts > 2).any() or (counts == 0).any():
            raise ValueError("non-manifold or dangling facets in mesh")
        return out

    @cached_property
    def boundary_facet_mask(self) -> np.ndarray:
        return self.f2c[:, 1] < 0

    @cached_property
    def facet_endpoints(self) -> np.ndarray:
        """(nf, 2, 2) physical endpoint coordinates."""
        return self.verts[self.facets]

    @cached_property
    def facet_lengths(self) -> np.ndarray:
        d = self.facet_endpoints[:, 1] - self.facet_endpoints[:, 0]
        return np.sqrt((d**2).sum(axis=1))

    @cached_property
    def facet_base_normals(self) -> np.ndarray:
        """(nf, 2) unit normals of fixed (arbitrary) orientation; one-sided
        measures carry the per-entry sign making them outward."""
        d = self.facet_endpoints[:, 1] - self.facet_endpoints[:, 0]
        n = np.stack([d[:, 1], -d[:, 0]], axis=1)
        return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-300)

    @cached_property
    def cell_centroids(self) -> np.ndarray:
        return self.verts[self.cells].mean(axis=1)

    def local_facet_index(
        self, cells: np.ndarray, facets: np.ndarray
    ) -> np.ndarray:
        """Local index of ``facets[i]`` within ``cells[i]``."""
        match = self.c2f[cells] == facets[:, None]
        if not match.any(axis=1).all():
            raise ValueError("facet not adjacent to cell")
        return np.argmax(match, axis=1).astype(np.int32)

    # ------------------------------------------------------------ mapping
    def map_to_physical(self, ref_pts: np.ndarray) -> np.ndarray:
        """(nc, npts, 2) physical coordinates of the same reference points
        in every cell (affine for triangles, bilinear for quads)."""
        V = self.verts[self.cells]  # (nc, nverts, 2)
        r = ref_pts[None, :, 0, None]
        s = ref_pts[None, :, 1, None]
        if self.is_simplex:
            return (
                (1 - r - s) * V[:, None, 0]
                + r * V[:, None, 1]
                + s * V[:, None, 2]
            )
        return (
            (1 - r) * (1 - s) * V[:, None, 0]
            + r * (1 - s) * V[:, None, 1]
            + r * s * V[:, None, 2]
            + (1 - r) * s * V[:, None, 3]
        )

    # ----------------------------------------------------------- detection
    def detection_ref_points(self, N: int) -> np.ndarray:
        """Reference-cell boundary detection lattice (C1,
        ``mesh_scripts.py:28-92``)."""
        return lsmod.detection_points(self.cell_type, N)

    def boundary_trace_cut(self, ls: "ULevelSet", detection_degree: int) -> np.ndarray:
        """Per-cell boundary-trace-cut flag (reference
        ``mesh_scripts.py:434-452``: ds-measure detection aggregated per
        boundary cell)."""
        return _u_boundary_trace_cut(self, ls, detection_degree)

    # ---------------------------------------------------------------- I/O
    @staticmethod
    def from_xdmf(path: str) -> "UMesh":
        """Read an XDMF mesh (the reference's input format,
        ``tests/test_compute_meshtags.py:136-137``).  Supports the HDF5
        layouts in the reference checkout: meshio-style ``/dataN`` and
        dolfinx-style ``/Mesh/mesh/{geometry,topology}``."""
        import h5py

        root = ET.parse(path).getroot()
        topo_el = next(root.iter("Topology"), None)
        geo_el = next(root.iter("Geometry"), None)

        def _h5ref(el):
            item = next(el.iter("DataItem"))
            fname, dset = item.text.strip().split(":", 1)
            return os.path.join(os.path.dirname(path), fname), dset

        tf, td = _h5ref(topo_el)
        gf, gd = _h5ref(geo_el)
        with h5py.File(tf) as f:
            cells = np.asarray(f[td]).astype(np.int64)
        with h5py.File(gf) as f:
            verts = np.asarray(f[gd], np.float64)
        if verts.shape[1] == 3:  # 3D-padded 2D geometry
            verts = verts[:, :2]
        ttype = (topo_el.attrib.get("TopologyType") or "").lower()
        if cells.shape[1] == 4 and "quad" not in ttype:
            raise ValueError(f"unsupported topology {ttype}")
        return UMesh(verts, cells)

    @staticmethod
    def from_grid(grid) -> Tuple["UMesh", np.ndarray]:
        """Explicit copy of a structured :class:`~phifem_tpu.grid.Grid`.

        Returns ``(umesh, facet_map)`` where ``facet_map[u_facet] =
        grid_facet`` (the two numberings differ: the grid orders facets by
        family, UMesh lexicographically by vertex pair)."""
        cells = np.asarray(grid.cell_vertices_np)
        if not grid.is_simplex:
            cells = cells[:, [0, 1, 3, 2]]  # v00,v10,v01,v11 -> VTK ring
        m = UMesh(np.asarray(grid.vertex_coords_np, np.float64), cells)
        # match facets through endpoint vertex pairs
        ep = np.asarray(grid.facet_endpoints_np)  # (nf, 2, 2) coords
        vc = np.asarray(grid.vertex_coords_np)
        hx, hy = grid.hx, grid.hy
        kx = np.round((ep[..., 0] - grid.x0) / hx).astype(np.int64)
        ky = np.round((ep[..., 1] - grid.y0) / hy).astype(np.int64)
        vid = ky * (grid.nx + 1) + kx  # (nf, 2) vertex ids
        pairs = np.sort(vid, axis=1)
        key = pairs[:, 0] * (m.num_vertices + 1) + pairs[:, 1]
        fkey = m.facets[:, 0].astype(np.int64) * (m.num_vertices + 1) + m.facets[:, 1]
        order = np.argsort(key)
        facet_map = order[np.searchsorted(key[order], fkey)]
        assert (key[facet_map] == fkey).all()
        return m, facet_map.astype(np.int32)


# ---------------------------------------------------------------- levelsets
class UDiscreteLevelset:
    """Degree-k Lagrange interpolant of a callable on a :class:`UMesh`
    (the reference's ``discretize`` path: ``Function.interpolate`` then
    cell-local sampling during assembly).

    Evaluation never needs a global DoF map: the interpolant's per-cell
    nodal values are the callable at the cell's physical node coordinates,
    identical across shared nodes."""

    def __init__(self, mesh: UMesh, func: Callable, degree: int):
        self.mesh = mesh
        self.degree = degree
        self.element = lagrange_element(mesh.cell_name, degree)
        node_phys = mesh.map_to_physical(self.element.nodes)  # (nc, nloc, d)
        vals = np.asarray(func(node_phys.reshape(-1, mesh.dim)), np.float64)
        self.nodal = vals.reshape(mesh.num_cells, -1)  # (nc, nloc)

    def eval_ref(self, ref_pts: np.ndarray) -> np.ndarray:
        """(nc, npts): interpolant at the same reference points per cell."""
        tab = np.asarray(self.element.tabulate(ref_pts))  # (npts, nloc)
        return self.nodal @ tab.T

    def eval_cell_ref(self, cells: np.ndarray, ref_pts: np.ndarray) -> np.ndarray:
        """(n, npts): interpolant at per-cell reference points (n, npts, d)."""
        d = self.mesh.dim
        tab = np.asarray(
            self.element.tabulate(ref_pts.reshape(-1, d))
        ).reshape(ref_pts.shape[0], ref_pts.shape[1], -1)
        return np.einsum("cpl,cl->cp", tab, self.nodal[cells])


ULevelSet = Union[Callable, UDiscreteLevelset]


def _detection_values(mesh: UMesh, ls: ULevelSet, ref_pts: np.ndarray) -> np.ndarray:
    from .umesh3 import UDiscreteLevelset3

    if isinstance(ls, (UDiscreteLevelset, UDiscreteLevelset3)):
        return ls.eval_ref(ref_pts)
    phys = mesh.map_to_physical(ref_pts)
    return np.asarray(ls(phys.reshape(-1, mesh.dim)), np.float64).reshape(
        mesh.num_cells, -1
    )


def _sign_flags(vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return (vals > 0).any(axis=-1), (vals < 0).any(axis=-1)


def _classify(has_pos: np.ndarray, has_neg: np.ndarray) -> np.ndarray:
    inside = has_neg & ~has_pos
    outside = has_pos & ~has_neg
    return np.where(inside, 1, np.where(outside, 3, 2)).astype(np.int8)


# ------------------------------------------------------------------ tagging
def u_tag_cells(
    mesh: UMesh,
    ls: ULevelSet,
    detection_degree: int,
    single_layer_cut: bool = False,
    return_degenerate: bool = False,
):
    """Cell tags 1/2/3 (reference ``_tag_cells``, ``mesh_scripts.py:284-390``)
    on an imported mesh; same sign-classification semantics as the lattice
    path (:func:`phifem_tpu.tagging.tag_cells`)."""
    pts = mesh.detection_ref_points(detection_degree)
    vals = _detection_values(mesh, ls, pts)
    has_pos, has_neg = _sign_flags(vals)
    tags = _classify(has_pos, has_neg)
    n_degenerate = int((~has_pos & ~has_neg).sum())

    if single_layer_cut:
        # reference :304-315, 349-358: a cut cell is kept only if it shares
        # a vertex with an interior cell (v2c walk -> two dense passes)
        vflag = np.zeros(mesh.num_vertices, bool)
        vflag[mesh.cells[tags == 1].reshape(-1)] = True
        connected = vflag[mesh.cells].any(axis=1)
        tags = np.where((tags == 2) & ~connected, np.int8(3), tags)

    if return_degenerate:
        return tags, n_degenerate
    return tags


def _facet_cell_ref_points(
    mesh: UMesh, owner: np.ndarray, local: np.ndarray, N: int
) -> np.ndarray:
    """(n, npts, 2) owner-cell reference coordinates of the segment
    detection points on each facet."""
    t = lsmod.reference_segment_points(N)[:, 0]  # (npts,)
    lv = mesh._local_edges[local]  # (n, 2) local vertex indices
    ra = mesh._ref_verts[lv[:, 0]]  # (n, 2)
    rb = mesh._ref_verts[lv[:, 1]]
    return (
        ra[:, None, :] * (1.0 - t)[None, :, None]
        + rb[:, None, :] * t[None, :, None]
    )


def _u_boundary_trace_cut(
    mesh: UMesh, ls: ULevelSet, detection_degree: int
) -> np.ndarray:
    """Per-cell boundary-trace-cut flag (reference ``mesh_scripts.py:434-452``:
    ds-measure detection aggregated per boundary cell), unstructured twin of
    ``tagging._boundary_trace_cut``."""
    bf = np.where(mesh.boundary_facet_mask)[0]
    owner = mesh.f2c[bf, 0]
    local = mesh.local_facet_index(owner, bf)
    ref_pts = _facet_cell_ref_points(mesh, owner, local, detection_degree)
    if isinstance(ls, UDiscreteLevelset):
        vals = ls.eval_cell_ref(owner, ref_pts)
    else:
        V = mesh.verts[mesh.facets[bf]]  # (n, 2, 2) endpoints
        t = lsmod.reference_segment_points(detection_degree)[:, 0]
        phys = (
            V[:, None, 0] * (1.0 - t)[None, :, None]
            + V[:, None, 1] * t[None, :, None]
        )
        vals = np.asarray(ls(phys.reshape(-1, 2)), np.float64).reshape(
            len(bf), -1
        )
    fpos, fneg = _sign_flags(vals)
    cpos = np.zeros(mesh.num_cells, bool)
    cneg = np.zeros(mesh.num_cells, bool)
    np.logical_or.at(cpos, owner, fpos)
    np.logical_or.at(cneg, owner, fneg)
    is_bcell = np.zeros(mesh.num_cells, bool)
    is_bcell[owner] = True
    return (cpos == cneg) & is_bcell


def u_tag_facets(
    mesh: UMesh,
    cell_tags: np.ndarray,
    ls: ULevelSet,
    detection_degree: int,
) -> np.ndarray:
    """Facet tags 1..6 (reference ``_tag_facets``, ``mesh_scripts.py:393-558``)
    — the same per-facet rule table as the lattice path
    (:func:`phifem_tpu.tagging.tag_facets`), applied over the explicit f2c
    map instead of shifted slices.  Dimension-agnostic: only consumes
    ``f2c`` / ``boundary_facet_mask`` / ``boundary_trace_cut``, so it runs
    unchanged on :class:`~phifem_tpu.umesh3.UMesh3`."""
    trace_cut = mesh.boundary_trace_cut(ls, detection_degree)
    f2c = mesh.f2c
    t0 = cell_tags[f2c[:, 0]]
    t1 = np.where(f2c[:, 1] >= 0, cell_tags[np.maximum(f2c[:, 1], 0)], 0)
    is_bdry = mesh.boundary_facet_mask

    lo = np.minimum(t0, t1)
    hi = np.maximum(t0, t1)
    interior_tag = np.select(
        [
            (lo == 1) & (hi == 1),
            (lo == 1) & (hi == 2),
            (lo == 1) & (hi == 3),
            (lo == 2) & (hi == 2),
            (lo == 2) & (hi == 3),
        ],
        [1, 3, 6, 2, 4],
        default=5,
    )

    owner = f2c[:, 0]
    a_owner = cell_tags[owner]
    cut_or_bdry = np.where(trace_cut[owner], 2, 4)
    has_exterior = bool((cell_tags == 3).any())
    if has_exterior:
        bdry_tag = np.where(
            a_owner == 1, 1, np.where(a_owner == 2, cut_or_bdry, 5)
        )
    else:
        bdry_tag = np.where(a_owner == 1, 4, cut_or_bdry)
    return np.where(is_bdry, bdry_tag, interior_tag).astype(np.int8)


# ----------------------------------------------------------------- measures
@dataclasses.dataclass(frozen=True)
class USideList:
    """One-sided facet set on a :class:`UMesh` (host-array twin of
    :class:`~phifem_tpu.measures.FacetSideList`)."""

    mesh: UMesh
    facets: np.ndarray
    cells: np.ndarray
    local_facets: np.ndarray
    signs: np.ndarray

    @property
    def num_facets(self) -> int:
        return int(self.facets.shape[0])

    @property
    def normals(self) -> np.ndarray:
        """(n, 2) outward unit normals w.r.t. the chosen cells."""
        return self.mesh.facet_base_normals[self.facets] * self.signs[:, None]

    @property
    def lengths(self) -> np.ndarray:
        return self.mesh.facet_lengths[self.facets]

    def integration_entities(self) -> np.ndarray:
        """dolfinx-style raveled ``[c0, f0, c0, f1, ...]`` pairs
        (reference ``mesh_scripts.py:186-192``)."""
        return np.ravel(
            np.column_stack([self.cells, self.local_facets])
        ).astype(np.int32)


def u_one_sided(
    mesh: UMesh, facet_ids: np.ndarray, cell_tags: np.ndarray, side_tags: tuple
) -> USideList:
    """Choose, per facet, the adjacent cell whose tag is in ``side_tags``
    (reference ``_compute_integration_entities``, ``mesh_scripts.py:137-192``)."""
    facet_ids = np.asarray(facet_ids, np.int32)
    f2c = mesh.f2c[facet_ids]
    t0 = cell_tags[f2c[:, 0]]
    t1 = np.where(f2c[:, 1] >= 0, cell_tags[np.maximum(f2c[:, 1], 0)], -1)
    in0 = np.isin(t0, side_tags)
    in1 = np.isin(t1, side_tags) & (f2c[:, 1] >= 0)
    keep = in0 | in1
    facet_ids = facet_ids[keep]
    chosen = np.where(in0[keep], f2c[keep, 0], f2c[keep, 1]).astype(np.int32)
    local = mesh.local_facet_index(chosen, facet_ids)
    # outward sign: base normal points away from the chosen cell's centroid
    mid = mesh.facet_endpoints[facet_ids].mean(axis=1)
    d = mid - mesh.cell_centroids[chosen]
    dot = (mesh.facet_base_normals[facet_ids] * d).sum(axis=1)
    signs = np.where(dot >= 0, 1.0, -1.0)
    return USideList(mesh, facet_ids, chosen, local, signs)


# ------------------------------------------------------------------ submesh
@dataclasses.dataclass(frozen=True)
class USubmesh:
    """Active-cell view (Omega_h = cells tagged 1|2) of an imported mesh —
    twin of :class:`~phifem_tpu.tagging.Submesh` (reference
    ``create_submesh`` + ``_transfer_tags``, ``mesh_scripts.py:217-281``).
    Submesh facet order = ascending parent facet id, which (facets being
    lexicographic by vertex pair) matches dolfinx's monotone submesh
    renumbering."""

    parent: UMesh
    cells: np.ndarray
    facets: np.ndarray
    cell_tags: "EntityTags"
    facet_tags: "EntityTags"
    exterior: USideList

    @property
    def num_cells(self) -> int:
        return len(self.cells)


def _u_build_submesh(mesh: UMesh, ct: np.ndarray, ft: np.ndarray) -> USubmesh:
    from .tagging import EntityTags

    active = np.where((ct == 1) | (ct == 2))[0].astype(np.int32)
    facets = np.unique(mesh.c2f[active].reshape(-1)).astype(np.int32)

    f2c = mesh.f2c[facets]
    act = np.zeros(mesh.num_cells, bool)
    act[active] = True
    a0 = act[f2c[:, 0]]
    a1 = (f2c[:, 1] >= 0) & act[np.maximum(f2c[:, 1], 0)]
    ext = np.logical_xor(a0, a1)
    ext_facets = facets[ext]
    chosen = np.where(a0[ext], f2c[ext, 0], f2c[ext, 1]).astype(np.int32)
    local = mesh.local_facet_index(chosen, ext_facets)
    mid = mesh.facet_endpoints[ext_facets].mean(axis=1)
    d = mid - mesh.cell_centroids[chosen]
    dot = (mesh.facet_base_normals[ext_facets] * d).sum(axis=1)
    signs = np.where(dot >= 0, 1.0, -1.0)
    exterior = USideList(mesh, ext_facets, chosen, local, signs)

    return USubmesh(
        parent=mesh,
        cells=active,
        facets=facets,
        cell_tags=EntityTags("cell", ct[active]),
        facet_tags=EntityTags("facet", ft[facets]),
        exterior=exterior,
    )


# ------------------------------------------------------------------- public
def compute_tags_measures_unstructured(
    mesh: UMesh,
    levelset: ULevelSet,
    detection_degree: int,
    box_mode: bool = False,
    single_layer_cut: bool = False,
    overwrite: Optional[Dict[str, Dict[int, np.ndarray]]] = None,
):
    """Unstructured twin of :func:`phifem_tpu.tagging.compute_tags_measures`
    (reference ``compute_tags_measures``, ``mesh_scripts.py:571-653``);
    dispatched automatically when the public entry point receives a
    :class:`UMesh`."""
    from .measures import BoundaryMeasure
    from .tagging import EntityTags, TagsMeasures, overwrite_tags, _debug_mode, _check_invariants

    ct, ndeg = u_tag_cells(
        mesh, levelset, detection_degree, single_layer_cut, return_degenerate=True
    )
    if ndeg > 0:
        warnings.warn(
            f"{ndeg} cell(s) have an identically-zero (or NaN) level set at "
            "every detection point; they are classified as cut (reference "
            "degenerate-cell convention).",
            RuntimeWarning,
            stacklevel=2,
        )
    ft = u_tag_facets(mesh, ct, levelset, detection_degree)

    cells_tags = EntityTags("cell", ct)
    facets_tags = EntityTags("facet", ft)
    if overwrite:
        if "cells" in overwrite:
            cells_tags = overwrite_tags(cells_tags, overwrite["cells"], (1, 2, 3))
        if "facets" in overwrite:
            facets_tags = overwrite_tags(
                facets_tags, overwrite["facets"], (1, 2, 3, 4, 5, 6, 100, 101)
            )
    if _debug_mode():
        _check_invariants(cells_tags, facets_tags)

    ct = cells_tags.as_numpy()
    ft = facets_tags.as_numpy()
    if box_mode:
        measure = BoundaryMeasure(
            {
                100: u_one_sided(mesh, np.where(ft == 4)[0], ct, (1, 2)),
                101: u_one_sided(mesh, np.where(ft == 3)[0], ct, (2, 3)),
            }
        )
        return TagsMeasures(cells_tags, facets_tags, None, measure, None)

    sub = _u_build_submesh(mesh, ct, ft)
    measure = BoundaryMeasure({0: sub.exterior})
    return TagsMeasures(
        sub.cell_tags, sub.facet_tags, sub, measure, [sub.cells, sub.facets]
    )
