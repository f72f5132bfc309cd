"""Imported (unstructured) tetrahedral meshes: 3D tagging + measures.

The reference package is strictly 2D (its only meshes are triangles/quads,
``src/phifem/mesh_scripts.py:43-92`` has no 3D detection lattice), so this
module is surpass-goal scope: the :mod:`phifem_tpu.umesh` front-end — the
tagging/measures pipeline of ``mesh_scripts.py`` — extended to imported
tetrahedral meshes.  The design mirrors ``UMesh`` exactly; everything
downstream (facet rule table, one-sided measures, submesh transfer, the
public ``compute_tags_measures`` entry point, and the unstructured
assembly/solve DSL of :mod:`phifem_tpu.uassembly`) is dimension-agnostic
and consumes :class:`UMesh3` through the same duck-typed surface:

* ``facets`` are faces — unique lexicographically sorted vertex triples
  (dolfinx's entity-numbering rule, as in 2D);
* ``facet_endpoints`` are the (nf, 3, 3) face vertex coordinates;
* ``facet_lengths`` are face AREAS (the facet measure — the name is kept
  for the duck-typed surface);
* detection points are the reference-tet boundary lattice — the natural
  3D extension of the reference's triangle/quad boundary lattices
  (``mesh_scripts.py:43-92``): all surface points of the degree-N
  barycentric lattice, N=0 -> centroid.

Host vectorized numpy throughout, like ``umesh.py``: imported meshes are a
preprocessing/parity surface; the device hot path stays on the implicit
lattice (``grid3.Grid3``).
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from functools import cached_property
from typing import Callable, Tuple, Union

import numpy as np

from .elements import TET_EDGES, TET_FACES, lagrange_element

__all__ = ["UMesh3", "UDiscreteLevelset3", "tet_boundary_points"]

# reference-tet vertex coordinates (v0 origin, then unit axes)
_TET_REF = np.array(
    [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
)


def tet_boundary_points(N: int) -> np.ndarray:
    """(npts, 3) boundary lattice of the reference tetrahedron: all points
    (i, j, l)/N of the degree-N barycentric lattice with at least one zero
    barycentric coordinate (i.e. on one of the 4 faces); N=0 -> centroid.
    The 3D extension of ``levelset.reference_triangle_boundary_points``
    (reference ``mesh_scripts.py:43-65``)."""
    if N == 0:
        return np.array([[0.25, 0.25, 0.25]])
    pts = []
    for l in range(N + 1):
        for j in range(N + 1 - l):
            for i in range(N + 1 - l - j):
                k0 = N - i - j - l
                if i == 0 or j == 0 or l == 0 or k0 == 0:
                    pts.append((i / N, j / N, l / N))
    return np.asarray(pts, np.float64)


def triangle_lattice_points(N: int) -> np.ndarray:
    """(npts, 2) full barycentric lattice of the reference triangle
    (vertices + edges + interior), N=0 -> centroid — the per-face
    detection rule for boundary faces."""
    if N == 0:
        return np.array([[1.0 / 3.0, 1.0 / 3.0]])
    pts = [
        (i / N, j / N)
        for j in range(N + 1)
        for i in range(N + 1 - j)
    ]
    return np.asarray(pts, np.float64)


@dataclasses.dataclass(frozen=True)
class UMesh3:
    """Explicit tetrahedral mesh: ``verts (nv, 3)`` float64, ``cells
    (nc, 4)`` int32 (any vertex order).  Duck-types :class:`UMesh` for the
    shared tagging/measures/assembly machinery."""

    verts: np.ndarray
    cells: np.ndarray

    def __post_init__(self):
        object.__setattr__(
            self, "verts", np.ascontiguousarray(self.verts, np.float64)
        )
        object.__setattr__(
            self, "cells", np.ascontiguousarray(self.cells, np.int32)
        )
        if self.verts.shape[1] != 3 or self.cells.shape[1] != 4:
            raise ValueError("UMesh3 needs (nv, 3) verts and (nc, 4) tets")

    # ------------------------------------------------------------- basics
    @property
    def dim(self) -> int:
        return 3

    @property
    def is_simplex(self) -> bool:
        return True

    @property
    def cell_name(self) -> str:
        return "tetrahedron"

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
    def _local_faces(self) -> np.ndarray:
        return TET_FACES

    @property
    def _ref_verts(self) -> np.ndarray:
        return _TET_REF

    # ------------------------------------------------------- connectivity
    @cached_property
    def facets(self) -> np.ndarray:
        """(nf, 3) unique sorted vertex triples in lexicographic order —
        the dolfinx facet-numbering rule."""
        t = np.sort(self.cells[:, TET_FACES].reshape(-1, 3), axis=1)
        return np.unique(t, axis=0).astype(np.int32)

    @cached_property
    def c2f(self) -> np.ndarray:
        """(nc, 4) facet id of each local face (face i opposite vertex i)."""
        t = np.sort(self.cells[:, TET_FACES].reshape(-1, 3), axis=1)
        _, inv = np.unique(t, axis=0, return_inverse=True)
        return inv.reshape(self.num_cells, 4).astype(np.int32)

    @cached_property
    def f2c(self) -> np.ndarray:
        """(nf, 2) adjacent cells, ascending, -1 padded."""
        cid = np.repeat(np.arange(self.num_cells, dtype=np.int32), 4)
        fid = self.c2f.reshape(-1)
        order = np.argsort(fid, kind="stable")
        fid, cid = fid[order], cid[order]
        out = np.full((self.num_facets, 2), -1, np.int32)
        first = np.searchsorted(fid, np.arange(self.num_facets))
        counts = np.bincount(fid, minlength=self.num_facets)
        out[:, 0] = cid[np.minimum(first, len(cid) - 1)]
        has2 = counts == 2
        out[has2, 1] = cid[first[has2] + 1]
        if (counts > 2).any() or (counts == 0).any():
            raise ValueError("non-manifold or dangling faces in mesh")
        return out

    @cached_property
    def edges(self) -> np.ndarray:
        """(ne, 2) unique sorted vertex pairs (lexicographic) — needed for
        degree >= 2 DoF maps."""
        e = np.sort(self.cells[:, TET_EDGES].reshape(-1, 2), axis=1)
        return np.unique(e, axis=0).astype(np.int32)

    @cached_property
    def c2e(self) -> np.ndarray:
        """(nc, 6) edge id of each local edge (``TET_EDGES`` rows)."""
        e = np.sort(self.cells[:, TET_EDGES].reshape(-1, 2), axis=1)
        _, inv = np.unique(e, axis=0, return_inverse=True)
        return inv.reshape(self.num_cells, 6).astype(np.int32)

    @cached_property
    def boundary_facet_mask(self) -> np.ndarray:
        return self.f2c[:, 1] < 0

    @cached_property
    def facet_endpoints(self) -> np.ndarray:
        """(nf, 3, 3) physical face vertex coordinates."""
        return self.verts[self.facets]

    @cached_property
    def facet_lengths(self) -> np.ndarray:
        """Face AREAS (the facet measure; name kept for the duck-typed
        2D/3D surface)."""
        V = self.facet_endpoints
        c = np.cross(V[:, 1] - V[:, 0], V[:, 2] - V[:, 0])
        return 0.5 * np.linalg.norm(c, axis=1)

    @cached_property
    def facet_base_normals(self) -> np.ndarray:
        """(nf, 3) unit normals of fixed (arbitrary) orientation; one-sided
        measures carry the per-entry sign making them outward."""
        V = self.facet_endpoints
        c = np.cross(V[:, 1] - V[:, 0], V[:, 2] - V[:, 0])
        return c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-300)

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
        """(nc, npts, 3) physical coordinates of the same reference points
        in every cell (affine)."""
        V = self.verts[self.cells]  # (nc, 4, 3)
        r = ref_pts[None, :, 0, None]
        s = ref_pts[None, :, 1, None]
        t = ref_pts[None, :, 2, None]
        return (
            (1 - r - s - t) * V[:, None, 0]
            + r * V[:, None, 1]
            + s * V[:, None, 2]
            + t * V[:, None, 3]
        )

    # ----------------------------------------------------------- detection
    def detection_ref_points(self, N: int) -> np.ndarray:
        return tet_boundary_points(N)

    def boundary_trace_cut(self, ls, detection_degree: int) -> np.ndarray:
        """Per-cell boundary-trace-cut flag: the face-lattice detection of
        the 2D rule (reference ``mesh_scripts.py:434-452``) evaluated on
        each boundary FACE and aggregated per owner cell."""
        from .umesh import UDiscreteLevelset, _sign_flags

        bf = np.where(self.boundary_facet_mask)[0]
        owner = self.f2c[bf, 0]
        lam2 = triangle_lattice_points(detection_degree)  # (np, 2)
        lam = np.concatenate(
            [1.0 - lam2.sum(axis=1, keepdims=True), lam2], axis=1
        )  # (np, 3) barycentric on the face
        V = self.verts[self.facets[bf]]  # (n, 3, 3)
        phys = np.einsum("pk,nkx->npx", lam, V)
        if isinstance(ls, (UDiscreteLevelset, UDiscreteLevelset3)):
            # locate the face points in the owner cell's reference coords
            p0, Jinv, _, _ = _cell_geometry3(self, owner)
            ref = np.einsum("nrx,npx->npr", Jinv, phys - p0[:, None, :])
            vals = ls.eval_cell_ref(owner, ref)
        else:
            vals = np.asarray(ls(phys.reshape(-1, 3)), np.float64).reshape(
                len(bf), -1
            )
        fpos, fneg = _sign_flags(vals)
        cpos = np.zeros(self.num_cells, bool)
        cneg = np.zeros(self.num_cells, bool)
        np.logical_or.at(cpos, owner, fpos)
        np.logical_or.at(cneg, owner, fneg)
        is_bcell = np.zeros(self.num_cells, bool)
        is_bcell[owner] = True
        return (cpos == cneg) & is_bcell

    # ---------------------------------------------------------------- I/O
    @staticmethod
    def from_xdmf(path: str) -> "UMesh3":
        """Read a tetrahedral XDMF mesh (same HDF5 layouts as
        :meth:`UMesh.from_xdmf`)."""
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
        if cells.shape[1] != 4 or verts.shape[1] != 3:
            raise ValueError("not a tetrahedral 3D mesh")
        return UMesh3(verts, cells)

    @staticmethod
    def box(
        nx: int, ny: int, nz: int, bounds=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    ) -> "UMesh3":
        """Structured tetrahedral box: each hex cell split into 6 tets by
        the Kuhn (permutation) triangulation — conforming across cells and
        uniform, the 3D twin of ``create_rectangle``'s crossed triangles.
        This is the test/demo mesh generator (the reference has no 3D at
        all); real workflows import XDMF."""
        (x0, y0, z0), (x1, y1, z1) = bounds
        xs = np.linspace(x0, x1, nx + 1)
        ys = np.linspace(y0, y1, ny + 1)
        zs = np.linspace(z0, z1, nz + 1)
        X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
        verts = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], -1)

        def vid(i, j, k):
            return (i * (ny + 1) + j) * (nz + 1) + k

        I, J, K = np.meshgrid(
            np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
        )
        I, J, K = I.reshape(-1), J.reshape(-1), K.reshape(-1)
        # Kuhn: tets are chains 0 -> e_p0 -> e_p0+e_p1 -> (1,1,1) over the
        # 6 axis orderings
        import itertools

        axes = np.eye(3, dtype=np.int64)
        cells = []
        for perm in itertools.permutations(range(3)):
            s1 = axes[perm[0]]
            s2 = s1 + axes[perm[1]]
            corners = [(0, 0, 0), tuple(s1), tuple(s2), (1, 1, 1)]
            cells.append(
                np.stack(
                    [vid(I + di, J + dj, K + dk) for (di, dj, dk) in corners],
                    axis=-1,
                )
            )
        cells = np.concatenate(cells, axis=0)
        return UMesh3(verts, cells)


# --------------------------------------------------------------- levelsets
class UDiscreteLevelset3:
    """Degree-k Lagrange interpolant of a callable on a :class:`UMesh3`
    (3D twin of :class:`~phifem_tpu.umesh.UDiscreteLevelset`)."""

    def __init__(self, mesh: UMesh3, func: Callable, degree: int):
        self.mesh = mesh
        self.degree = degree
        self.element = lagrange_element("tetrahedron", degree)
        node_phys = mesh.map_to_physical(self.element.nodes)
        vals = np.asarray(func(node_phys.reshape(-1, 3)), np.float64)
        self.nodal = vals.reshape(mesh.num_cells, -1)

    def eval_ref(self, ref_pts: np.ndarray) -> np.ndarray:
        tab = np.asarray(self.element.tabulate(ref_pts))
        return self.nodal @ tab.T

    def eval_cell_ref(self, cells: np.ndarray, ref_pts: np.ndarray) -> np.ndarray:
        tab = np.asarray(
            self.element.tabulate(ref_pts.reshape(-1, 3))
        ).reshape(ref_pts.shape[0], ref_pts.shape[1], -1)
        return np.einsum("cpl,cl->cp", tab, self.nodal[cells])


def _cell_geometry3(mesh: UMesh3, cells: np.ndarray):
    """Per-cell affine geometry (3D twin of ``uassembly._cell_geometry``):
    ``(p0 (ne,3), Jinv (ne,3,3), absdet (ne,), h (ne,))`` with
    ``Jinv[r, x] = d ref_r / d x``."""
    V = mesh.verts[mesh.cells[cells]]  # (ne, 4, 3)
    p0 = V[:, 0]
    J = np.stack([V[:, 1] - p0, V[:, 2] - p0, V[:, 3] - p0], axis=-1)
    det = np.linalg.det(J)
    Jinv = np.linalg.inv(J)
    # h = max edge length over the 6 tet edges
    E = V[:, TET_EDGES]  # (ne, 6, 2, 3)
    h = np.linalg.norm(E[:, :, 1] - E[:, :, 0], axis=-1).max(axis=1)
    return p0, Jinv, np.abs(det), h
