"""Reference finite elements: equispaced Lagrange P_k / Q_k and DG0.

Replaces the subset of basix the reference uses (``basix.ufl.element`` /
``mixed_element`` at e.g. reference ``demo/weak-dirichlet/flower/main.py:76-82``,
``demo/neumann/square/main.py:74-82``, ``demo/interface-elasticity/main.py:121-127``):
scalar/vector/tensor Lagrange of degree 1..3 on triangles and quadrilaterals
(plus tetrahedra for the imported-3D-mesh front-end — the reference is
2D-only) plus the DG0 test space used for cell-wise detection/error
localization (``src/phifem/mesh_scripts.py:107-110``).

Everything here is *static tabulation*: basis values/gradients/hessians at a
fixed set of reference points are computed once (float64 numpy) and become
compile-time constants inside jitted assembly kernels (small dense
matrices contracted against batched cell data).

Basis construction: monomial Vandermonde inverse on the equispaced node
lattice.  Node ordering (local) is the lattice enumeration (i fastest):

* triangle P_k: nodes (i/k, j/k) for j=0..k, i=0..k-j  (P1: v0,v1,v2)
* quad Q_k: nodes (i/k, j/k) for j=0..k, i=0..k        (Q1: v00,v10,v01,v11)
* tet P_k: nodes (i/k, j/k, l/k), l slow / j mid / i fast (P1: v0,v1,v2,v3)
* DG0: single node at the centroid, basis == 1
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Tuple

import numpy as np

__all__ = ["Element", "lagrange_element", "dg0_element"]


def _tri_lattice(k: int) -> np.ndarray:
    pts = [(i / k, j / k) for j in range(k + 1) for i in range(k + 1 - j)]
    return np.asarray(pts, dtype=np.float64)


def _quad_lattice(k: int) -> np.ndarray:
    pts = [(i / k, j / k) for j in range(k + 1) for i in range(k + 1)]
    return np.asarray(pts, dtype=np.float64)


def _tri_exponents(k: int) -> np.ndarray:
    return np.asarray(
        [(i, j) for j in range(k + 1) for i in range(k + 1 - j)], dtype=np.int64
    )


def _quad_exponents(k: int) -> np.ndarray:
    return np.asarray(
        [(i, j) for j in range(k + 1) for i in range(k + 1)], dtype=np.int64
    )


def _tet_lattice(k: int) -> np.ndarray:
    pts = [
        (i / k, j / k, l / k)
        for l in range(k + 1)
        for j in range(k + 1 - l)
        for i in range(k + 1 - l - j)
    ]
    return np.asarray(pts, dtype=np.float64)


def _tet_exponents(k: int) -> np.ndarray:
    return np.asarray(
        [
            (i, j, l)
            for l in range(k + 1)
            for j in range(k + 1 - l)
            for i in range(k + 1 - l - j)
        ],
        dtype=np.int64,
    )


def _monomials(pts: np.ndarray, exps: np.ndarray, dr: int = 0, ds: int = 0,
               deriv=None) -> np.ndarray:
    """Evaluate a mixed partial derivative of the monomials
    ``prod_a coord_a**exps[:, a]`` at ``pts (n, dim)``.  ``deriv`` is a
    per-coordinate derivative multi-index (len dim); the legacy 2D
    ``dr/ds`` keywords remain for callers predating the 3D extension."""
    if deriv is None:
        deriv = (dr, ds) + (0,) * (pts.shape[1] - 2)

    def dpow(base, e, d):
        coef = np.ones_like(e, dtype=np.float64)
        ee = e.astype(np.int64).copy()
        for _ in range(d):
            coef = coef * ee
            ee = np.maximum(ee - 1, 0)
        # np.power gives base**0 == 1 even at base == 0; coef == 0 kills
        # over-differentiated terms.
        return coef * np.power(base, ee)

    out = 1.0
    for a in range(pts.shape[1]):
        out = out * dpow(pts[:, a : a + 1], exps[:, a][None, :], deriv[a])
    return out


@dataclasses.dataclass(frozen=True)
class Element:
    """An immutable scalar reference element.

    ``family`` in {"Lagrange", "DG"}; ``cell`` in {"triangle",
    "quadrilateral"}; nodes/coeffs are numpy float64 (host constants).
    """

    family: str
    cell: str
    degree: int
    nodes: np.ndarray  # (nloc, 2) reference node coordinates
    _exps: np.ndarray  # (nloc, 2) monomial exponents
    _coeffs: np.ndarray  # (nloc_mono, nloc) columns = basis coefficients

    def __hash__(self):
        return hash((self.family, self.cell, self.degree))

    def __eq__(self, other):
        return (
            isinstance(other, Element)
            and (self.family, self.cell, self.degree)
            == (other.family, other.cell, other.degree)
        )

    @property
    def nloc(self) -> int:
        return self.nodes.shape[0]

    @property
    def dim(self) -> int:
        return self.nodes.shape[1]

    def _deriv(self, *d) -> tuple:
        return tuple(d) + (0,) * (self.dim - len(d))

    # Tabulation at reference points -> numpy constants
    def tabulate(self, pts: np.ndarray) -> np.ndarray:
        """(npts, nloc) basis values."""
        pts = np.atleast_2d(np.asarray(pts, np.float64))
        return _monomials(pts, self._exps) @ self._coeffs

    def tabulate_grad(self, pts: np.ndarray) -> np.ndarray:
        """(npts, nloc, dim) reference-coordinate gradients."""
        pts = np.atleast_2d(np.asarray(pts, np.float64))
        cols = []
        for a in range(self.dim):
            dv = [0] * self.dim
            dv[a] = 1
            cols.append(_monomials(pts, self._exps, deriv=tuple(dv)) @ self._coeffs)
        return np.stack(cols, axis=-1)

    def tabulate_hess(self, pts: np.ndarray) -> np.ndarray:
        """(npts, nloc, dim, dim) reference-coordinate second derivatives."""
        pts = np.atleast_2d(np.asarray(pts, np.float64))
        d = self.dim
        rows = []
        for a in range(d):
            row = []
            for b in range(d):
                dv = [0] * d
                dv[a] += 1
                dv[b] += 1
                row.append(
                    _monomials(pts, self._exps, deriv=tuple(dv)) @ self._coeffs
                )
            rows.append(np.stack(row, -1))
        return np.stack(rows, axis=-2)


@lru_cache(maxsize=None)
def lagrange_element(cell: str, degree: int) -> Element:
    """Equispaced Lagrange element of ``degree`` >= 1 on ``cell``."""
    if degree < 1:
        raise ValueError("Use dg0_element for degree 0.")
    if cell == "triangle":
        nodes, exps = _tri_lattice(degree), _tri_exponents(degree)
    elif cell == "quadrilateral":
        nodes, exps = _quad_lattice(degree), _quad_exponents(degree)
    elif cell == "tetrahedron":
        nodes, exps = _tet_lattice(degree), _tet_exponents(degree)
    else:
        raise ValueError(f"Unsupported cell type {cell!r}.")
    V = _monomials(nodes, exps)
    coeffs = np.linalg.inv(V)
    return Element("Lagrange", cell, degree, nodes, exps, coeffs)


@lru_cache(maxsize=None)
def dg0_element(cell: str) -> Element:
    node = np.array(
        {
            "triangle": [[1.0 / 3.0, 1.0 / 3.0]],
            "quadrilateral": [[0.5, 0.5]],
            "tetrahedron": [[0.25, 0.25, 0.25]],
        }[cell],
        np.float64,
    )
    exps = np.zeros((1, node.shape[1]), np.int64)
    coeffs = np.ones((1, 1), np.float64)
    return Element("DG", cell, 0, node, exps, coeffs)


def element_for(cell: str, family: str, degree: int) -> Element:
    if degree == 0 or family.upper() in ("DG0",):
        return dg0_element(cell)
    if family in ("Lagrange", "P", "CG"):
        return lagrange_element(cell, degree)
    if family == "DG" and degree == 0:
        return dg0_element(cell)
    raise ValueError(f"Unsupported element family {family!r} degree {degree}.")


# ---------------------------------------------------------------------------
# Local node classification (vertex / edge / interior) used by spaces.py to
# build global DoF maps with shared, consistently-oriented edge nodes.
# ---------------------------------------------------------------------------

def classify_nodes(element: Element) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Classify each local node of a Lagrange element.

    Returns (kind, entity, param):
      kind: 0 = vertex, 1 = edge, 2 = interior
      entity: local vertex index / local facet index / interior counter
      param: for edge nodes, the node parameter t in (0,1) along the *local*
             edge direction (vertex a -> vertex b of that local facet);
             0 otherwise.

    Local facet conventions must match ``Grid.c2f`` ordering:
      triangle: facet 0 = edge p0-p1, facet 1 = p1-p2, facet 2 = p0-p2
      quad:     facet 0 = left (p00-p01), 1 = right (p10-p11),
                2 = bottom (p00-p10), 3 = top (p01-p11)

    Tetrahedra (imported 3D meshes) use :func:`classify_nodes_tet` —
    four entity kinds (vertex/edge/face/interior) need a wider return.
    """
    if element.cell == "tetrahedron":
        raise ValueError("use classify_nodes_tet for tetrahedra")
    k = element.degree
    nodes = element.nodes
    kind = np.zeros(len(nodes), np.int64)
    entity = np.zeros(len(nodes), np.int64)
    param = np.zeros(len(nodes), np.float64)
    eps = 1e-12
    n_int = 0
    for m, (r, s) in enumerate(nodes):
        if element.cell == "triangle":
            on0, on1, on2 = abs(s) < eps, abs(r + s - 1) < eps, abs(r) < eps
            if (on0 and on2):
                kind[m], entity[m] = 0, 0
            elif (on0 and on1):
                kind[m], entity[m] = 0, 1
            elif (on1 and on2):
                kind[m], entity[m] = 0, 2
            elif on0:
                kind[m], entity[m], param[m] = 1, 0, r  # p0->p1
            elif on1:
                kind[m], entity[m], param[m] = 1, 1, s  # p1->p2
            elif on2:
                kind[m], entity[m], param[m] = 1, 2, s  # p0->p2
            else:
                kind[m], entity[m] = 2, n_int
                n_int += 1
        else:
            l, rr = abs(r) < eps, abs(r - 1) < eps
            b, t = abs(s) < eps, abs(s - 1) < eps
            if l and b:
                kind[m], entity[m] = 0, 0  # v00
            elif rr and b:
                kind[m], entity[m] = 0, 1  # v10
            elif l and t:
                kind[m], entity[m] = 0, 2  # v01
            elif rr and t:
                kind[m], entity[m] = 0, 3  # v11
            elif l:
                kind[m], entity[m], param[m] = 1, 0, s  # left bottom->top
            elif rr:
                kind[m], entity[m], param[m] = 1, 1, s  # right bottom->top
            elif b:
                kind[m], entity[m], param[m] = 1, 2, r  # bottom left->right
            elif t:
                kind[m], entity[m], param[m] = 1, 3, r  # top left->right
            else:
                kind[m], entity[m] = 2, n_int
                n_int += 1
    return kind, entity, param


# Local sub-entity tables of the reference tetrahedron (vertex order
# v0=(0,0,0), v1=(1,0,0), v2=(0,1,0), v3=(0,0,1)).  Edges lexicographic by
# vertex pair (the dolfinx rule); face i = vertices excluding i.
TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64
)
TET_FACES = np.array(
    [[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], np.int64
)


def classify_nodes_tet(element: Element):
    """Classify each local node of a Lagrange tet element by its
    barycentric zero pattern.

    Returns (kind, entity, param):
      kind: 0 = vertex, 1 = edge, 2 = face, 3 = interior
      entity: local vertex / edge (``TET_EDGES`` row) / face (``TET_FACES``
              row) / interior counter
      param: for edge nodes, t in (0,1) along the local edge a -> b;
             0 otherwise.

    Degree <= 3 only: at most one node per face, so no in-face numbering
    convention is needed (neighbouring cells agree trivially).
    """
    if element.cell != "tetrahedron":
        raise ValueError("classify_nodes_tet expects a tet element")
    if element.degree > 3:
        raise NotImplementedError(
            "tet degree > 3 needs an in-face node numbering convention"
        )
    nodes = element.nodes
    kind = np.zeros(len(nodes), np.int64)
    entity = np.zeros(len(nodes), np.int64)
    param = np.zeros(len(nodes), np.float64)
    eps = 1e-12
    n_int = 0
    for m, (r, s, t) in enumerate(nodes):
        lam = np.array([1.0 - r - s - t, r, s, t])
        nz = np.where(lam > eps)[0]
        if len(nz) == 1:
            kind[m], entity[m] = 0, nz[0]
        elif len(nz) == 2:
            a, b = nz
            e = int(np.where((TET_EDGES == [a, b]).all(axis=1))[0][0])
            kind[m], entity[m], param[m] = 1, e, lam[b]
        elif len(nz) == 3:
            missing = int(np.setdiff1d(np.arange(4), nz)[0])
            kind[m], entity[m] = 2, missing
        else:
            kind[m], entity[m] = 3, n_int
            n_int += 1
    return kind, entity, param
