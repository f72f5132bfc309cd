"""2D lattice-resident geometric multigrid for uniform P1 box problems.

The north-star bench path (BASELINE.md: sub-second 10M-DoF Poisson CG to
1e-10 relative residual).  The reduced operator of a uniform single-scalar
P1 cell term with Dirichlet conditions on the box boundary is EXACTLY a
constant-coefficient 9-point vertex stencil applied to the zero-extended
interior: every interior vertex touches a full ring of cells, so its
operator row equals the aggregated vertex-stencil weights, and boundary
rows are identity (BC).  On the standard right-triangle split the P1
stiffness stencil degenerates to the classic 5-point Laplacian (the
diagonal couplings cancel), so the matvec is 5 shifted adds.

That makes the whole MG-preconditioned CG solver expressible as
gather-form shifted-slice arithmetic on 2D ``(rows, cols)`` arrays — no
gathers, scatters, region masks, pack/unpack or flat<->lattice reshapes
anywhere on the hot path.  XLA fuses each stage (Jacobi sweep, residual,
full-weighting restriction, bilinear prolongation-and-correct) into a few
memory passes, which is the bandwidth bound of this computation; the
float64 outer CG rides the same convolution (one fine matvec per
iteration next to the f32 V-cycle).

Replaces (for this problem class) the flat-vector V-cycle in
:mod:`phifem_tpu.mg`, whose per-level pack/unpack + scatter-add transfers
measured ~22 ms per cycle at 1M DoFs vs ~0.5 ms for the raw stencil
matvec.  Reference counterpart: the PETSc/MUMPS direct solve
(``demo/weak-dirichlet/flower/main.py:162-182``) — the reference has no
multigrid; this is the scalable matrix-free equivalent.

Layout: ``(R+2, C+2)`` padded arrays for an ``R x C`` vertex lattice
(``R = ny+1``); logical node ``(r, c)`` lives at ``[1+r, 1+c]``.  For
*reduced* vectors (Krylov iterates, residuals) the padding ring AND the
logical boundary ring stay identically zero, so the active interior is
``[2:R, 2:C]``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import HIGHEST

Array = jnp.ndarray

__all__ = [
    "vertex_stencil_weights",
    "block_vertex_stencil_weights",
    "LatticeMG",
    "LatticeBlockMG",
    "LatticeVarMG",
    "build_lattice_mg",
    "build_lattice_block_mg",
    "build_lattice_var_mg",
    "cell_stencil_maps",
    "orientation_cell_masks",
    "lattice_cg",
]


def vertex_stencil_weights(mats, offs_per_orient) -> np.ndarray:
    """Aggregate per-orientation element matrices into the (3, 3) vertex
    stencil ``w[1+dy, 1+dx]`` valid at every interior lattice vertex.

    ``y[v] = sum_cells sum_{i: node_i=v} sum_j A[i,j] x[node_j]``; for an
    interior vertex every (orientation, i, j) combination occurs exactly
    once, displaced by ``off_j - off_i``.
    """
    w = np.zeros((3, 3))
    mats = np.asarray(mats, np.float64)
    for o, offs in enumerate(offs_per_orient):
        for i, (dxi, dyi) in enumerate(offs):
            for j, (dxj, dyj) in enumerate(offs):
                w[1 + dyj - dyi, 1 + dxj - dxi] += mats[o, i, j]
    return w


def _terms(w: np.ndarray) -> List[Tuple[int, int, float]]:
    """Nonzero (a, b, weight) triples — zero couplings (e.g. the diagonal
    terms of the triangle stiffness stencil) are dropped at trace time."""
    out = []
    for a in range(3):
        for b in range(3):
            if abs(w[a, b]) > 1e-14 * max(1e-300, np.abs(w).max()):
                out.append((a, b, float(w[a, b])))
    return out


@dataclasses.dataclass(frozen=True)
class _Level:
    R: int  # logical lattice rows (ny + 1)
    C: int  # logical lattice cols (nx + 1)


def _conv_interior(xp: Array, terms, R: int, C: int) -> Array:
    """(A x) at the logical-interior nodes: shape (R-2, C-2).

    Interior node ``r in [1, R-2]`` reads padded rows ``r + a`` for
    ``a in {0,1,2}`` — pure static slices, fused by XLA into one pass.
    """
    dt = xp.dtype
    acc = None
    for a, b, wt in terms:
        part = jnp.asarray(wt, dt) * xp[a + 1 : a + R - 1, b + 1 : b + C - 1]
        acc = part if acc is None else acc + part
    return acc


def _embed(v: Array, R: int, C: int) -> Array:
    """Zero-embed a logical-interior (R-2, C-2) block into padded (R+2, C+2)."""
    out = jnp.zeros((R + 2, C + 2), v.dtype)
    return out.at[2:R, 2:C].set(v)


def _interleave_cols(A: Array, H: Array) -> Array:
    """[a0 h0 a1 h1 ... a_{m-1}] from A (r, m) and H (r, m-1)."""
    r, m = A.shape
    body = jnp.stack([A[:, : m - 1], H], axis=2).reshape(r, 2 * (m - 1))
    return jnp.concatenate([body, A[:, m - 1 :]], axis=1)


def _interleave_rows(A: Array, H: Array) -> Array:
    m, c = A.shape
    body = jnp.stack([A[: m - 1], H], axis=1).reshape(2 * (m - 1), c)
    return jnp.concatenate([body, A[m - 1 :]], axis=0)


def _prolong(Ecp: Array, Rc: int, Cc: int) -> Array:
    """Bilinear prolongation, interleave form (no strided scatters).

    Input: coarse padded (Rc+2, Cc+2) reduced vector.  Output: the fine
    logical (R, C) = (2Rc-1, 2Cc-1) lattice of corrections (boundary rows
    are zero because the coarse boundary ring is zero).
    """
    E = Ecp[1 : 1 + Rc, 1 : 1 + Cc]
    Hc = 0.5 * (E[:, :-1] + E[:, 1:])
    W = _interleave_cols(E, Hc)  # (Rc, 2Cc-1)
    Hr = 0.5 * (W[:-1] + W[1:])
    return _interleave_rows(W, Hr)  # (2Rc-1, 2Cc-1)


def _restrict(r_int: Array, Rc: int, Cc: int) -> Array:
    """Full-weighting restriction (transpose of bilinear prolongation,
    weight sum 4 — the correct scaling between re-discretized scale-free
    operators in 2D).  ``r_int``: fine logical-interior (R-2, C-2) with
    the convention that the fine boundary residual is zero.  Returns the
    coarse padded (Rc+2, Cc+2) reduced vector.
    """
    out = None
    # coarse interior i in [1, Rc-2] reads fine logical rows 2i+s,
    # s in {-1,0,1}; r_int index = logical - 1 -> start s+1, stride 2
    n_i, n_j = Rc - 2, Cc - 2
    for s, ws in ((-1, 0.5), (0, 1.0), (1, 0.5)):
        rows = r_int[1 + s :: 2][:n_i]
        for t, wt in ((-1, 0.5), (0, 1.0), (1, 0.5)):
            part = (ws * wt) * rows[:, 1 + t :: 2][:, :n_j]
            out = part if out is None else out + part
    return _embed(out.astype(r_int.dtype), Rc, Cc)


def _dense_coarse_inv(
    terms, R: int, C: int, mask: Optional[np.ndarray] = None
) -> np.ndarray:
    """Exact inverse of the reduced operator on the coarsest interior.
    ``mask``: optional (R, C) bool of active logical nodes — inactive
    rows/cols become identity (they carry zero residual)."""
    ni, nj = R - 2, C - 2
    n = ni * nj
    A = np.zeros((n, n))
    for a, b, wt in terms:
        dy, dx = a - 1, b - 1
        for i in range(ni):
            i2 = i + dy
            if not (0 <= i2 < ni):
                continue
            for j in range(nj):
                j2 = j + dx
                if 0 <= j2 < nj:
                    A[i * nj + j, i2 * nj + j2] += wt
    if mask is not None:
        act = np.asarray(mask[1 : R - 1, 1 : C - 1], bool).reshape(-1)
        A[~act, :] = 0.0
        A[:, ~act] = 0.0
        A[np.diag_indices(n)[0][~act], np.diag_indices(n)[1][~act]] = 1.0
    return np.linalg.inv(A)


def _coarsen_mask(m: np.ndarray) -> np.ndarray:
    """Coarse-level active mask: coarse vertex (i, j) is active when any
    fine vertex in the 3x3 bilinear support of (2i, 2j) is active (the
    correction from an inactive-by-this-rule coarse DoF could not help
    any active fine DoF)."""
    R, C = m.shape
    p = np.zeros((R + 2, C + 2), bool)
    p[1 : 1 + R, 1 : 1 + C] = m
    pool = np.zeros_like(m)
    for s in (0, 1, 2):
        for t in (0, 1, 2):
            pool |= p[s : s + R, t : t + C]
    return pool[::2, ::2].copy()


@dataclasses.dataclass
class LatticeMG:
    """V-cycle preconditioner on 2D padded lattices.

    ``__call__(bp)`` treats ``bp`` (padded, reduced) as a right-hand side
    and returns an approximate ``A^{-1} bp`` computed in ``dtype``
    (float32 by default), cast back to the input dtype.
    """

    levels: List[_Level]
    terms: List[Tuple[int, int, float]]
    coarse_inv: Array  # (n, n) dense inverse on the coarsest interior
    dtype: jnp.dtype = jnp.float32
    omega: float = 0.8
    pre_smooth: int = 2
    post_smooth: int = 2
    # optional per-level active masks, logical (R, C) in compute dtype
    # (1 = active): a domain-restricted problem (phi-FEM bulk on Omega_h)
    # smooths/corrects only on active nodes; levels coarsened from the
    # fine mask by 3x3-support pooling (_coarsen_mask) — NO re-tagging
    masks: Optional[List[Array]] = None

    def __post_init__(self):
        self._dinv = 1.0 / next(wt for a, b, wt in self.terms if a == 1 and b == 1)

    def _mask_int(self, k: int, R: int, C: int):
        if self.masks is None:
            return None
        return self.masks[k][1 : R - 1, 1 : C - 1]

    # -- fused Jacobi sweep: x += omega * dinv * (b - A x) on the interior
    def _smooth(self, xp, bp, lvl: _Level, k: int, sweeps: int):
        R, C = lvl.R, lvl.C
        od = jnp.asarray(self.omega * self._dinv, xp.dtype)
        m = self._mask_int(k, R, C)
        for _ in range(sweeps):
            r = bp[2:R, 2:C] - _conv_interior(xp, self.terms, R, C)
            upd = od * r if m is None else od * r * m
            xp = xp.at[2:R, 2:C].add(upd)
        return xp

    def _cycle(self, k: int, bp):
        lvl = self.levels[k]
        R, C = lvl.R, lvl.C
        if k == len(self.levels) - 1:
            v = jnp.matmul(
                self.coarse_inv.astype(bp.dtype),
                bp[2:R, 2:C].reshape(-1),
                precision=HIGHEST,
            )
            return _embed(v.reshape(R - 2, C - 2), R, C)
        xp = self._smooth(jnp.zeros_like(bp), bp, lvl, k, self.pre_smooth)
        r_int = bp[2:R, 2:C] - _conv_interior(xp, self.terms, R, C)
        m = self._mask_int(k, R, C)
        if m is not None:
            r_int = r_int * m  # inactive-row residuals must not restrict
        nxt = self.levels[k + 1]
        bc = _restrict(r_int, nxt.R, nxt.C)
        if self.masks is not None:
            bc = bc * _embed(
                self.masks[k + 1][1:-1, 1:-1], nxt.R, nxt.C
            )
        ec = self._cycle(k + 1, bc)
        corr = _prolong(ec, nxt.R, nxt.C)  # fine logical (R, C)
        if self.masks is not None:
            corr = corr * self.masks[k]
        xp = xp.at[2:R, 2:C].add(corr[1:-1, 1:-1])
        return self._smooth(xp, bp, lvl, k, self.post_smooth)

    def __call__(self, bp: Array) -> Array:
        in_dt = bp.dtype
        if in_dt != self.dtype:
            bp = bp.astype(self.dtype)
        xp = self._cycle(0, bp)
        return xp.astype(in_dt)


def build_lattice_mg(
    nx: int,
    ny: int,
    w: np.ndarray,
    min_n: int = 16,
    dtype=jnp.float32,
    mask: Optional[np.ndarray] = None,
    **kw,
) -> LatticeMG:
    """Build the V-cycle for an ``nx x ny``-block lattice with vertex
    stencil ``w``.  The 2D P1 stiffness stencil is refinement-invariant,
    so every level shares ``w`` — no per-level assembly at all.

    ``mask``: optional (ny+1, nx+1) bool of active logical vertices
    (phi-FEM Omega_h bulk); coarser levels pool it (``_coarsen_mask``).
    """
    levels = [_Level(ny + 1, nx + 1)]
    while (
        nx % 2 == 0 and ny % 2 == 0 and nx // 2 >= min_n and ny // 2 >= min_n
    ):
        nx //= 2
        ny //= 2
        levels.append(_Level(ny + 1, nx + 1))
    terms = _terms(np.asarray(w))
    lvl_masks = None
    coarse_mask = None
    if mask is not None:
        m = np.asarray(mask, bool)
        masks_np = [m]
        for _ in levels[1:]:
            m = _coarsen_mask(m)
            masks_np.append(m)
        coarse_mask = masks_np[-1]
        lvl_masks = [jnp.asarray(mm, dtype) for mm in masks_np]
    inv = _dense_coarse_inv(terms, levels[-1].R, levels[-1].C, coarse_mask)
    return LatticeMG(
        levels, terms, jnp.asarray(inv, dtype), dtype=dtype, masks=lvl_masks, **kw
    )


def block_vertex_stencil_weights(mats, offs_per_orient, vsz: int) -> np.ndarray:
    """Aggregate per-orientation VECTOR element matrices into the
    (3, 3, vsz, vsz) block vertex stencil (the (2x2)-block generalization
    of :func:`vertex_stencil_weights` — e.g. the S5 elasticity bulk).

    Local column layout is node-major / component-minor, matching the
    assembly gather order.
    """
    w = np.zeros((3, 3, vsz, vsz))
    mats = np.asarray(mats, np.float64)
    for o, offs in enumerate(offs_per_orient):
        for i, (dxi, dyi) in enumerate(offs):
            for j, (dxj, dyj) in enumerate(offs):
                w[1 + dyj - dyi, 1 + dxj - dxi] += mats[
                    o, i * vsz : (i + 1) * vsz, j * vsz : (j + 1) * vsz
                ]
    return w


def _block_terms(w: np.ndarray) -> List[Tuple[int, int, np.ndarray]]:
    """Nonzero (a, b, (vsz, vsz) block) triples of a block stencil."""
    out = []
    scale = max(1e-300, np.abs(w).max())
    for a in range(3):
        for b in range(3):
            if np.abs(w[a, b]).max() > 1e-14 * scale:
                out.append((a, b, w[a, b].copy()))
    return out


def _conv_interior_block(xp: Array, terms, W: Array, R: int, C: int) -> Array:
    """(A x) at the logical-interior nodes for channels-first block
    lattices: ``xp`` (vsz, R+2, C+2) -> (vsz, R-2, C-2).

    ``W`` stacks the per-term (vsz, vsz) blocks (len(terms), vsz, vsz) in
    the compute dtype."""
    acc = None
    for t, (a, b, _) in enumerate(terms):
        xs = xp[:, a + 1 : a + R - 1, b + 1 : b + C - 1]
        part = jnp.einsum("ij,jrc->irc", W[t], xs, precision=HIGHEST)
        acc = part if acc is None else acc + part
    return acc


def _dense_coarse_inv_block(
    terms, R: int, C: int, vsz: int, mask: Optional[np.ndarray] = None
) -> np.ndarray:
    """Exact inverse of the reduced block operator on the coarsest
    interior; flat index = (node_row * nj + node_col) * vsz + comp."""
    ni, nj = R - 2, C - 2
    n = ni * nj * vsz
    A = np.zeros((n, n))
    for a, b, Wb in terms:
        dy, dx = a - 1, b - 1
        for i in range(ni):
            i2 = i + dy
            if not (0 <= i2 < ni):
                continue
            for j in range(nj):
                j2 = j + dx
                if 0 <= j2 < nj:
                    r0 = (i * nj + j) * vsz
                    c0 = (i2 * nj + j2) * vsz
                    A[r0 : r0 + vsz, c0 : c0 + vsz] += Wb
    if mask is not None:
        act = np.repeat(
            np.asarray(mask[1 : R - 1, 1 : C - 1], bool).reshape(-1), vsz
        )
        A[~act, :] = 0.0
        A[:, ~act] = 0.0
        idx = np.where(~act)[0]
        A[idx, idx] = 1.0
    return np.linalg.inv(A)


@dataclasses.dataclass
class LatticeBlockMG:
    """Block (multi-channel) V-cycle on channels-first padded lattices
    (vsz, R+2, C+2) — the vector-field generalization of
    :class:`LatticeMG` (S5 elasticity bulk: vsz=2).

    Smoothing is block Jacobi with the constant interior (vsz, vsz)
    diagonal-block inverse; transfers are componentwise bilinear
    (vmapped over the channel axis)."""

    levels: List[_Level]
    terms: List[Tuple[int, int, np.ndarray]]
    coarse_inv: Array
    vsz: int
    dtype: jnp.dtype = jnp.float32
    omega: float = 0.8
    pre_smooth: int = 2
    post_smooth: int = 2
    masks: Optional[List[Array]] = None  # per-level (R, C), channel-shared

    def __post_init__(self):
        d = next(Wb for a, b, Wb in self.terms if a == 1 and b == 1)
        self._dinv = jnp.asarray(np.linalg.inv(d), self.dtype)
        self._W = jnp.asarray(
            np.stack([Wb for _, _, Wb in self.terms]), self.dtype
        )

    def _mask_int(self, k: int, R: int, C: int):
        if self.masks is None:
            return None
        return self.masks[k][1 : R - 1, 1 : C - 1]

    def _smooth(self, xp, bp, lvl: _Level, k: int, sweeps: int):
        R, C = lvl.R, lvl.C
        om = jnp.asarray(self.omega, xp.dtype)
        Dinv = self._dinv.astype(xp.dtype)
        m = self._mask_int(k, R, C)
        for _ in range(sweeps):
            r = bp[:, 2:R, 2:C] - _conv_interior_block(
                xp, self.terms, self._W.astype(xp.dtype), R, C
            )
            upd = om * jnp.einsum("ij,jrc->irc", Dinv, r, precision=HIGHEST)
            if m is not None:
                upd = upd * m
            xp = xp.at[:, 2:R, 2:C].add(upd)
        return xp

    def _cycle(self, k: int, bp):
        lvl = self.levels[k]
        R, C = lvl.R, lvl.C
        if k == len(self.levels) - 1:
            # flat layout (node-major, comp-minor) to match the dense inv
            v = bp[:, 2:R, 2:C]
            flat = jnp.moveaxis(v, 0, -1).reshape(-1)
            sol = jnp.matmul(
                self.coarse_inv.astype(bp.dtype), flat, precision=HIGHEST
            )
            v = jnp.moveaxis(
                sol.reshape(R - 2, C - 2, self.vsz), -1, 0
            )
            out = jnp.zeros_like(bp)
            return out.at[:, 2:R, 2:C].set(v)
        xp = self._smooth(jnp.zeros_like(bp), bp, lvl, k, self.pre_smooth)
        r_int = bp[:, 2:R, 2:C] - _conv_interior_block(
            xp, self.terms, self._W.astype(bp.dtype), R, C
        )
        m = self._mask_int(k, R, C)
        if m is not None:
            r_int = r_int * m
        nxt = self.levels[k + 1]
        bc = jax.vmap(lambda ri: _restrict(ri, nxt.R, nxt.C))(r_int)
        if self.masks is not None:
            bc = bc * _embed_mask(self.masks[k + 1], nxt.R, nxt.C)
        ec = self._cycle(k + 1, bc)
        corr = jax.vmap(lambda e: _prolong(e, nxt.R, nxt.C))(ec)
        if self.masks is not None:
            corr = corr * self.masks[k]
        xp = xp.at[:, 2:R, 2:C].add(corr[:, 1:-1, 1:-1])
        return self._smooth(xp, bp, lvl, k, self.post_smooth)

    def __call__(self, bp: Array) -> Array:
        in_dt = bp.dtype
        if in_dt != self.dtype:
            bp = bp.astype(self.dtype)
        return self._cycle(0, bp).astype(in_dt)


def _embed_mask(m: Array, R: int, C: int) -> Array:
    """Logical (R, C) mask -> padded (R+2, C+2) with zero ring, restricted
    to the reduced interior convention (borders stay zero)."""
    out = jnp.zeros((R + 2, C + 2), m.dtype)
    return out.at[2:R, 2:C].set(m[1:-1, 1:-1])


def build_lattice_block_mg(
    nx: int,
    ny: int,
    w: np.ndarray,
    min_n: int = 16,
    dtype=jnp.float32,
    mask: Optional[np.ndarray] = None,
    **kw,
) -> LatticeBlockMG:
    """Build the block V-cycle for an ``nx x ny``-block lattice with
    (3, 3, vsz, vsz) block vertex stencil ``w`` (scale-free in 2D, so all
    levels share it)."""
    vsz = int(w.shape[-1])
    levels = [_Level(ny + 1, nx + 1)]
    while nx % 2 == 0 and ny % 2 == 0 and nx // 2 >= min_n and ny // 2 >= min_n:
        nx //= 2
        ny //= 2
        levels.append(_Level(ny + 1, nx + 1))
    terms = _block_terms(np.asarray(w))
    lvl_masks = None
    coarse_mask = None
    if mask is not None:
        m = np.asarray(mask, bool)
        masks_np = [m]
        for _ in levels[1:]:
            m = _coarsen_mask(m)
            masks_np.append(m)
        coarse_mask = masks_np[-1]
        lvl_masks = [jnp.asarray(mm, dtype) for mm in masks_np]
    inv = _dense_coarse_inv_block(
        terms, levels[-1].R, levels[-1].C, vsz, coarse_mask
    )
    return LatticeBlockMG(
        levels, terms, jnp.asarray(inv, dtype), vsz, dtype=dtype,
        masks=lvl_masks, **kw
    )


def orientation_cell_masks(grid, sel: np.ndarray) -> np.ndarray:
    """Per-orientation ``(norient, ny, nx)`` float cell indicators from a
    flat covered-cells bool ``sel`` (cell numbering: row-major boxes, the
    two triangles of a box interleaved — same layout StencilCellBatch
    uses)."""
    ny, nx = grid.ny, grid.nx
    if grid.is_simplex:
        return np.stack(
            [sel[0::2].reshape(ny, nx), sel[1::2].reshape(ny, nx)]
        ).astype(np.float64)
    return sel.reshape(1, ny, nx).astype(np.float64)


def _coarsen_cells(ind: np.ndarray) -> np.ndarray:
    """Coarse cell indicator: a coarse box is active when ANY fine box in
    its 2x2 block is (orientation distinction dropped — a 1-cell dilation
    of the region boundary, the standard over-covering of re-discretized
    immersed multigrid)."""
    norient, ny, nx = ind.shape
    m = ind.max(axis=0).reshape(ny // 2, 2, nx // 2, 2).max(axis=(1, 3))
    return np.broadcast_to(m, (norient, ny // 2, nx // 2)).copy()


def cell_stencil_maps(
    contribs, offs_per_orient, vsz: int
) -> np.ndarray:
    """Variable per-vertex block stencil maps ``(3, 3, vsz, vsz, R-2, C-2)``
    (logical-interior vertices) assembled from the per-orientation cell
    indicator ``ind`` — the exact reduced operator of the cell term on the
    covered region, with FREE (Neumann) boundary where coverage ends.

    This is what a floating / naturally-bounded phi-FEM block needs from
    its bulk MG: the Dirichlet-masked constant stencil
    (:func:`build_lattice_mg` with ``mask``) mis-corrects every mode with
    nonzero trace on the region boundary (the harmonic-extension space,
    O(n) modes), which shows up as outer-Krylov iteration growth.

    ``contribs``: list of ``(mats, ind)`` pairs — element matrices
    (norient, nloc*vsz, nloc*vsz) and per-orientation cell indicators
    (norient, ny, nx); summed (a field may collect several cell terms)."""
    norient, ny, nx = contribs[0][1].shape
    R, C = ny + 1, nx + 1
    W = np.zeros((3, 3, vsz, vsz, R, C))
    for mats, ind in contribs:
        mats = np.asarray(mats, np.float64)
        for o, offs in enumerate(offs_per_orient):
            io = ind[o]
            for i, (dxi, dyi) in enumerate(offs):
                for j, (dxj, dyj) in enumerate(offs):
                    blk = mats[
                        o, i * vsz : (i + 1) * vsz, j * vsz : (j + 1) * vsz
                    ]
                    a, b = 1 + dyj - dyi, 1 + dxj - dxi
                    W[a, b, :, :, dyi : dyi + ny, dxi : dxi + nx] += (
                        blk[:, :, None, None] * io
                    )
    return W[:, :, :, :, 1 : R - 1, 1 : C - 1]


def galerkin_coarsen_stencil(Wf: np.ndarray, Rc: int, Cc: int) -> np.ndarray:
    """Galerkin (RAP) coarsening of a variable 9-point block stencil with
    full-weighting restriction / bilinear prolongation — the coarse
    operator stays 9-point in 2D, so every level remains lattice-resident.

    Re-discretizing coarse levels from POOLED cell indicators is NOT
    stable for free-boundary (Neumann) blocks: the pooled boundary rows
    misrepresent the operator and the V-cycle diverges with depth
    (measured rho 0.73/2.35/4.39 at 2/3/4 levels on the S5 disk block).
    RAP guarantees the coarse correction is A-optimal for SPD blocks.

    ``Wf``: (3, 3, vsz, vsz, Rf-2, Cf-2) logical-interior fine stencil,
    ``Rf = 2 Rc - 1``.  Returns (3, 3, vsz, vsz, Rc-2, Cc-2)."""
    _, _, vsz, _, nif, njf = Wf.shape
    Rf, Cf = nif + 2, njf + 2
    # embed into logical-full with a ring of zeros, plus 2 pad for gathers
    Wfull = np.zeros((3, 3, vsz, vsz, Rf + 4, Cf + 4))
    Wfull[:, :, :, :, 3 : 3 + nif, 3 : 3 + njf] = Wf
    wt = {-1: 0.5, 0: 1.0, 1: 0.5}
    Wc = np.zeros((3, 3, vsz, vsz, Rc, Cc))
    Iidx = 2 * np.arange(Rc)
    Jidx = 2 * np.arange(Cc)
    for dI in (-1, 0, 1):
        for dJ in (-1, 0, 1):
            acc = np.zeros((vsz, vsz, Rc, Cc))
            for s in (-1, 0, 1):
                for t in (-1, 0, 1):
                    for sp in (-1, 0, 1):
                        a = 2 * dI + sp - s
                        if abs(a) > 1:
                            continue
                        for tp in (-1, 0, 1):
                            b = 2 * dJ + tp - t
                            if abs(b) > 1:
                                continue
                            w = wt[s] * wt[t] * wt[sp] * wt[tp]
                            # fine row vertex (2I+s, 2J+t), offset (a, b)
                            acc += w * Wfull[
                                1 + a, 1 + b
                            ][:, :, (Iidx + s + 2)[:, None], (Jidx + t + 2)[None, :]]
            Wc[1 + dI, 1 + dJ] = acc
    return Wc[:, :, :, :, 1 : Rc - 1, 1 : Cc - 1]


def _var_diag_inv(Wint: np.ndarray, mask: Optional[np.ndarray]) -> np.ndarray:
    """Per-vertex inverse of the center blocks ``Wint[1, 1]`` —
    ``(vsz, vsz, R-2, C-2)``; identity where the block vanishes (no active
    cell ring) or the vertex is masked out."""
    vsz = Wint.shape[2]
    D = np.moveaxis(Wint[1, 1], (0, 1), (-2, -1)).copy()  # (R-2, C-2, v, v)
    dead = np.abs(D).max(axis=(-2, -1)) < 1e-300
    if mask is not None:
        dead |= ~np.asarray(mask[1:-1, 1:-1], bool)
    D[dead] = np.eye(vsz)
    return np.moveaxis(np.linalg.inv(D), (-2, -1), (0, 1))


def _dense_var_coarse_pinv(
    Wint: np.ndarray, mask: Optional[np.ndarray]
) -> np.ndarray:
    """Masked dense pseudo-inverse of the coarsest variable operator.
    Pseudo-inverse, not inverse: a floating block's coarsest operator is
    exactly singular (rigid modes) — pinv yields the zero-gauge solve,
    the MG analogue of MUMPS null-pivot handling."""
    vsz, ni, nj = Wint.shape[2], Wint.shape[-2], Wint.shape[-1]
    n = ni * nj * vsz
    A = np.zeros((n, n))
    idx = (np.arange(ni)[:, None] * nj + np.arange(nj)[None, :])
    for a in range(3):
        for b in range(3):
            dy, dx = a - 1, b - 1
            i0, i1 = max(0, -dy), min(ni, ni - dy)
            j0, j1 = max(0, -dx), min(nj, nj - dx)
            if i0 >= i1 or j0 >= j1:
                continue
            rows = idx[i0:i1, j0:j1].reshape(-1)
            cols = idx[i0 + dy : i1 + dy, j0 + dx : j1 + dx].reshape(-1)
            blks = np.moveaxis(
                Wint[a, b, :, :, i0:i1, j0:j1], (0, 1), (-2, -1)
            ).reshape(-1, vsz, vsz)
            np.add.at(
                A,
                (
                    (rows[:, None, None] * vsz + np.arange(vsz)[None, :, None]),
                    (cols[:, None, None] * vsz + np.arange(vsz)[None, None, :]),
                ),
                blks,
            )
    if mask is not None:
        act = np.repeat(np.asarray(mask[1:-1, 1:-1], bool).reshape(-1), vsz)
        A[~act, :] = 0.0
        A[:, ~act] = 0.0
        dd = np.where(~act)[0]
        A[dd, dd] = 1.0
    return np.linalg.pinv(A, rcond=1e-10)


@dataclasses.dataclass
class LatticeVarMG:
    """Variable-stencil (cell-indicator-assembled) block V-cycle on
    channels-first padded lattices ``(vsz, R+2, C+2)``.

    Same cycle structure as :class:`LatticeBlockMG`, but every level's
    operator is the exact reduced cell-term operator on the (pooled)
    covered region — free boundary where coverage ends — instead of the
    Dirichlet-masked constant stencil.  Use for floating or naturally-
    bounded blocks (S5's two displacement fields; Neumann/Robin primal
    bulks).  2D P1 stiffness is scale-free, so each level re-assembles
    from the SAME element matrices and its own pooled cell indicator."""

    levels: List[_Level]
    Ws: List[Array]  # per level (3, 3, vsz, vsz, R-2, C-2)
    Dinvs: List[Array]  # per level (vsz, vsz, R-2, C-2)
    coarse_inv: Array  # dense pinv on the coarsest interior
    vsz: int
    dtype: jnp.dtype = jnp.float32
    omega: float = 0.8
    pre_smooth: int = 2
    post_smooth: int = 2
    masks: Optional[List[Array]] = None  # per-level (R, C), channel-shared

    def _conv(self, xp: Array, k: int, R: int, C: int) -> Array:
        # ONE stacked einsum over all 9 taps (not 9 einsums + 8 adds):
        # the S5 preconditioner unrolls ~40 of these convolutions per
        # displacement field across its levels and sweeps, and collapsing
        # each to a single contraction keeps the traced graph ~9x smaller
        W = self.Ws[k].astype(xp.dtype)
        xs = jnp.stack(
            [
                xp[:, a + 1 : a + R - 1, b + 1 : b + C - 1]
                for a in range(3)
                for b in range(3)
            ]
        )  # (9, vsz, R-2, C-2)
        return jnp.einsum(
            "tijrc,tjrc->irc", W.reshape((9,) + W.shape[2:]), xs,
            precision=HIGHEST,
        )

    def _mask_int(self, k: int, R: int, C: int):
        if self.masks is None:
            return None
        return self.masks[k][1 : R - 1, 1 : C - 1]

    def _smooth(self, xp, bp, lvl: _Level, k: int, sweeps: int):
        R, C = lvl.R, lvl.C
        om = jnp.asarray(self.omega, xp.dtype)
        Dinv = self.Dinvs[k].astype(xp.dtype)
        m = self._mask_int(k, R, C)
        for _ in range(sweeps):
            r = bp[:, 2:R, 2:C] - self._conv(xp, k, R, C)
            upd = om * jnp.einsum("ijrc,jrc->irc", Dinv, r, precision=HIGHEST)
            if m is not None:
                upd = upd * m
            xp = xp.at[:, 2:R, 2:C].add(upd)
        return xp

    def _cycle(self, k: int, bp):
        lvl = self.levels[k]
        R, C = lvl.R, lvl.C
        if k == len(self.levels) - 1:
            v = bp[:, 2:R, 2:C]
            flat = jnp.moveaxis(v, 0, -1).reshape(-1)
            sol = jnp.matmul(
                self.coarse_inv.astype(bp.dtype), flat, precision=HIGHEST
            )
            v = jnp.moveaxis(sol.reshape(R - 2, C - 2, self.vsz), -1, 0)
            out = jnp.zeros_like(bp)
            return out.at[:, 2:R, 2:C].set(v)
        xp = self._smooth(jnp.zeros_like(bp), bp, lvl, k, self.pre_smooth)
        r_int = bp[:, 2:R, 2:C] - self._conv(xp, k, R, C)
        m = self._mask_int(k, R, C)
        if m is not None:
            r_int = r_int * m
        nxt = self.levels[k + 1]
        bc = jax.vmap(lambda ri: _restrict(ri, nxt.R, nxt.C))(r_int)
        if self.masks is not None:
            bc = bc * _embed_mask(self.masks[k + 1], nxt.R, nxt.C)
        ec = self._cycle(k + 1, bc)
        corr = jax.vmap(lambda e: _prolong(e, nxt.R, nxt.C))(ec)
        if self.masks is not None:
            corr = corr * self.masks[k]
        xp = xp.at[:, 2:R, 2:C].add(corr[:, 1:-1, 1:-1])
        return self._smooth(xp, bp, lvl, k, self.post_smooth)

    def __call__(self, bp: Array) -> Array:
        in_dt = bp.dtype
        if in_dt != self.dtype:
            bp = bp.astype(self.dtype)
        return self._cycle(0, bp).astype(in_dt)


def build_lattice_var_mg(
    grid,
    contribs,
    vsz: int,
    min_n: int = 16,
    dtype=jnp.float32,
    mask: Optional[np.ndarray] = None,
    **kw,
) -> LatticeVarMG:
    """Build the variable-stencil V-cycle for cell terms given as
    ``contribs``: list of ``(mats, covered)`` with element matrices
    (norient, nloc*vsz, nloc*vsz) and covered-cells bool (num_cells,) OR
    a prebuilt (norient, ny, nx) indicator.  ``mask``: (ny+1, nx+1)
    active-vertex bool (pooled per level like :func:`build_lattice_mg`)."""
    from .stencil import _QUAD_OFFS, _TRI_OFFS

    offs = _TRI_OFFS if grid.is_simplex else (_QUAD_OFFS,)
    nx, ny = grid.nx, grid.ny
    levels = [_Level(ny + 1, nx + 1)]
    while nx % 2 == 0 and ny % 2 == 0 and nx // 2 >= min_n and ny // 2 >= min_n:
        nx //= 2
        ny //= 2
        levels.append(_Level(ny + 1, nx + 1))
    fine_contribs = []
    for mats, covered in contribs:
        covered = np.asarray(covered)
        if covered.ndim == 1:
            ind = orientation_cell_masks(grid, covered.astype(bool))
        else:
            ind = covered.astype(np.float64)
        fine_contribs.append((np.asarray(mats), ind))
    Wint = cell_stencil_maps(fine_contribs, offs, vsz)
    ni, nj = Wint.shape[-2:]
    if mask is not None:
        m0 = np.asarray(mask, bool)
    else:
        m0 = np.zeros((levels[0].R, levels[0].C), bool)
        m0[1:-1, 1:-1] = np.abs(Wint[1, 1]).max(axis=(0, 1)) > 0.0
    # the fine operator the cycle smooths is the row/column-MASKED stencil
    # (the bulk block A_BB); coarse operators are its Galerkin (RAP)
    # coarsenings — re-discretizing from pooled indicators diverges with
    # depth on free-boundary blocks (see galerkin_coarsen_stencil)
    mi = m0[1:-1, 1:-1].astype(np.float64)
    mp = np.pad(mi, 1)
    Wint = Wint * mi  # rows
    for a in range(3):
        for b in range(3):
            Wint[a, b] *= mp[a : a + ni, b : b + nj]  # columns
    masks_np: List[np.ndarray] = [m0]
    Ws, Dinvs = [], []
    scale = max(1e-300, np.abs(Wint[1, 1]).max())
    for k, lv in enumerate(levels):
        if k > 0:
            Wint = galerkin_coarsen_stencil(Wint, lv.R, lv.C)
            mk = np.zeros((lv.R, lv.C), bool)
            mk[1:-1, 1:-1] = (
                np.abs(Wint[1, 1]).max(axis=(0, 1)) > 1e-12 * scale
            )
            masks_np.append(mk)
            # sanitize: zero sub-threshold rows/cols so the smoother and
            # the coarse pseudo-inverse see exactly the masked operator
            mi = mk[1:-1, 1:-1].astype(np.float64)
            mp = np.pad(mi, 1)
            Wint = Wint * mi
            for a in range(3):
                for b in range(3):
                    Wint[a, b] *= mp[
                        a : a + lv.R - 2, b : b + lv.C - 2
                    ]
        Ws.append(jnp.asarray(Wint, dtype))
        Dinvs.append(jnp.asarray(_var_diag_inv(Wint, masks_np[k]), dtype))
    inv = _dense_var_coarse_pinv(Wint, masks_np[-1])
    lvl_masks = [jnp.asarray(mm, dtype) for mm in masks_np]
    return LatticeVarMG(
        levels, Ws, Dinvs, jnp.asarray(inv, dtype), vsz, dtype=dtype,
        masks=lvl_masks, **kw
    )


def lattice_cg(
    mg: LatticeMG,
    bp: Array,
    tol: float = 1e-10,
    maxiter: int = 40,
    x0: Optional[Array] = None,
):
    """MG-preconditioned CG on padded lattices (full precision of ``bp``,
    V-cycle in ``mg.dtype``).  Returns ``(xp, relres, iters)``.

    Hand-rolled PCG (rather than ``jax.scipy.sparse.linalg.cg``) so the
    whole solve is one ``lax.while_loop`` with a cheap scalar exit test —
    the entire Krylov loop stays on the device.
    """
    lvl = mg.levels[0]
    R, C = lvl.R, lvl.C
    terms = mg.terms
    dt = bp.dtype

    def matvec(xp):
        return _embed(_conv_interior(xp, terms, R, C), R, C)

    # ALL dots run with float32 products/reduction (whether that still
    # pays on a device with float64 hardware is ROADMAP C3).  alpha/beta
    # only need ~1e-6 relative accuracy (inexact-coefficient PCG behaves
    # like flexible CG; the f64 recurrence keeps the residual itself
    # accurate), and
    # norms (scaling + reported relres) need even less.  The system is
    # normalized by ||b|| so the f32 squares stay in normal range down
    # to relres 1e-12.
    def dot32(a, b):
        return jnp.vdot(
            a.astype(jnp.float32), b.astype(jnp.float32), precision=HIGHEST
        ).astype(dt)

    bnorm = jnp.sqrt(dot32(bp, bp))
    bscale = jnp.maximum(bnorm, jnp.finfo(dt).tiny)
    bn = bp / bscale

    x = jnp.zeros_like(bn) if x0 is None else x0 / bscale
    r = bn - matvec(x) if x0 is not None else bn
    tol2 = jnp.asarray(tol, dt) ** 2

    def body(state):
        x, r, p, z, rz, it = state
        Ap = matvec(p)
        alpha = rz / dot32(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = mg(r)
        rz_new = dot32(r, z)
        p = z + (rz_new / rz) * p
        return x, r, p, z, rz_new, it + 1

    def cond(state):
        x, r, p, z, rz, it = state
        return jnp.logical_and(dot32(r, r) > tol2, it < maxiter)

    z0 = mg(r)
    state = (x, r, z0, z0, dot32(r, z0), jnp.asarray(0, jnp.int32))
    x, r, p, z, rz, it = jax.lax.while_loop(cond, body, state)
    relres = jnp.sqrt(dot32(r, r))
    return x * bscale, relres, it
