"""3D lattice-resident geometric multigrid (Q1 hexahedra).

The z-axis extension of :mod:`phifem_tpu.ops.lattice` — a capability the
2D-only reference (`/root/reference/src/phifem/mesh_scripts.py` handles
triangle/quad meshes exclusively) does not have.  The reduced operator of
a uniform trilinear (Q1) cell term on a structured hex grid with Dirichlet
conditions on the box boundary is EXACTLY a constant 27-point vertex
stencil on the zero-extended interior, so matvec / Jacobi smoothing /
residual / full-weighting restriction / trilinear prolongation are all
shifted-slice arithmetic on 3D ``(depth, rows, cols)`` arrays that XLA
fuses into bandwidth-bound passes — the same design as in 2D.

One real difference from 2D: the P1/Q1 *stiffness* stencil is NOT
refinement-invariant in 3D (it scales like h, not h^0), and mixed
stiffness+mass terms scale inhomogeneously — so levels carry their OWN
stencils, re-assembled from one tiny host-side 8x8 element matrix per
level (closed-form Gauss quadrature, no device work).

Layout: ``(D+2, R+2, C+2)`` padded arrays for a ``D x R x C`` vertex
lattice (``D = nz+1, R = ny+1, C = nx+1``); logical node ``(d, r, c)``
lives at ``[1+d, 1+r, 1+c]``.  Reduced vectors keep the padding ring AND
the logical boundary shell identically zero; the active interior is
``[2:D, 2:R, 2:C]``.
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
    "hex_element_matrix",
    "vertex_stencil_weights3",
    "block_vertex_stencil_weights3",
    "Lattice3MG",
    "Lattice3BlockMG",
    "build_lattice3_mg",
    "build_lattice3_block_mg",
    "lattice3_cg",
]

# local-node lattice offsets (dx, dy, dz), x fastest — matches the
# vertex-lattice raveling used throughout (index = (z * R + y) * C + x)
_HEX_OFFS = tuple(
    (dx, dy, dz) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)
)


def hex_element_matrix(
    hx: float, hy: float, hz: float, stiffness: float = 1.0, mass: float = 0.0
) -> np.ndarray:
    """8x8 trilinear element matrix ``stiffness * ∫∇u·∇v + mass * ∫u v``
    on an ``hx x hy x hz`` hex, by 2x2x2 Gauss quadrature (exact: the
    integrands are at most quadratic per direction).  Host-side numpy —
    one call per MG level, never on the device."""
    gp = np.array([0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0)])
    A = np.zeros((8, 8))
    hs = np.array([hx, hy, hz])

    def shape(xi):  # xi in [0,1]^3 -> (8,) values and (8,3) ref gradients
        vals = np.empty(8)
        grads = np.empty((8, 3))
        for i, (dx, dy, dz) in enumerate(_HEX_OFFS):
            f = np.array(
                [
                    xi[0] if dx else 1.0 - xi[0],
                    xi[1] if dy else 1.0 - xi[1],
                    xi[2] if dz else 1.0 - xi[2],
                ]
            )
            df = np.array(
                [1.0 if dx else -1.0, 1.0 if dy else -1.0, 1.0 if dz else -1.0]
            )
            vals[i] = f.prod()
            for k in range(3):
                grads[i, k] = df[k] * np.prod(np.delete(f, k))
        return vals, grads

    vol = hx * hy * hz
    for gx in gp:
        for gy in gp:
            for gz in gp:
                vals, grads = shape(np.array([gx, gy, gz]))
                gphys = grads / hs[None, :]
                A += (vol / 8.0) * (
                    stiffness * gphys @ gphys.T + mass * np.outer(vals, vals)
                )
    return A


def vertex_stencil_weights3(A8: np.ndarray) -> np.ndarray:
    """Aggregate the 8x8 hex element matrix into the (3, 3, 3) vertex
    stencil ``w[1+dz, 1+dy, 1+dx]`` valid at every interior vertex (every
    (i, j) node pair occurs once per cell of the 8-cell ring, displaced by
    ``off_j - off_i``)."""
    w = np.zeros((3, 3, 3))
    A8 = np.asarray(A8, np.float64)
    for i, (dxi, dyi, dzi) in enumerate(_HEX_OFFS):
        for j, (dxj, dyj, dzj) in enumerate(_HEX_OFFS):
            w[1 + dzj - dzi, 1 + dyj - dyi, 1 + dxj - dxi] += A8[i, j]
    return w


def _terms3(w: np.ndarray) -> List[Tuple[int, int, int, float]]:
    out = []
    scale = max(1e-300, np.abs(w).max())
    for a in range(3):
        for b in range(3):
            for c in range(3):
                if abs(w[a, b, c]) > 1e-14 * scale:
                    out.append((a, b, c, float(w[a, b, c])))
    return out


@dataclasses.dataclass(frozen=True)
class _Level3:
    D: int  # nz + 1
    R: int  # ny + 1
    C: int  # nx + 1
    terms: Tuple[Tuple[int, int, int, float], ...]


def _conv_interior3(xp: Array, terms, D: int, R: int, C: int) -> Array:
    """(A x) at the logical-interior nodes: shape (D-2, R-2, C-2)."""
    dt = xp.dtype
    acc = None
    for a, b, c, wt in terms:
        part = jnp.asarray(wt, dt) * xp[
            a + 1 : a + D - 1, b + 1 : b + R - 1, c + 1 : c + C - 1
        ]
        acc = part if acc is None else acc + part
    return acc


def _embed3(v: Array, D: int, R: int, C: int) -> Array:
    out = jnp.zeros((D + 2, R + 2, C + 2), v.dtype)
    return out.at[2:D, 2:R, 2:C].set(v)


def _interleave_axis(A: Array, H: Array, axis: int) -> Array:
    """[a0 h0 a1 h1 ... a_{m-1}] along ``axis`` from A (m) and H (m-1)."""
    A = jnp.moveaxis(A, axis, 0)
    H = jnp.moveaxis(H, axis, 0)
    m = A.shape[0]
    body = jnp.stack([A[: m - 1], H], axis=1).reshape((2 * (m - 1),) + A.shape[1:])
    out = jnp.concatenate([body, A[m - 1 :]], axis=0)
    return jnp.moveaxis(out, 0, axis)


def _prolong3(Ecp: Array, Dc: int, Rc: int, Cc: int) -> Array:
    """Trilinear prolongation, interleave form.  Input: coarse padded
    (Dc+2, Rc+2, Cc+2) reduced vector; output: the fine logical
    (2Dc-1, 2Rc-1, 2Cc-1) correction lattice (boundary shell zero)."""
    E = Ecp[1 : 1 + Dc, 1 : 1 + Rc, 1 : 1 + Cc]
    for axis in (2, 1, 0):
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[axis] = slice(None, -1)
        sl_hi[axis] = slice(1, None)
        H = 0.5 * (E[tuple(sl_lo)] + E[tuple(sl_hi)])
        E = _interleave_axis(E, H, axis)
    return E


def _restrict3(r_int: Array, Dc: int, Rc: int, Cc: int) -> Array:
    """Full weighting (transpose of trilinear prolongation, weight sum 8).
    ``r_int``: fine logical-interior (D-2, R-2, C-2), fine boundary
    residual zero by convention.  Returns coarse padded reduced vector."""
    out = None
    n_d, n_r, n_c = Dc - 2, Rc - 2, Cc - 2
    wts = ((-1, 0.5), (0, 1.0), (1, 0.5))
    for s, ws in wts:
        planes = r_int[1 + s :: 2][:n_d]
        for t, wt in wts:
            rows = planes[:, 1 + t :: 2][:, :n_r]
            for u, wu in wts:
                part = (ws * wt * wu) * rows[:, :, 1 + u :: 2][:, :, :n_c]
                out = part if out is None else out + part
    return _embed3(out.astype(r_int.dtype), Dc, Rc, Cc)


def _dense_coarse_inv3(
    terms, D: int, R: int, C: int, mask: Optional[np.ndarray] = None
) -> np.ndarray:
    """Exact inverse of the reduced operator on the coarsest interior."""
    nd, nr, nc = D - 2, R - 2, C - 2
    n = nd * nr * nc
    A = np.zeros((n, n))
    for a, b, c, wt in terms:
        dz, dy, dx = a - 1, b - 1, c - 1
        for i in range(nd):
            i2 = i + dz
            if not (0 <= i2 < nd):
                continue
            for j in range(nr):
                j2 = j + dy
                if not (0 <= j2 < nr):
                    continue
                for k in range(nc):
                    k2 = k + dx
                    if 0 <= k2 < nc:
                        A[(i * nr + j) * nc + k, (i2 * nr + j2) * nc + k2] += wt
    if mask is not None:
        act = np.asarray(
            mask[1 : D - 1, 1 : R - 1, 1 : C - 1], bool
        ).reshape(-1)
        A[~act, :] = 0.0
        A[:, ~act] = 0.0
        idx = np.where(~act)[0]
        A[idx, idx] = 1.0
    return np.linalg.inv(A)


def _coarsen_mask3(m: np.ndarray) -> np.ndarray:
    """Coarse active mask: 3x3x3 trilinear-support pooling, then stride 2."""
    D, R, C = m.shape
    p = np.zeros((D + 2, R + 2, C + 2), bool)
    p[1 : 1 + D, 1 : 1 + R, 1 : 1 + C] = m
    pool = np.zeros_like(m)
    for s in (0, 1, 2):
        for t in (0, 1, 2):
            for u in (0, 1, 2):
                pool |= p[s : s + D, t : t + R, u : u + C]
    return pool[::2, ::2, ::2].copy()


@dataclasses.dataclass
class Lattice3MG:
    """V-cycle preconditioner on 3D padded lattices; per-level stencils
    (3D uniform terms are not refinement-invariant, see module docstring)."""

    levels: List[_Level3]
    coarse_inv: Array
    dtype: jnp.dtype = jnp.float32
    omega: float = 0.8
    pre_smooth: int = 2
    post_smooth: int = 2
    masks: Optional[List[Array]] = None  # per-level logical (D, R, C)

    @property
    def terms(self):
        return self.levels[0].terms

    def _dinv(self, k: int) -> float:
        return 1.0 / next(
            wt for a, b, c, wt in self.levels[k].terms if (a, b, c) == (1, 1, 1)
        )

    def _mask_int(self, k: int, D: int, R: int, C: int):
        if self.masks is None:
            return None
        return self.masks[k][1 : D - 1, 1 : R - 1, 1 : C - 1]

    def _smooth(self, xp, bp, lvl: _Level3, k: int, sweeps: int):
        D, R, C = lvl.D, lvl.R, lvl.C
        od = jnp.asarray(self.omega * self._dinv(k), xp.dtype)
        m = self._mask_int(k, D, R, C)
        for _ in range(sweeps):
            r = bp[2:D, 2:R, 2:C] - _conv_interior3(xp, lvl.terms, D, R, C)
            upd = od * r if m is None else od * r * m
            xp = xp.at[2:D, 2:R, 2:C].add(upd)
        return xp

    def _cycle(self, k: int, bp):
        lvl = self.levels[k]
        D, R, C = lvl.D, lvl.R, lvl.C
        if k == len(self.levels) - 1:
            v = jnp.matmul(
                self.coarse_inv.astype(bp.dtype),
                bp[2:D, 2:R, 2:C].reshape(-1),
                precision=HIGHEST,
            )
            return _embed3(v.reshape(D - 2, R - 2, C - 2), D, R, C)
        xp = self._smooth(jnp.zeros_like(bp), bp, lvl, k, self.pre_smooth)
        r_int = bp[2:D, 2:R, 2:C] - _conv_interior3(xp, lvl.terms, D, R, C)
        m = self._mask_int(k, D, R, C)
        if m is not None:
            r_int = r_int * m
        nxt = self.levels[k + 1]
        bc = _restrict3(r_int, nxt.D, nxt.R, nxt.C)
        if self.masks is not None:
            bc = bc * _embed3(
                self.masks[k + 1][1:-1, 1:-1, 1:-1], nxt.D, nxt.R, nxt.C
            )
        ec = self._cycle(k + 1, bc)
        corr = _prolong3(ec, nxt.D, nxt.R, nxt.C)
        if self.masks is not None:
            corr = corr * self.masks[k]
        xp = xp.at[2:D, 2:R, 2:C].add(corr[1:-1, 1:-1, 1:-1])
        return self._smooth(xp, bp, lvl, k, self.post_smooth)

    def __call__(self, bp: Array) -> Array:
        in_dt = bp.dtype
        if in_dt != self.dtype:
            bp = bp.astype(self.dtype)
        return self._cycle(0, bp).astype(in_dt)


def build_lattice3_mg(
    nx: int,
    ny: int,
    nz: int,
    spacing: Tuple[float, float, float],
    stiffness: float = 1.0,
    mass: float = 0.0,
    min_n: int = 8,
    dtype=jnp.float32,
    mask: Optional[np.ndarray] = None,
    **kw,
) -> Lattice3MG:
    """Build the 3D V-cycle for ``stiffness * (-Δ) + mass * I`` on an
    ``nx x ny x nz``-cell hex lattice.  Each level re-assembles its own
    8x8 element matrix at the level spacing (host-side, closed form)."""
    hx, hy, hz = spacing
    dims = [(nx, ny, nz)]
    while (
        nx % 2 == 0 and ny % 2 == 0 and nz % 2 == 0
        and min(nx, ny, nz) // 2 >= min_n
    ):
        nx, ny, nz = nx // 2, ny // 2, nz // 2
        dims.append((nx, ny, nz))
    levels = []
    for k, (lx, ly, lz) in enumerate(dims):
        A8 = hex_element_matrix(
            hx * 2**k, hy * 2**k, hz * 2**k, stiffness=stiffness, mass=mass
        )
        levels.append(
            _Level3(
                lz + 1, ly + 1, lx + 1,
                tuple(_terms3(vertex_stencil_weights3(A8))),
            )
        )
    lvl_masks = None
    coarse_mask = None
    if mask is not None:
        m = np.asarray(mask, bool)
        masks_np = [m]
        for _ in levels[1:]:
            m = _coarsen_mask3(m)
            masks_np.append(m)
        coarse_mask = masks_np[-1]
        lvl_masks = [jnp.asarray(mm, dtype) for mm in masks_np]
    lvl = levels[-1]
    inv = _dense_coarse_inv3(lvl.terms, lvl.D, lvl.R, lvl.C, coarse_mask)
    return Lattice3MG(
        levels, jnp.asarray(inv, dtype), dtype=dtype, masks=lvl_masks, **kw
    )


def block_vertex_stencil_weights3(K: np.ndarray, vsz: int) -> np.ndarray:
    """Aggregate an (8*vsz, 8*vsz) CHANNEL-MAJOR vector hex element matrix
    (local dof = 8*channel + node, the 3D scheme layout) into the
    (3, 3, 3, vsz, vsz) block vertex stencil — the 3D analogue of
    :func:`phifem_tpu.ops.lattice.block_vertex_stencil_weights`."""
    w = np.zeros((3, 3, 3, vsz, vsz))
    K = np.asarray(K, np.float64)
    for i, (dxi, dyi, dzi) in enumerate(_HEX_OFFS):
        for j, (dxj, dyj, dzj) in enumerate(_HEX_OFFS):
            for ci in range(vsz):
                for cj in range(vsz):
                    w[
                        1 + dzj - dzi, 1 + dyj - dyi, 1 + dxj - dxi, ci, cj
                    ] += K[8 * ci + i, 8 * cj + j]
    return w


def _block_terms3(w: np.ndarray) -> List[Tuple[int, int, int, np.ndarray]]:
    out = []
    scale = max(1e-300, np.abs(w).max())
    for a in range(3):
        for b in range(3):
            for c in range(3):
                if np.abs(w[a, b, c]).max() > 1e-14 * scale:
                    out.append((a, b, c, w[a, b, c].copy()))
    return out


def _conv_interior3_block(
    xp: Array, offs, W: Array, D: int, R: int, C: int
) -> Array:
    """(A x) at the logical-interior nodes for channels-first block 3D
    lattices: ``xp`` (vsz, D+2, R+2, C+2) -> (vsz, D-2, R-2, C-2); ``W``
    stacks the per-offset (vsz, vsz) blocks."""
    acc = None
    for t, (a, b, c) in enumerate(offs):
        xs = xp[:, a + 1 : a + D - 1, b + 1 : b + R - 1, c + 1 : c + C - 1]
        part = jnp.einsum("ij,jdrc->idrc", W[t], xs, precision=HIGHEST)
        acc = part if acc is None else acc + part
    return acc


def _dense_coarse_inv3_block(
    terms, D: int, R: int, C: int, vsz: int, mask: Optional[np.ndarray] = None
) -> np.ndarray:
    """Exact inverse of the reduced block operator on the coarsest 3D
    interior; flat index = ((i * nr + j) * nc + k) * vsz + comp."""
    nd, nr, nc = D - 2, R - 2, C - 2
    n = nd * nr * nc * vsz
    A = np.zeros((n, n))
    for a, b, c, Wb in terms:
        dz, dy, dx = a - 1, b - 1, c - 1
        for i in range(nd):
            i2 = i + dz
            if not (0 <= i2 < nd):
                continue
            for j in range(nr):
                j2 = j + dy
                if not (0 <= j2 < nr):
                    continue
                for k in range(nc):
                    k2 = k + dx
                    if 0 <= k2 < nc:
                        r0 = ((i * nr + j) * nc + k) * vsz
                        c0 = ((i2 * nr + j2) * nc + k2) * vsz
                        A[r0 : r0 + vsz, c0 : c0 + vsz] += Wb
    if mask is not None:
        act = np.repeat(
            np.asarray(mask[1 : D - 1, 1 : R - 1, 1 : C - 1], bool).reshape(-1),
            vsz,
        )
        A[~act, :] = 0.0
        A[:, ~act] = 0.0
        idx = np.where(~act)[0]
        A[idx, idx] = 1.0
    # a FLOATING masked elasticity block (e.g. the sphere-interior side of
    # an interface problem) is exactly singular along its rigid modes —
    # a plain inverse returns garbage that caps the V-cycle's quality;
    # the pseudo-inverse is the coarse analogue of mg._coarse_pinv
    return np.linalg.pinv(A, rcond=1e-10)


@dataclasses.dataclass
class Lattice3BlockMG:
    """Block (multi-channel) 3D V-cycle on channels-first padded lattices
    (vsz, D+2, R+2, C+2) — the vector-field generalization of
    :class:`Lattice3MG` (3D elasticity bulk: vsz=3).  Per-level stencils
    (3D terms are not refinement-invariant); block-Jacobi smoothing with
    the interior center-block inverse; componentwise trilinear transfers."""

    levels: List[_Level3]
    offs: Tuple[Tuple[int, int, int], ...]
    Ws: List[Array]  # per-level (nterms, vsz, vsz)
    dinvs: List[Array]  # per-level (vsz, vsz) center-block inverses
    coarse_inv: Array
    vsz: int
    dtype: jnp.dtype = jnp.float32
    # block Jacobi on the Q1 ELASTICITY stencil has lam_max(D^-1 A) ~ 2.64
    # (measured, nu = 0.3) vs < 2 for scalar Laplace: omega = 0.8 AMPLIFIES
    # (|1 - 0.8 * 2.64| > 1) and the V-cycle diverges; 0.6 damps the upper
    # half of the spectrum
    omega: float = 0.6
    pre_smooth: int = 2
    post_smooth: int = 2
    masks: Optional[List[Array]] = None  # per-level logical (D, R, C)

    def _mask_int(self, k: int, D: int, R: int, C: int):
        if self.masks is None:
            return None
        return self.masks[k][1 : D - 1, 1 : R - 1, 1 : C - 1]

    def _smooth(self, xp, bp, lvl: _Level3, k: int, sweeps: int):
        D, R, C = lvl.D, lvl.R, lvl.C
        om = jnp.asarray(self.omega, xp.dtype)
        Dinv = self.dinvs[k].astype(xp.dtype)
        W = self.Ws[k].astype(xp.dtype)
        m = self._mask_int(k, D, R, C)
        for _ in range(sweeps):
            r = bp[:, 2:D, 2:R, 2:C] - _conv_interior3_block(
                xp, self.offs, W, D, R, C
            )
            upd = om * jnp.einsum("ij,jdrc->idrc", Dinv, r, precision=HIGHEST)
            if m is not None:
                upd = upd * m
            xp = xp.at[:, 2:D, 2:R, 2:C].add(upd)
        return xp

    def _cycle(self, k: int, bp):
        lvl = self.levels[k]
        D, R, C = lvl.D, lvl.R, lvl.C
        if k == len(self.levels) - 1:
            v = bp[:, 2:D, 2:R, 2:C]
            flat = jnp.moveaxis(v, 0, -1).reshape(-1)
            sol = jnp.matmul(
                self.coarse_inv.astype(bp.dtype), flat, precision=HIGHEST
            )
            v = jnp.moveaxis(
                sol.reshape(D - 2, R - 2, C - 2, self.vsz), -1, 0
            )
            return jnp.zeros_like(bp).at[:, 2:D, 2:R, 2:C].set(v)
        W = self.Ws[k].astype(bp.dtype)
        xp = self._smooth(jnp.zeros_like(bp), bp, lvl, k, self.pre_smooth)
        r_int = bp[:, 2:D, 2:R, 2:C] - _conv_interior3_block(
            xp, self.offs, W, D, R, C
        )
        m = self._mask_int(k, D, R, C)
        if m is not None:
            r_int = r_int * m
        nxt = self.levels[k + 1]
        bc = jax.vmap(lambda ri: _restrict3(ri, nxt.D, nxt.R, nxt.C))(r_int)
        if self.masks is not None:
            mc = _embed3(
                self.masks[k + 1][1:-1, 1:-1, 1:-1], nxt.D, nxt.R, nxt.C
            )
            bc = bc * mc
        ec = self._cycle(k + 1, bc)
        corr = jax.vmap(lambda e: _prolong3(e, nxt.D, nxt.R, nxt.C))(ec)
        if self.masks is not None:
            corr = corr * self.masks[k]
        xp = xp.at[:, 2:D, 2:R, 2:C].add(corr[:, 1:-1, 1:-1, 1:-1])
        return self._smooth(xp, bp, lvl, k, self.post_smooth)

    def __call__(self, bp: Array) -> Array:
        in_dt = bp.dtype
        if in_dt != self.dtype:
            bp = bp.astype(self.dtype)
        return self._cycle(0, bp).astype(in_dt)


def build_lattice3_block_mg(
    nx: int,
    ny: int,
    nz: int,
    spacing: Tuple[float, float, float],
    elem_fn,
    vsz: int,
    min_n: int = 4,
    dtype=jnp.float32,
    mask: Optional[np.ndarray] = None,
    **kw,
) -> Lattice3BlockMG:
    """Build the block 3D V-cycle for the uniform vector cell term whose
    CHANNEL-MAJOR element matrix at spacing (hx, hy, hz) is
    ``elem_fn(hx, hy, hz) -> (8*vsz, 8*vsz)`` (e.g. the Q1 linear-
    elasticity matrix).  Each level re-assembles its own element matrix at
    the level spacing (3D terms are not scale-free)."""
    hx, hy, hz = spacing
    dims = [(nx, ny, nz)]
    while (
        nx % 2 == 0 and ny % 2 == 0 and nz % 2 == 0
        and min(nx, ny, nz) // 2 >= min_n
    ):
        nx, ny, nz = nx // 2, ny // 2, nz // 2
        dims.append((nx, ny, nz))
    levels = []
    terms_per_level = []
    for k, (lx, ly, lz) in enumerate(dims):
        K = elem_fn(hx * 2**k, hy * 2**k, hz * 2**k)
        terms = _block_terms3(block_vertex_stencil_weights3(K, vsz))
        terms_per_level.append(terms)
        levels.append(_Level3(lz + 1, ly + 1, lx + 1, ()))
    offs = tuple((a, b, c) for a, b, c, _ in terms_per_level[0])
    Ws, dinvs = [], []
    for terms in terms_per_level:
        by_off = {(a, b, c): Wb for a, b, c, Wb in terms}
        Ws.append(
            jnp.asarray(np.stack([by_off[o] for o in offs]), dtype)
        )
        dinvs.append(jnp.asarray(np.linalg.inv(by_off[(1, 1, 1)]), dtype))
    lvl_masks = None
    coarse_mask = None
    if mask is not None:
        m = np.asarray(mask, bool)
        masks_np = [m]
        for _ in levels[1:]:
            m = _coarsen_mask3(m)
            masks_np.append(m)
        coarse_mask = masks_np[-1]
        lvl_masks = [jnp.asarray(mm, dtype) for mm in masks_np]
    lvl = levels[-1]
    inv = _dense_coarse_inv3_block(
        terms_per_level[-1], lvl.D, lvl.R, lvl.C, vsz, coarse_mask
    )
    return Lattice3BlockMG(
        levels, offs, Ws, dinvs, jnp.asarray(inv, dtype), vsz,
        dtype=dtype, masks=lvl_masks, **kw
    )


def lattice3_cg(
    mg: Lattice3MG,
    bp: Array,
    tol: float = 1e-10,
    maxiter: int = 40,
    x0: Optional[Array] = None,
):
    """MG-preconditioned CG on 3D padded lattices — one ``lax.while_loop``
    on-chip, f32 dots on the ||b||-normalized system (see
    :func:`phifem_tpu.ops.lattice.lattice_cg` for the rationale)."""
    lvl = mg.levels[0]
    D, R, C = lvl.D, lvl.R, lvl.C
    terms = lvl.terms
    dt = bp.dtype

    def matvec(xp):
        return _embed3(_conv_interior3(xp, terms, D, R, C), D, R, C)

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
