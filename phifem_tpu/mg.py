"""Geometric multigrid on the structured background grid.

The reference relies on MUMPS LU (direct) for every solve
(``demo/weak-dirichlet/flower/main.py:162-182``); the matrix-free
replacement is Krylov + a geometric V-cycle preconditioner, which on this
structured grid costs only stencil transfers (cf. PAPERS.md: "A multigrid method for
CutFEM and its implementation on GPU" — re-discretized coarse levels with
level-wise tagging are the standard CutFEM/phi-FEM multigrid design).

Components, all matrix-free and shardable:

* hierarchy: grids ``n, n/2, n/4, ...`` (the uniform-refinement inverse of
  reference N11); each level is *re-discretized* (the scheme is assembled,
  with its own level-set tagging, on the coarse grid);
* transfers on P1 vertex lattices: prolongation = bilinear interpolation,
  restriction = its transpose (full weighting) — pure 2D stencils;
* smoother: damped Jacobi (weight 0.67) using the assembled diagonal, with
  inactive DoFs held fixed;
* coarse solve: a few extra smoothing sweeps (the hierarchy bottoms out on
  a tiny grid where Jacobi contracts quickly).

Works on single-field *and* mixed systems: transfers act on each scalar-P1
field's vertex lattice; non-vertex fields (DG0 etc.) are smoothed only
(treated as fine-level-local) — adequate because phi-FEM auxiliary fields
only appear on cut cells.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .grid import Grid
from .ops import HIGHEST

Array = jnp.ndarray

__all__ = ["VCycle", "build_hierarchy"]


def _is_vertex_lattice(grid: Grid, n: int) -> bool:
    return n == grid.num_vertices


def prolong(coarse: Array, gc: Grid, gf: Grid) -> Array:
    """Bilinear prolongation between vertex lattices (gc -> gf = gc.refine()).

    Fine vertex (2i, 2j) copies coarse (i, j); odd points average neighbours.
    """
    X = coarse.reshape(gc.ny + 1, gc.nx + 1)
    ny, nx = gf.ny + 1, gf.nx + 1
    out = jnp.zeros((ny, nx), coarse.dtype)
    out = out.at[::2, ::2].set(X)
    out = out.at[::2, 1::2].set(0.5 * (X[:, :-1] + X[:, 1:]))
    out = out.at[1::2, ::2].set(0.5 * (X[:-1, :] + X[1:, :]))
    out = out.at[1::2, 1::2].set(
        0.25 * (X[:-1, :-1] + X[:-1, 1:] + X[1:, :-1] + X[1:, 1:])
    )
    return out.reshape(-1)


def restrict(fine: Array, gf: Grid, gc: Grid) -> Array:
    """Full-weighting restriction (transpose of :func:`prolong`)."""
    Y = fine.reshape(gf.ny + 1, gf.nx + 1)
    ny, nx = gc.ny + 1, gc.nx + 1
    out = Y[::2, ::2]
    # horizontal odd neighbours
    out = out.at[:, :-1].add(0.5 * Y[::2, 1::2])
    out = out.at[:, 1:].add(0.5 * Y[::2, 1::2])
    # vertical odd neighbours
    out = out.at[:-1, :].add(0.5 * Y[1::2, ::2])
    out = out.at[1:, :].add(0.5 * Y[1::2, ::2])
    # diagonal odd-odd
    q = 0.25 * Y[1::2, 1::2]
    out = out.at[:-1, :-1].add(q)
    out = out.at[:-1, 1:].add(q)
    out = out.at[1:, :-1].add(q)
    out = out.at[1:, 1:].add(q)
    return out.reshape(-1)


def _band_bicgstab(mv, M, b: Array, iters: int) -> Array:
    """Fixed-iteration preconditioned BiCGStab on a flat vector as ONE
    ``lax.fori_loop`` — the inner band solver of the multiplicative
    interface correction.

    Deliberately NOT ``jax.scipy.sparse.linalg.bicgstab``: a
    preconditioner's inner solve needs bounded work, not an exit test,
    and a fixed-trip loop nested in the outer Krylov while_loop keeps the
    compiled S5 solve graph small.  Breakdown handling: divisions are
    guarded, and the BEST iterate (smallest residual seen) is returned,
    so a late stagnation-then-breakdown wander cannot poison the outer
    iteration (the same lesson as solvers._pbicgstab, CLAUDE.md round 3).
    Dots run in float32 at full float32 precision."""
    dt = b.dtype

    def dot(a, c):
        return jnp.vdot(
            a.astype(jnp.float32), c.astype(jnp.float32), precision=HIGHEST
        ).astype(dt)

    def safe(d):
        return jnp.where(jnp.abs(d) > 1e-300, d, jnp.asarray(1e-300, dt))

    zeros = jnp.zeros_like(b)
    one = jnp.asarray(1.0, dt)
    rhat = b
    rr0 = dot(b, b)
    state = (zeros, b, zeros, zeros, one, one, one, zeros, rr0)

    def body(i, st):
        x, r, p, v, rho, alpha, omega, xb, rrb = st
        rho_new = dot(rhat, r)
        beta = jnp.where(
            i == 0, 0.0, (rho_new / safe(rho)) * (alpha / safe(omega))
        )
        p = r + beta * (p - omega * v)
        ph = M(p)
        v = mv(ph)
        alpha = rho_new / safe(dot(rhat, v))
        s = r - alpha * v
        sh = M(s)
        t = mv(sh)
        omega = dot(t, s) / safe(dot(t, t))
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rr = dot(r, r)
        better = jnp.logical_and(jnp.isfinite(rr), rr < rrb)
        xb = jnp.where(better, x, xb)
        rrb = jnp.where(better, rr, rrb)
        return (x, r, p, v, rho_new, alpha, omega, xb, rrb)

    state = jax.lax.fori_loop(0, int(iters), body, state)
    return state[7]


@dataclasses.dataclass
class Level:
    grid: Grid
    matvec: Callable  # masked operator matvec on this level
    inv_diag: Dict[str, Array]
    active: Dict[str, Array]
    coarse_inv: Optional[Array] = None  # dense pseudo-inverse (coarsest only)
    field_shapes: Optional[Dict[str, Tuple[int, ...]]] = None

    def pack(self, x: Dict[str, Array]) -> Array:
        return jnp.concatenate([x[k].reshape(-1) for k in sorted(x)])

    def unpack(self, v: Array) -> Dict[str, Array]:
        out, cur = {}, 0
        for k in sorted(self.field_shapes):
            sh = self.field_shapes[k]
            n = int(np.prod(sh))
            out[k] = v[cur : cur + n].reshape(sh)
            cur += n
        return out


@dataclasses.dataclass
class VCycle:
    """V-cycle preconditioner M^{-1} ~ A^{-1} over a grid hierarchy.

    ``dtype``: optional compute dtype for the whole cycle (e.g. float32
    inside a float64 outer Krylov solve — halves the bandwidth; a
    preconditioner does not need the solution dtype's accuracy).  Inputs
    are cast on entry and the correction is cast back on exit.
    """

    levels: List[Level]  # fine -> coarse
    vertex_fields: Tuple[str, ...]
    pre_smooth: int = 2
    post_smooth: int = 2
    coarse_sweeps: int = 12
    omega: float = 0.67
    dtype: Optional[jnp.dtype] = None

    def _smooth(self, lvl: Level, x, b, sweeps: int):
        for _ in range(sweeps):
            r = jax.tree.map(lambda bi, ai: bi - ai, b, lvl.matvec(x))
            x = jax.tree.map(
                lambda xi, ri, di, m: jnp.where(m, xi + self.omega * ri * di, xi),
                x,
                r,
                lvl.inv_diag,
                lvl.active,
            )
        return x

    def _cycle(self, k: int, b):
        lvl = self.levels[k]
        zero = jax.tree.map(jnp.zeros_like, b)
        if k == len(self.levels) - 1:
            if lvl.coarse_inv is not None:
                # exact coarse solve via precomputed pseudo-inverse — the
                # multigrid analogue of the reference's MUMPS null-pivot LU
                return lvl.unpack(
                    jnp.matmul(lvl.coarse_inv, lvl.pack(b), precision=HIGHEST)
                )
            return self._smooth(lvl, zero, b, self.coarse_sweeps)
        x = self._smooth(lvl, zero, b, self.pre_smooth)
        r = jax.tree.map(lambda bi, ai: bi - ai, b, lvl.matvec(x))
        # the residual at inactive/BC rows is b - x (identity rows) — with
        # nonzero Dirichlet data that is NONZERO early in the outer Krylov
        # iteration, and restricting it would contaminate the coarse
        # correction near the boundary (observed: CG stall at relres ~0.9).
        # Only active-row residuals participate in coarse-grid correction.
        r = jax.tree.map(
            lambda ri, m: jnp.where(m, ri, jnp.zeros_like(ri)), r, lvl.active
        )
        coarse_lvl = self.levels[k + 1]
        rc = {}
        for name, v in r.items():
            if name in self.vertex_fields:
                if v.ndim == 1:
                    rc[name] = restrict(v, lvl.grid, coarse_lvl.grid)
                else:
                    flat = v.reshape(v.shape[0], -1)
                    cols = [
                        restrict(flat[:, j], lvl.grid, coarse_lvl.grid)
                        for j in range(flat.shape[1])
                    ]
                    rc[name] = jnp.stack(cols, axis=-1).reshape(
                        (-1,) + v.shape[1:]
                    )
            else:
                # non-vertex fields (DG0 etc.) live on the fine level only;
                # the coarse system sees a zero right-hand side for them
                rc[name] = jnp.zeros_like(coarse_lvl.inv_diag[name])
        ec = self._cycle(k + 1, rc)
        for name in b:
            if name in self.vertex_fields:
                v = ec[name]
                if v.ndim == 1:
                    corr = prolong(v, coarse_lvl.grid, lvl.grid)
                else:
                    flat = v.reshape(v.shape[0], -1)
                    cols = [
                        prolong(flat[:, j], coarse_lvl.grid, lvl.grid)
                        for j in range(flat.shape[1])
                    ]
                    corr = jnp.stack(cols, axis=-1).reshape((-1,) + b[name].shape[1:])
                x[name] = jnp.where(
                    lvl.active[name], x[name] + corr, x[name]
                )
        x = self._smooth(lvl, x, b, self.post_smooth)
        return x

    # optional multiplicative interface (cut-block) correction: either an
    # exact dense inverse on the whole block (small interfaces) or batched
    # overlapping block inverses (restricted additive Schwarz) beyond
    interface_ids: Optional[Array] = None  # global flat DoF ids
    interface_inv: Optional[Array] = None  # dense inverse on those DoFs
    schwarz_ids: Optional[Array] = None  # (nb, K) COMPACT band ids, pad -> m
    schwarz_inv: Optional[Array] = None  # (nb, K, K) block inverses
    schwarz_own: Optional[Array] = None  # (nb, K) RAS ownership mask
    schwarz_sweeps: int = 10  # inner Krylov iterations on the band system
    # the interface block itself, device-resident in ELL form: the inner
    # solve needs A_II * v, which no full-operator matvec can restrict to
    band_ids: Optional[Array] = None  # (m,) global flat band DoF ids
    band_ell_cols: Optional[Array] = None  # (m, nnz) compact cols, pad -> m
    band_ell_vals: Optional[Array] = None  # (m, nnz)
    # optional rank-k Galerkin coarse correction (attach_coarse_correction):
    # near-null modes both the bulk cycle and the band solve miss — e.g.
    # rigid motions of a FLOATING phi-FEM subdomain (no Dirichlet rows of
    # its own; all its energy sits in the interface band), the FETI/BDDC
    # coarse-space analogue
    coarse_Z: Optional[Array] = None  # (k, n_flat) masked mode basis
    coarse_Ginv: Optional[Array] = None  # (k, k) inverse of Z A Z^T
    # A Z^T rows (k, n_flat): lets the band solve reuse the residual after
    # the coarse update (rf -= AZ^T c) instead of a second full operator
    # matvec — one matvec per preconditioner application instead of two
    # (both a runtime and a compiled-graph-size win)
    coarse_AZ: Optional[Array] = None
    # test-space choice for the rank-k correction: False = Galerkin
    # (Z A Z', the substructuring default), True = residual-minimizing
    # (AZ AZ', GMRES-style oblique projection — non-expansive in the
    # residual norm even on nonsymmetric operators; used when Ritz
    # modes join the basis, see attach_ritz_modes)
    coarse_lsq: bool = False
    _flat_meta: Optional[Tuple] = None  # (names, shapes, sizes) system order
    # mutation counter: compiled-solver caches key on (id(self), _version)
    # so in-place equipping (attach_interface_solve) invalidates them
    _version: int = 0

    def _flatten(self, x) -> Array:
        names, shapes, sizes = self._flat_meta
        return jnp.concatenate([x[n].reshape(-1) for n in names])

    def _unflatten(self, v) -> Dict[str, Array]:
        names, shapes, sizes = self._flat_meta
        out, cur = {}, 0
        for n, sh, sz in zip(names, shapes, sizes):
            out[n] = v[cur : cur + sz].reshape(sh)
            cur += sz
        return out

    def __call__(self, b):
        in_dtype = jax.tree.leaves(b)[0].dtype
        if self.dtype is not None and in_dtype != self.dtype:
            b = jax.tree.map(lambda v: v.astype(self.dtype), b)
        x = self._apply(b)
        if self.dtype is not None and in_dtype != self.dtype:
            x = jax.tree.map(lambda v: v.astype(in_dtype), x)
        return x

    def _apply(self, b):
        x = self._cycle(0, b)
        # identity on inactive/BC rows: the cycle never writes them (z=0
        # there), which makes M singular on the identity block of the
        # masked operator — outer CG then can never correct nonzero
        # Dirichlet components (observed stall at relres ~0.7 with
        # nonhomogeneous u_D).  M must be SPD on the FULL space.
        x = jax.tree.map(
            lambda xi, bi, m: jnp.where(m, xi, bi),
            x,
            b,
            self.levels[0].active,
        )
        has_coarse = self.coarse_Z is not None
        has_band = (
            self.interface_inv is not None or self.schwarz_inv is not None
        )
        if not (has_coarse or has_band):
            return x
        # ONE residual for both multiplicative corrections; the coarse
        # update keeps it current by the precomputed AZ rows (no second
        # operator matvec).  Ordering matters: rank-k coarse correction
        # BEFORE the band solve — the modes' residual lives (almost)
        # entirely in the band, and the band solve afterwards re-slaves
        # the cut DoFs to the corrected bulk (measured: coarse-after-band
        # leaves an O(1) band residual the next outer iteration must redo).
        lvl = self.levels[0]
        r = jax.tree.map(lambda bi, ai: bi - ai, b, lvl.matvec(x))
        rf = self._flatten(r)
        xf = self._flatten(x)
        if has_coarse:
            Z = self.coarse_Z.astype(rf.dtype)
            test = (
                self.coarse_AZ.astype(rf.dtype) if self.coarse_lsq else Z
            )
            c = jnp.matmul(
                self.coarse_Ginv.astype(rf.dtype),
                jnp.matmul(test, rf, precision=HIGHEST),
                precision=HIGHEST,
            )
            xf = xf + jnp.matmul(Z.T, c, precision=HIGHEST)
            if has_band:
                if self.coarse_AZ is not None:
                    rf = rf - jnp.matmul(
                        self.coarse_AZ.astype(rf.dtype).T, c, precision=HIGHEST
                    )
                else:  # legacy attach without AZ: recompute
                    x1 = self._unflatten(xf)
                    r = jax.tree.map(
                        lambda bi, ai: bi - ai, b, lvl.matvec(x1)
                    )
                    rf = self._flatten(r)
        return self._band_correct_flat(xf, rf)

    def _band_correct_flat(self, xf, rf):
        """Multiplicative solve on the cut-cell / ghost-facet DoF block —
        the modes pointwise smoothing cannot contract (the phi-FEM
        analogue of MUMPS' robust pivoting) — given the CURRENT flat
        iterate and residual.  No-op when no interface data is attached."""
        if self.interface_inv is not None:
            corr = jnp.matmul(
                self.interface_inv.astype(rf.dtype),
                rf[self.interface_ids],
                precision=HIGHEST,
            )
            xf = xf.at[self.interface_ids].add(corr)
        elif self.schwarz_inv is not None:
            # scalable variant: multiplicative correction by an INNER
            # Krylov solve of the interface block A_II e = r_I — BiCGStab
            # on the device-resident ELL band matrix, preconditioned by
            # the batched per-cut-entity RAS block inverses.  One-level
            # RAS sweeps alone stall (smooth error modes ALONG the band,
            # observed ~0.9x/iter outer at n=200); ~10 preconditioned
            # inner iterations recover dense-interface-solve quality at
            # O(m) memory (the dense inverse is O(m^2)).  Fixed-sweep
            # fori_loop (not jax.scipy bicgstab): a preconditioner needs
            # bounded work, not an exit test, and the flat loop keeps the
            # compiled graph small.
            m = self.band_ids.shape[0]
            rb = rf[self.band_ids]
            dt = rb.dtype

            def band_mv(v):
                vpad = jnp.concatenate([v, jnp.zeros(1, dt)])
                return (self.band_ell_vals.astype(dt) * vpad[self.band_ell_cols]).sum(
                    axis=1
                )

            def band_ras(v):
                vpad = jnp.concatenate([v, jnp.zeros(1, dt)])
                blocks = vpad[self.schwarz_ids]  # (nb, K)
                cb = jnp.einsum(
                    "bkl,bl->bk", self.schwarz_inv.astype(dt), blocks,
                    precision=HIGHEST,
                )
                upd = jnp.where(self.schwarz_own, cb, 0.0)
                out = jnp.zeros(m + 1, dt).at[self.schwarz_ids].add(upd)
                return out[:m]

            e = _band_bicgstab(band_mv, band_ras, rb, self.schwarz_sweeps)
            xf = xf.at[self.band_ids].add(e)
        return self._unflatten(xf)


@dataclasses.dataclass
class LatticeBulkVCycle(VCycle):
    """Full-box 2D lattice V-cycle as the bulk smoother of a phi-FEM
    preconditioner (see :mod:`phifem_tpu.ops.lattice`).

    Each scalar-P1 field with a uniform stencil batch is cycled on the
    FULL background box (its aggregated vertex stencil, no tagging, no
    per-level assembly); the active mask projects the input/output onto
    Omega_h DoFs.  Everything pointwise smoothing cannot contract — the
    h^-3 penalty/ghost couplings on cut cells, and any auxiliary fields
    (which phi-FEM schemes only carry on cut cells) — is handled by the
    multiplicative interface correction (:func:`attach_interface_solve`),
    exactly as in the flat V-cycle.  Replaces the re-discretized
    hierarchy whose per-level re-tagging and compiles dominated
    preconditioner setup (this builder compiles nothing per level).
    Non-bulk rows fall back to damped Jacobi.
    """

    mgs: Optional[Dict[str, "object"]] = None  # field -> ops.lattice.LatticeMG
    lattice_shapes: Optional[Dict[str, Tuple[int, int]]] = None
    # bulk projection: active AND not interface — the lattice cycle uses
    # pure-Laplacian weights, but cut-cell DoF rows carry h^-3 penalty
    # couplings, so a Laplacian-sized correction there DIVERGES on fine
    # grids (observed at n=200); those DoFs belong to the interface solve
    bulk_masks: Optional[Dict[str, Array]] = None

    def _cycle(self, k: int, b):
        from .ops.lattice import LatticeBlockMG, LatticeVarMG

        lvl = self.levels[0]
        out = {}
        for f, v in b.items():
            mg2 = self.mgs.get(f) if self.mgs else None
            a = lvl.active[f]
            if mg2 is None:
                out[f] = jnp.where(
                    a, self.omega * v * lvl.inv_diag[f], jnp.zeros_like(v)
                )
                continue
            bulk = (
                self.bulk_masks[f]
                if self.bulk_masks is not None and f in self.bulk_masks
                else a
            )
            R, C = self.lattice_shapes[f]
            rmask = jnp.where(bulk, v, jnp.zeros_like(v))
            if isinstance(mg2, (LatticeBlockMG, LatticeVarMG)):
                # vector/tensor P1 field: channels-first block lattice
                vsz = mg2.vsz
                r3 = jnp.moveaxis(rmask.reshape(R, C, vsz), -1, 0)
                rp = jnp.zeros((vsz, R + 2, C + 2), v.dtype).at[
                    :, 1 : 1 + R, 1 : 1 + C
                ].set(r3)
                zp = mg2(rp)
                z = jnp.moveaxis(zp[:, 1 : 1 + R, 1 : 1 + C], 0, -1).reshape(
                    v.shape
                )
            else:
                r2 = rmask.reshape(R, C)
                rp = jnp.zeros((R + 2, C + 2), v.dtype).at[
                    1 : 1 + R, 1 : 1 + C
                ].set(r2)
                zp = mg2(rp)
                z = zp[1 : 1 + R, 1 : 1 + C].reshape(v.shape)
            # interface DoFs get damped Jacobi (assembled diag, penalty-
            # aware); the multiplicative block solve then refines them
            jac = self.omega * v * lvl.inv_diag[f]
            out[f] = jnp.where(
                bulk, z, jnp.where(a, jac, jnp.zeros_like(z))
            )
        return out


@dataclasses.dataclass
class CoupledVCycle:
    """Multilevel COUPLED hierarchy for interface-coupled phi-FEM systems
    (S5 two-material elasticity).

    The bulk/band 2-block splitting is intrinsically h-dependent for
    interface-transmission problems: with EXACT pseudo-inverse bulk and
    band solves (and rigid-mode deflation) the block-GS error propagator
    measures rho = 0.71/0.82/0.87/0.92 at n=16/24/32/48 — the two material
    bulks communicate only through the O(h)-thin band, once per sweep.
    Re-discretizing the WHOLE coupled problem on the halved grid and
    correcting with its pseudo-inverse flattens this to rho ~ 0.37-0.38
    across the same sizes (dense two-grid study, round 3); this class is
    the multilevel production form: each level smooths with its own full
    lattice preconditioner (bulk lattice MG + rank-k floating modes +
    multiplicative band solve), vertex fields transfer by bilinear
    restriction/prolongation, cut-only fields are handled per level by
    that level's band solve, and the coarsest coupled operator is solved
    by dense pseudo-inverse (null-pivot analogue, like the reference's
    MUMPS icntl 24/25 configuration in
    ``demo/interface-elasticity/main.py:251-254``)."""

    # per level: dict(op, grid, matvec, active, M) — M the level smoother
    levels: List[Dict]
    coarse_level: Level  # pack/unpack + pinv of the coarsest coupled op
    vertex_fields: Tuple[str, ...]
    dtype: Optional[jnp.dtype] = jnp.float32
    _version: int = 0

    def __call__(self, b):
        in_dtype = jax.tree.leaves(b)[0].dtype
        if self.dtype is not None and in_dtype != self.dtype:
            b = jax.tree.map(lambda v: v.astype(self.dtype), b)
        x = self._cycle(0, b)
        if self.dtype is not None and in_dtype != self.dtype:
            x = jax.tree.map(lambda v: v.astype(in_dtype), x)
        return x

    def _transfer(self, v, gf, gc, down: bool):
        if v.ndim == 1:
            return restrict(v, gf, gc) if down else prolong(v, gc, gf)
        flat = v.reshape(v.shape[0], -1)
        cols = [
            restrict(flat[:, j], gf, gc) if down else prolong(flat[:, j], gc, gf)
            for j in range(flat.shape[1])
        ]
        return jnp.stack(cols, axis=-1).reshape((-1,) + v.shape[1:])

    def _cycle(self, k: int, b):
        if k == len(self.levels):
            cl = self.coarse_level
            ci = cl.coarse_inv.astype(jax.tree.leaves(b)[0].dtype)
            return cl.unpack(jnp.matmul(ci, cl.pack(b), precision=HIGHEST))
        lvl = self.levels[k]
        x = lvl["M"]._apply(b)
        r = jax.tree.map(lambda bi, ai: bi - ai, b, lvl["matvec"](x))
        # only active-row residuals drive the coarse correction (identity
        # rows carry b - x, which is Dirichlet data, not equation residual)
        r = jax.tree.map(
            lambda ri, m: jnp.where(m, ri, jnp.zeros_like(ri)), r, lvl["active"]
        )
        gf = lvl["grid"]
        gc = (
            self.levels[k + 1]["grid"]
            if k + 1 < len(self.levels)
            else self.coarse_level.grid
        )
        cactive = (
            self.levels[k + 1]["active"]
            if k + 1 < len(self.levels)
            else self.coarse_level.active
        )
        rc = {}
        for name, v in r.items():
            if name in self.vertex_fields:
                vc_ = self._transfer(v, gf, gc, down=True)
                rc[name] = jnp.where(cactive[name], vc_, jnp.zeros_like(vc_))
            else:
                # cut-only fields (fluxes/auxiliaries) re-appear on each
                # level's own cut band and are corrected by that level's
                # band solve; their coarse right-hand side is zero
                rc[name] = jnp.zeros_like(cactive[name], dtype=v.dtype)
        ec = self._cycle(k + 1, rc)
        for name in x:
            if name in self.vertex_fields:
                corr = self._transfer(ec[name], gf, gc, down=False)
                x[name] = jnp.where(
                    lvl["active"][name], x[name] + corr, x[name]
                )
        # post-smooth: a second full smoother application (bulk MG +
        # rank-k modes + band solve) on the corrected residual — without
        # it the V-recursion loses the two-grid rate (measured 17/30 vs
        # exact-coarse ~0.37-flat at n=32/64)
        r2 = jax.tree.map(lambda bi, ai: bi - ai, b, lvl["matvec"](x))
        dx = lvl["M"]._apply(r2)
        x = jax.tree.map(
            lambda xi, di, m: jnp.where(m, xi + di, xi),
            x, dx, lvl["active"],
        )
        return x


def _cast_batch(b, dtype):
    """Copy of an entity batch with matrices (and masks) cast to ``dtype``."""
    from .assembly import Batch
    from .ops.stencil import StencilCellBatch

    if isinstance(b, StencilCellBatch):
        return dataclasses.replace(
            b,
            matrices=jnp.asarray(b.matrices, dtype),
            masks=None if b.masks is None else jnp.asarray(b.masks, dtype),
        )
    return Batch(b.segments, jnp.asarray(b.matrices, dtype), orient=b.orient)


def _masked_matvec(op, bcs, dtype):
    """(matvec, inv_diag, active) like solvers.masked_operator, optionally
    computing in a reduced ``dtype`` (the preconditioner's compute dtype)."""
    from .solvers import masked_operator

    matvec, diag, active = masked_operator(op, bcs)
    inv_diag = jax.tree.map(lambda d: 1.0 / d, diag)
    if dtype is None:
        return matvec, inv_diag, active
    lat = op.lattice_form()
    if lat is not None:
        raw = lat.make_matvec(op, dtype)
    else:
        batches = [_cast_batch(b, dtype) for b in op.batches]

        def raw(x):
            y = {k: jnp.zeros_like(v) for k, v in x.items()}
            for b in batches:
                y = b.matvec_into(x, y)
            return y

    def mv(x):
        xa = jax.tree.map(
            lambda xi, m: jnp.where(m, xi, jnp.zeros_like(xi)), x, active
        )
        y = raw(xa)
        return jax.tree.map(
            lambda yi, xi, m: jnp.where(m, yi, xi), y, x, active
        )

    inv_diag = jax.tree.map(lambda d: d.astype(dtype), inv_diag)
    return mv, inv_diag, active


def _coarse_pinv(op, active) -> Array:
    """Masked dense pseudo-inverse of the coarsest operator, with rows and
    columns permuted into sorted-field-name order (the pack/unpack layout).
    Pseudo-inverse handles the numerically-null penalty pivots the same way
    the reference configures MUMPS (icntl 24/25)."""
    A = op.to_dense()
    off = op.system.offsets()
    n = op.system.num_dofs
    act = np.zeros(n, bool)
    for name, s in op.system.fields.items():
        sl = slice(off[name], off[name] + s.num_dofs)
        act[sl] = np.broadcast_to(np.asarray(active[name]), s.dof_shape).reshape(-1)
    A[~act, :] = 0.0
    A[:, ~act] = 0.0
    A[~act, ~act] = 1.0
    perm = np.concatenate(
        [
            np.arange(off[name], off[name] + op.system.fields[name].num_dofs)
            for name in sorted(op.system.fields)
        ]
    )
    A = A[np.ix_(perm, perm)]
    return jnp.asarray(np.linalg.pinv(A, rcond=1e-12))


def data_dependent_selection(op, active) -> Dict[str, np.ndarray]:
    """Boolean masks (per field, dof_shape) of active DoFs touched by any
    data-dependent (rebuildable) batch — the cut-cell/ghost/boundary block
    that carries the h^-3 penalty couplings."""
    sel = {n: np.zeros(s.dof_shape, bool) for n, s in op.system.fields.items()}
    for b in op.batches:
        if getattr(b, "rebuild", None) is None:
            continue
        for name, dofs, vs in b.segments:
            m = sel[name]
            m_flat = m.reshape(m.shape[0], -1)
            m_flat[np.asarray(dofs).reshape(-1)] = True
    for n in sel:
        sel[n] &= np.broadcast_to(
            np.asarray(active[n]), op.system.fields[n].dof_shape
        )
    return sel


def _blocks_from_ell(
    ecols: np.ndarray, evals: np.ndarray, bids: np.ndarray, pad: int,
    chunk: int = 256,
) -> np.ndarray:
    """Batched dense submatrices ``A[bl][:, bl]`` for the RAS blocks,
    gathered from the (m+1, nnzmax) ELL layout (row ``pad`` is the zero
    padding row).  Vectorized over blocks in chunks; the per-column loop
    keeps peak memory at chunk*K*nnzmax."""
    nb, K = bids.shape
    out = np.zeros((nb, K, K))
    for s in range(0, nb, chunk):
        b = bids[s : s + chunk]  # (B, K)
        rc = ecols[b]  # (B, K, nnzmax)
        rv = evals[b]
        for j in range(K):
            m = rc == b[:, None, j, None]
            out[s : s + chunk, :, j] = (rv * m).sum(axis=-1)
    return out


def attach_coarse_correction(vc: VCycle, op, active, vectors, bcs=()) -> VCycle:
    """Equip a V-cycle with a rank-k multiplicative Galerkin correction
    ``x += Z G^{-1} Z^T (b - A x)`` with ``G = Z A Z^T`` over the given
    mode ``vectors`` (pytrees in system field layout).

    This is the coarse space of substructuring methods (FETI-DP/BDDC):
    without it, error components along the near-null modes of a floating
    block (e.g. rigid motions of an ungrounded phi-FEM subdomain, whose
    operator energy lives entirely in the cut-cell band) are only reduced
    through their O(h)-thin residual trace next to the band, and outer
    Krylov iterations grow like 1/h (measured on S5: 15/39/108 at
    n=32/64/128 without this; grid-independent with it).  The reference
    sidesteps the issue with a sparse direct solve (MUMPS,
    ``demo/interface-elasticity/main.py:237-288``)."""
    from .solvers import masked_operator

    if not vectors:
        return vc
    matvec, _, _ = masked_operator(op, bcs)
    names = list(op.system.fields)
    shapes = [tuple(op.system.fields[n].dof_shape) for n in names]
    sizes = [int(np.prod(sh)) for sh in shapes]
    if vc._flat_meta is None:
        vc._flat_meta = (names, shapes, sizes)

    def flat(v):
        return np.concatenate(
            [np.broadcast_to(np.asarray(v[n]), sh).reshape(-1)
             for n, sh in zip(names, shapes)]
        )

    Zs, AZs = [], []
    for v in vectors:
        vm = {}
        nrm2 = 0.0
        for n, sh in zip(names, shapes):
            act = np.broadcast_to(np.asarray(active[n]), sh)
            w = np.where(act, np.broadcast_to(np.asarray(v[n]), sh), 0.0)
            nrm2 += float((w * w).sum())
            vm[n] = w
        # normalize each masked mode: enriched bases (interface Fourier
        # modes) mix wildly different row norms and the Galerkin solve
        # below is pseudo-inverted by singular value, not by index
        s = 1.0 / max(np.sqrt(nrm2), 1e-300)
        vm = {n: jnp.asarray(w * s) for n, w in vm.items()}
        Zs.append(flat(vm))
        AZs.append(flat(matvec(vm)))
    Z = np.stack(Zs)
    AZ = np.stack(AZs)
    G = Z @ AZ.T
    # pseudo-inverse: an enriched coarse basis may be (near-)linearly
    # dependent after masking, and pairs of modes may sum to an exact
    # null-space direction (e.g. S5's collective rigid motions, deflated
    # by the outer Krylov solve) — both make G singular by construction
    vc.coarse_Z = jnp.asarray(Z)
    vc.coarse_AZ = jnp.asarray(AZ)  # residual update without a 2nd matvec
    vc.coarse_Ginv = jnp.asarray(np.linalg.pinv(G, rcond=1e-10))
    vc._version += 1
    return vc


def attach_coarse_correction_device(vc: VCycle, op, active, z_builder, bcs=()) -> VCycle:
    """Device-resident variant of :func:`attach_coarse_correction`.

    ``z_builder() -> (k, n_flat) jnp array`` constructs the raw coarse
    basis ON DEVICE (closed-form from iotas/coordinate lattices — e.g.
    the S5 interface-harmonic Fourier modes).  Everything else — masking
    to active DoFs, row normalization, the k matvecs for A Z (one
    ``lax.map`` over rows), the Galerkin matrix and its pseudo-inverse —
    runs inside ONE jitted program, so NOTHING of size O(k * n) ever
    crosses between host and device (the host-built path uploads
    ~2 k n doubles: 600 MB at S5 bench sizes)."""
    from .solvers import masked_operator

    matvec, _, _ = masked_operator(op, bcs)
    names = list(op.system.fields)
    shapes = [tuple(op.system.fields[n].dof_shape) for n in names]
    sizes = [int(np.prod(sh)) for sh in shapes]
    if vc._flat_meta is None:
        vc._flat_meta = (names, shapes, sizes)

    act_flat = jnp.concatenate(
        [
            jnp.broadcast_to(jnp.asarray(active[n]), sh).reshape(-1)
            for n, sh in zip(names, shapes)
        ]
    )

    def unflat(z):
        out, cur = {}, 0
        for n, sh, sz in zip(names, shapes, sizes):
            out[n] = z[cur : cur + sz].reshape(sh)
            cur += sz
        return out

    def flat(d):
        return jnp.concatenate([d[n].reshape(-1) for n in names])

    @jax.jit
    def _build():
        Z = z_builder()
        Z = jnp.where(act_flat[None, :], Z, 0.0)
        nrm = jnp.sqrt(jnp.sum(Z * Z, axis=1, keepdims=True))
        Z = Z / jnp.maximum(nrm, 1e-300)
        AZ = jax.lax.map(lambda z: flat(matvec(unflat(z))), Z)
        return Z, AZ, jnp.matmul(Z, AZ.T, precision=HIGHEST)

    vc.coarse_Z, vc.coarse_AZ, G = _build()
    # pinv of the TINY (k, k) Galerkin matrix on the HOST: one 540 KB
    # fetch instead of an f64 SVD compiled on device
    vc.coarse_Ginv = jnp.asarray(
        np.linalg.pinv(np.asarray(G), rcond=1e-10)
    )
    vc._version += 1
    return vc


def attach_ritz_modes(
    vc: VCycle,
    op,
    active,
    bcs=(),
    deflate=(),
    n_arnoldi: int = 30,
    n_keep: int = 8,
    tol_lam: float = 0.5,
    seed: int = 0,
) -> VCycle:
    """GenEO-lite slow-mode harvesting: append the dominant Ritz vectors
    of the preconditioned error propagator ``E = I - M A`` to the rank-k
    Galerkin coarse space.

    The closed-form interface-harmonic coarse space (S5) leaves a slow
    tail at fine grids (measured 45 outer iterations at n=256 vs the 37 a
    clean 1.5x/doubling would give, `docs/s5_preconditioner.md`): the
    harmonic radial profiles are only approximate off the circle under
    the 1000x contrast.  Instead of guessing better closed forms, run a
    short Arnoldi iteration ON the error propagator of the assembled
    preconditioner — its dominant eigenvectors ARE the modes the cycle
    contracts worst — and put their Ritz approximations in the coarse
    space (the spectral coarse-space idea of GenEO, without the
    per-subdomain generalized eigenproblems: one global Krylov space of
    size ``n_arnoldi``, each step costing one matvec + one cycle).

    ``deflate``: pytrees spanning the operator's known null space (e.g.
    S5's collective rigid modes).  E has eigenvalue ~1 on them by
    construction, so the Arnoldi space must be kept orthogonal to them
    or the harvest returns modes the outer solve already deflates.
    Ritz vectors with ``|lambda| < tol_lam`` are discarded (the cycle
    already contracts them fine).  Idempotent-ish: call after the other
    attach_* equips; bumps ``_version``."""
    from .solvers import masked_operator

    matvec, _, _ = masked_operator(op, bcs)
    names = list(op.system.fields)
    shapes = [tuple(op.system.fields[n].dof_shape) for n in names]
    sizes = [int(np.prod(sh)) for sh in shapes]
    if vc._flat_meta is None:
        vc._flat_meta = (names, shapes, sizes)

    act_flat = np.concatenate(
        [
            np.broadcast_to(np.asarray(active[n]), sh).reshape(-1)
            for n, sh in zip(names, shapes)
        ]
    )

    def unflat(z):
        out, cur = {}, 0
        for n, sh, sz in zip(names, shapes, sizes):
            out[n] = jnp.asarray(z[cur : cur + sz].reshape(sh))
            cur += sz
        return out

    def flat(d):
        return np.concatenate(
            [np.asarray(d[n]).reshape(-1) for n in names]
        )

    A_ = jax.jit(lambda x: matvec(x))
    M_ = jax.jit(lambda r: vc._apply(r))

    # orthonormalize the null basis (masked) for projection
    Q = []
    for v in deflate:
        q = flat(v) * act_flat
        for o in Q:
            q = q - o @ q * o
        nq = np.linalg.norm(q)
        if nq > 1e-12:
            Q.append(q / nq)

    def proj(v):
        for o in Q:
            v = v - (o @ v) * o
        return v

    rng = np.random.default_rng(seed)
    n_flat = int(act_flat.shape[0])
    v = proj(rng.standard_normal(n_flat) * act_flat)
    v /= np.linalg.norm(v)
    V = [v]
    H = np.zeros((n_arnoldi + 1, n_arnoldi))
    for j in range(n_arnoldi):
        x = unflat(V[j])
        w = V[j] - flat(M_(unflat(flat(A_(x)))))  # E v = v - M A v
        w = proj(w * act_flat)
        for _pass in range(2):  # MGS, two passes for orthogonality
            for i in range(j + 1):
                c = V[i] @ w
                H[i, j] += c
                w = w - c * V[i]
        H[j + 1, j] = np.linalg.norm(w)
        if H[j + 1, j] < 1e-12:
            break
        V.append(w / H[j + 1, j])
    m = len(V) - 1
    lam, Y = np.linalg.eig(H[:m, :m])
    order = np.argsort(-np.abs(lam))
    keep = [i for i in order[:n_keep] if np.abs(lam[i]) >= tol_lam]
    if not keep:
        return vc
    Vm = np.stack(V[:m], axis=1)  # (n_flat, m)
    Zs, AZs = [], []
    for i in keep:
        z = np.real(Vm @ Y[:, i])
        nz = np.linalg.norm(z)
        if nz < 1e-12:
            continue
        z /= nz
        Zs.append(z)
        AZs.append(flat(A_(unflat(z))))
    if not Zs:
        return vc
    Z_new = np.stack(Zs)
    AZ_new = np.stack(AZs)
    if vc.coarse_Z is not None:
        Z = np.concatenate([np.asarray(vc.coarse_Z), Z_new])
        AZ = np.concatenate([np.asarray(vc.coarse_AZ), AZ_new])
    else:
        Z, AZ = Z_new, AZ_new
    # Galerkin test space (Z A Z'): the residual-minimizing alternative
    # (AZ AZ') was tried and is FUNDAMENTALLY wrong for near-null slow
    # modes — their ||A z|| is tiny, so the normal-equations projection
    # weights exactly them least (measured: S5 n=128 outer iterations
    # 23 -> 53 with the lsq form vs 23 -> 24 with Galerkin).
    G = Z @ AZ.T
    vc.coarse_Z = jnp.asarray(Z)
    vc.coarse_AZ = jnp.asarray(AZ)
    vc.coarse_Ginv = jnp.asarray(np.linalg.pinv(G, rcond=1e-10))
    vc._version += 1
    return vc


def attach_interface_solve(
    vc: VCycle,
    op,
    active,
    dense_max: int = 4000,
    sweeps: Optional[int] = None,
    kind: str = "auto",
    sweeps_coef: float = 0.2,
) -> VCycle:
    """Equip a V-cycle with a solve on the data-dependent DoF block (all
    DoFs touched by cut-cell penalty / ghost-facet / boundary batches).

    These carry the h^-3-scaled penalty couplings that pointwise smoothing
    cannot contract (measured Richardson stall ~0.3).  Two variants:

    * ``m <= dense_max`` (or ``kind="dense"``): exact dense pseudo-inverse
      on the whole block — grid-independent convergence, O(m^2) memory;
    * beyond: restricted additive Schwarz over the cut *entities* — one
      overlapping dense block per data-dependent batch entity (cut cell,
      ghost facet pair, boundary facet cell), inverted host-side from the
      sparse interface submatrix and applied as one batched matmul.  O(m)
      memory and setup; scales to arbitrarily fine grids.
    """
    sel = data_dependent_selection(op, active)
    total = sum(int(m.sum()) for m in sel.values())
    if total == 0:
        return vc

    names = list(op.system.fields)
    shapes = [tuple(op.system.fields[n].dof_shape) for n in names]
    sizes = [int(np.prod(sh)) for sh in shapes]
    vc._flat_meta = (names, shapes, sizes)

    if kind == "dense" or (kind == "auto" and total <= dense_max):
        A_II, ids = op.restricted_dense(sel)
        # identity on rows whose diagonal vanished entirely within the
        # block, plus a tiny Tikhonov shift: LU inverse is O(n^3/3) where
        # SVD-pinv is ~25x that — this is a preconditioner, exactness is
        # not required
        dz = np.abs(np.diag(A_II)) < 1e-300
        A_II[dz, dz] = 1.0
        shift = 1e-12 * np.abs(np.diag(A_II)).max()
        A_II[np.diag_indices_from(A_II)] += shift
        # store in the cycle's compute dtype: _apply casts per
        # application otherwise, and at band sizes m ~ 9k (S5 n=128) the
        # f64->f32 cast of the m x m inverse is a second pass over it
        vc.interface_inv = jnp.asarray(
            np.linalg.inv(A_II), vc.dtype or np.float64
        )
        vc.interface_ids = jnp.asarray(ids)
        vc._version += 1
        return vc

    # ---- Schwarz block path
    import scipy.sparse  # noqa: F401  (restricted_csr needs it)

    A_csr, ids = op.restricted_csr(sel)
    A_csr = A_csr.tocsr()
    off, _, idx_of = op._selection_ids(sel)
    n_flat = op.system.num_dofs

    # one overlapping block per data-dependent entity; block = the entity's
    # selected DoFs (compact interface indices)
    blocks: List[np.ndarray] = []
    for b in op.batches:
        if getattr(b, "rebuild", None) is None:
            continue
        l = idx_of[b.entity_global_dofs(off)]  # (ne, L)
        for row in l:
            bl = np.unique(row[row >= 0])
            if bl.size:
                blocks.append(bl)
    K = max(bl.size for bl in blocks)
    nb = len(blocks)
    bids = np.full((nb, K), total, np.int64)  # pad -> compact slot `total`
    for i, bl in enumerate(blocks):
        bids[i, : bl.size] = bl
    # RAS ownership: each interface DoF corrected from exactly one block
    owner = -np.ones(total, np.int64)
    own = np.zeros((nb, K), bool)
    for i, bl in enumerate(blocks):
        new = bl[owner[bl] < 0]
        owner[new] = i
        own[i, : bl.size] = owner[blocks[i]] == i
    # ELL layout of the band matrix (built first: the vectorized block
    # extraction below gathers from it instead of per-block scipy slicing,
    # which measured ~0.5 ms x nb blocks at large interfaces)
    nnz_row0 = np.diff(A_csr.indptr)
    nnzmax0 = max(1, int(nnz_row0.max()))
    ecols0 = np.full((total + 1, nnzmax0), total, np.int64)
    evals0 = np.zeros((total + 1, nnzmax0))
    rr = np.repeat(np.arange(total), nnz_row0)
    oo = np.arange(A_csr.nnz) - np.repeat(A_csr.indptr[:-1], nnz_row0)
    ecols0[rr, oo] = A_csr.indices
    evals0[rr, oo] = A_csr.data
    # batched dense block extraction + inverse (vectorized, host-side)
    mats = _blocks_from_ell(ecols0, evals0, bids, total)
    # identity on padded slots and numerically-null diagonals
    diag_idx = np.arange(K)
    dvals = mats[:, diag_idx, diag_idx]
    fix = (np.abs(dvals) < 1e-300) | (bids >= total)
    mats[:, diag_idx, diag_idx] = np.where(fix, 1.0, dvals)
    inv = np.linalg.inv(mats)
    # blocks/ownership stay in COMPACT band index space (pad slot = total)
    vc.schwarz_ids = jnp.asarray(bids)
    vc.schwarz_inv = jnp.asarray(inv, vc.dtype or np.float64)
    vc.schwarz_own = jnp.asarray(own)
    # inner-iteration demand grows slowly with band size (measured: 10 at
    # m~3k, 20 at m~12k for the S1 scalar block) — scale ~sqrt(m) unless
    # the caller pins it; harder cut blocks (S5's contrast-weighted
    # 5-field penalty) need a larger coefficient (0.6 measured at n=64)
    vc.schwarz_sweeps = (
        sweeps if sweeps is not None else max(10, int(sweeps_coef * total**0.5))
    )
    # the band matrix itself in ELL layout for the inner device solve
    A = A_csr.tocsr()
    nnz_row = np.diff(A.indptr)
    nnzmax = max(1, int(nnz_row.max()))
    cols = np.full((total, nnzmax), total, np.int64)
    vals = np.zeros((total, nnzmax))
    rows_rep = np.repeat(np.arange(total), nnz_row)
    offs2 = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz_row)
    cols[rows_rep, offs2] = A.indices
    vals[rows_rep, offs2] = A.data
    # identity rows for any fully-zero band row (keeps A_II invertible)
    zr = nnz_row == 0
    cols[zr, 0] = np.where(zr)[0]
    vals[zr, 0] = 1.0
    vc.band_ids = jnp.asarray(ids)
    vc.band_ell_cols = jnp.asarray(cols, jnp.int32)
    vc.band_ell_vals = jnp.asarray(vals, vc.dtype or np.float64)
    vc._version += 1
    return vc


def build_hierarchy(
    fine_grid: Grid,
    make_level: Callable[[Grid], Tuple],
    min_n: int = 8,
    dense_coarse: bool = True,
    max_coarse_dofs: int = 6000,
    dtype=None,
    **vcycle_kw,
) -> VCycle:
    """Build a V-cycle from a level factory.

    ``make_level(grid) -> (op, bcs)`` re-discretizes the problem on each
    coarser grid (with its own tagging).  Coarsening stops when nx or ny
    would drop below ``min_n`` or become odd.  The coarsest level gets an
    exact dense (pseudo-inverse) solve when small enough.  ``dtype`` sets
    the cycle's compute dtype (see :class:`VCycle`).
    """
    grids = [fine_grid]
    g = fine_grid
    while (
        g.nx % 2 == 0
        and g.ny % 2 == 0
        and g.nx // 2 >= min_n
        and g.ny // 2 >= min_n
    ):
        g = Grid(g.nx // 2, g.ny // 2, g.bbox, g.cell_type)
        grids.append(g)

    levels = []
    vertex_fields: Optional[Tuple[str, ...]] = None
    for i, g in enumerate(grids):
        op, bcs = make_level(g)
        matvec, inv_diag, active = _masked_matvec(op, bcs, dtype)
        if vertex_fields is None:
            vertex_fields = tuple(
                n for n, v in active.items() if v.shape[0] == g.num_vertices
            )
        lvl = Level(
            g,
            matvec,
            inv_diag,
            active,
            field_shapes={k: tuple(v.shape) for k, v in active.items()},
        )
        if (
            i == len(grids) - 1
            and dense_coarse
            and op.system.num_dofs <= max_coarse_dofs
        ):
            ci = _coarse_pinv(op, active)
            lvl.coarse_inv = ci if dtype is None else ci.astype(dtype)
        levels.append(lvl)
    return VCycle(levels, vertex_fields, dtype=dtype, **vcycle_kw)
