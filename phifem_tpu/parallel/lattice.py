"""Distributed lattice multigrid: the north-star Poisson solver sharded
over a 1D device mesh (``jax.shard_map`` + ``lax.ppermute`` halos).

Row-slab decomposition of the 2D vertex lattice (``ops/lattice.py``): each
device owns ``m`` logical rows; every stencil/transfer application
exchanges ONE halo row per neighbour over the mesh axis (ICI on real
hardware), and Krylov dot products ``psum``.  Levels coarsen locally —
slab boundaries sit at even logical rows, so coarse row ``i`` (fine row
``2i``) stays on its device and restriction/prolongation never
communicate beyond the same 1-row halo.  When a level's slab height would
drop below ``replicate_rows``, the remaining hierarchy tail is
``all_gather``-ed and every device runs it redundantly (the classic
coarse-grid agglomeration strategy — the tail is tiny).

This is the distributed counterpart of ``ops.lattice.lattice_cg``
(float64 CG + float32 V-cycle, f32 coefficient dots, one on-chip
``lax.while_loop``), replacing the reference's PETSc-over-MPI solve path
(SURVEY 2c / N13) for the uniform-grid problem class.  The general
phi-FEM operator path is :mod:`phifem_tpu.parallel.halo`.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import HIGHEST
from ..ops.lattice import LatticeMG, _terms, _dense_coarse_inv

Array = jnp.ndarray

AXIS = "shard"

__all__ = ["ShardedLatticeMG", "build_sharded_lattice_mg"]


def _exchange_rows(x: Array, nP: int) -> Array:
    """(m, C) local block -> (m+2, C) with neighbour ghost rows (zeros at
    the global ends — ppermute drops unreceived slots to zero)."""
    top = lax.ppermute(x[-1:], AXIS, [(i, i + 1) for i in range(nP - 1)])
    bot = lax.ppermute(x[:1], AXIS, [(i + 1, i) for i in range(nP - 1)])
    return jnp.concatenate([top, x, bot], axis=0)


@dataclasses.dataclass(frozen=True)
class _SLevel:
    R: int  # global logical rows (ny + 1)
    C: int  # global logical cols (nx + 1)
    m: int  # logical rows per device (R <= nP * m, m even unless tail)


@dataclasses.dataclass
class ShardedLatticeMG:
    """Distributed V-cycle + CG over row slabs.  Local block layout per
    level: (m, C+2) float, logical col ``c`` at index ``c+1``; device
    ``d`` owns logical rows ``[d*m, (d+1)*m)`` (rows >= R are dead)."""

    levels: List[_SLevel]
    terms: List[Tuple[int, int, float]]
    tail: Optional[LatticeMG]  # replicated coarse hierarchy (or None)
    coarse_inv: Optional[Array]  # dense inverse when the tail IS the bottom
    nP: int
    dtype: jnp.dtype = jnp.float32
    omega: float = 0.8
    pre_smooth: int = 2
    post_smooth: int = 2

    def __post_init__(self):
        self._dinv = 1.0 / next(wt for a, b, wt in self.terms if a == 1 and b == 1)

    # ---- all shapes below are LOCAL per-device blocks (shard_map body)
    def _row_valid(self, lvl: _SLevel, d: Array, interior: bool) -> Array:
        gr = d * lvl.m + lax.broadcasted_iota(jnp.int32, (lvl.m, 1), 0)
        lo = 1 if interior else 0
        hi = lvl.R - 2 if interior else lvl.R - 1
        return (gr >= lo) & (gr <= hi)

    def _conv(self, x: Array, lvl: _SLevel, d: Array) -> Array:
        """Reduced operator on the local block: (m, C+2) -> (m, C+2)."""
        e = _exchange_rows(x, self.nP)
        C = lvl.C
        acc = None
        for a, b, wt in self.terms:
            part = jnp.asarray(wt, x.dtype) * e[a : a + lvl.m, b : b + C]
            acc = part if acc is None else acc + part
        out = jnp.zeros_like(x)
        out = out.at[:, 2 : C].set(acc[:, 1 : C - 1])
        return jnp.where(self._row_valid(lvl, d, True), out, 0.0)

    def _smooth(self, x, bb, lvl: _SLevel, d, sweeps: int):
        od = jnp.asarray(self.omega * self._dinv, x.dtype)
        for _ in range(sweeps):
            x = x + od * (bb - self._conv(x, lvl, d))
        return x

    def _restrict(self, r: Array, lvl: _SLevel, nxt: _SLevel, d: Array) -> Array:
        e = _exchange_rows(r, self.nP)
        C, Cc = lvl.C, nxt.C
        out = None
        for s, ws in ((-1, 0.5), (0, 1.0), (1, 0.5)):
            rows = e[1 + s :: 2][: nxt.m]
            for t, wt in ((-1, 0.5), (0, 1.0), (1, 0.5)):
                part = (ws * wt) * rows[:, 1 + t :: 2][:, :Cc]
                out = part if out is None else out + part
        bc = jnp.zeros((nxt.m, Cc + 2), r.dtype).at[:, 1 : 1 + Cc].set(out)
        # zero logical borders / dead rows on the coarse level
        bc = bc.at[:, 1].set(0.0).at[:, Cc].set(0.0)
        return jnp.where(self._row_valid(nxt, d, True), bc, 0.0)

    def _prolong(self, ec: Array, lvl: _SLevel, nxt: _SLevel, d: Array) -> Array:
        """Coarse local (m_c, Cc+2) -> fine local correction (m_f, C+2)."""
        e = _exchange_rows(ec, self.nP)
        Cc, C = nxt.C, lvl.C
        E = e[:, 1 : 1 + Cc]  # (m_c+2, Cc) logical cols
        # column interpolation: (rows, 2*Cc-1) == (rows, C)
        H = 0.5 * (E[:, :-1] + E[:, 1:])
        body = jnp.stack([E[:, : Cc - 1], H], axis=2).reshape(E.shape[0], -1)
        W = jnp.concatenate([body, E[:, Cc - 1 :]], axis=1)  # (m_c+2, C)
        A = W[1 : 1 + nxt.m]  # own coarse rows
        B = 0.5 * (A + W[2 : 2 + nxt.m])  # avg with next row (ghost-aware)
        F = jnp.stack([A, B], axis=1).reshape(lvl.m, C)  # fine local rows
        out = jnp.zeros((lvl.m, C + 2), ec.dtype).at[:, 1 : 1 + C].set(F)
        out = out.at[:, 1].set(0.0).at[:, C].set(0.0)
        return jnp.where(self._row_valid(lvl, d, True), out, 0.0)

    def _tail_solve(self, bb: Array, lvl: _SLevel, d: Array) -> Array:
        """Agglomerated coarse solve: gather the slabs, run the replicated
        tail (LatticeMG cycle or dense inverse) identically everywhere,
        slice own rows back."""
        allb = lax.all_gather(bb, AXIS)  # (nP, m, C+2)
        full = allb.reshape(self.nP * lvl.m, lvl.C + 2)
        bp = jnp.zeros((lvl.R + 2, lvl.C + 2), bb.dtype)
        bp = bp.at[1 : 1 + lvl.R].set(full[: lvl.R])
        if self.tail is not None:
            xp = self.tail._cycle(0, bp)
        else:
            v = jnp.matmul(
                self.coarse_inv.astype(bb.dtype),
                bp[2 : lvl.R, 2 : lvl.C].reshape(-1),
                precision=HIGHEST,
            )
            xp = jnp.zeros_like(bp).at[2 : lvl.R, 2 : lvl.C].set(
                v.reshape(lvl.R - 2, lvl.C - 2)
            )
        xfull = jnp.zeros((self.nP * lvl.m, lvl.C + 2), bb.dtype)
        xfull = xfull.at[: lvl.R].set(xp[1 : 1 + lvl.R])
        return lax.dynamic_slice(
            xfull,
            (d * jnp.int32(lvl.m), jnp.int32(0)),
            (lvl.m, lvl.C + 2),
        )

    def _cycle(self, k: int, bb, d):
        lvl = self.levels[k]
        if k == len(self.levels) - 1:
            return self._tail_solve(bb, lvl, d)
        x = self._smooth(jnp.zeros_like(bb), bb, lvl, d, self.pre_smooth)
        r = bb - self._conv(x, lvl, d)
        nxt = self.levels[k + 1]
        bc = self._restrict(r, lvl, nxt, d)
        ec = self._cycle(k + 1, bc, d)
        x = x + self._prolong(ec, lvl, nxt, d)
        return self._smooth(x, bb, lvl, d, self.post_smooth)

    # ------------------------------------------------------------- solve
    def cg(self, bb: Array, tol: float = 1e-10, maxiter: int = 40):
        """Local-block body of the distributed MG-CG; call under
        ``shard_map`` (in_specs=P('shard', None)).  Returns (x, relres,
        iters) with x the local solution block."""
        lvl = self.levels[0]
        d = lax.axis_index(AXIS)
        dt = bb.dtype

        def pdot32(a, b):
            return lax.psum(
                jnp.vdot(
                    a.astype(jnp.float32),
                    b.astype(jnp.float32),
                    precision=HIGHEST,
                ),
                AXIS,
            ).astype(dt)

        def matvec(x):
            return self._conv(x, lvl, d).astype(dt)

        def precond(r):
            z = self._cycle(0, r.astype(self.dtype), d)
            return z.astype(dt)

        bnorm = jnp.sqrt(pdot32(bb, bb))
        bscale = jnp.maximum(bnorm, jnp.finfo(dt).tiny)
        bn = bb / bscale
        tol2 = jnp.asarray(tol, dt) ** 2

        def body(state):
            x, r, p, z, rz, it = state
            Ap = matvec(p)
            alpha = rz / pdot32(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = pdot32(r, z)
            p = z + (rz_new / rz) * p
            return x, r, p, z, rz_new, it + 1

        def cond(state):
            x, r, p, z, rz, it = state
            return jnp.logical_and(pdot32(r, r) > tol2, it < maxiter)

        x = jnp.zeros_like(bn)
        z0 = precond(bn)
        state = (x, bn, z0, z0, pdot32(bn, z0), jnp.asarray(0, jnp.int32))
        x, r, p, z, rz, it = lax.while_loop(cond, body, state)
        relres = jnp.sqrt(pdot32(r, r))
        return x * bscale, relres, it


def build_sharded_lattice_mg(
    nx: int,
    ny: int,
    w: np.ndarray,
    mesh: Mesh,
    min_n: int = 16,
    replicate_rows: int = 32,
    dtype=jnp.float32,
    **kw,
) -> ShardedLatticeMG:
    """Plan the distributed hierarchy for an ``nx x ny`` lattice over
    ``mesh`` (1D, axis 'shard').  Distributed levels keep even slab
    heights; the rest becomes the replicated tail."""
    nP = mesh.shape[AXIS]
    R0, C0 = ny + 1, nx + 1
    # how many levels can stay distributed: m halves each level and must
    # stay even (so slab edges remain at even logical rows) and >= limit
    grids = [(nx, ny)]
    gx, gy = nx, ny
    while gx % 2 == 0 and gy % 2 == 0 and gx // 2 >= min_n and gy // 2 >= min_n:
        gx //= 2
        gy //= 2
        grids.append((gx, gy))
    n_dist = 1
    for k in range(1, len(grids)):
        m_would = -(-(grids[k][1] + 1) // nP)
        if m_would < replicate_rows:
            break
        n_dist = k + 1
    # slab heights: m_0 a multiple of 2^(n_dist-1) so every distributed
    # level's m is even
    align = 2 ** (n_dist - 1)
    m0 = -(-R0 // nP)
    m0 = -(-m0 // align) * align
    levels = [
        _SLevel(grids[k][1] + 1, grids[k][0] + 1, m0 // (2**k))
        for k in range(n_dist)
    ]
    terms = _terms(np.asarray(w))
    tail = None
    coarse_inv = None
    if n_dist < len(grids):
        from ..ops.lattice import build_lattice_mg

        gx, gy = grids[n_dist - 1]
        tail = build_lattice_mg(gx, gy, w, min_n=min_n, dtype=dtype)
        # the tail's finest level == the last distributed level; its own
        # _cycle handles smoothing + deeper levels + dense bottom
    else:
        coarse_inv = jnp.asarray(
            _dense_coarse_inv(terms, grids[-1][1] + 1, grids[-1][0] + 1), dtype
        )
    return ShardedLatticeMG(
        levels, terms, tail, coarse_inv, nP, dtype=dtype, **kw
    )


def sharded_lattice_solve(
    mg: ShardedLatticeMG,
    mesh: Mesh,
    b2d: Array,
    tol: float = 1e-10,
    maxiter: int = 40,
):
    """Distributed solve of the reduced lattice system.

    ``b2d``: global (R, C) logical RHS (reduced: borders zero).  Returns
    (u2d (R, C), relres, iters).  The RHS is padded to ``nP * m`` rows and
    row-sharded; the whole MG-CG runs as ONE shard_map program.
    """
    lvl = mg.levels[0]
    R, C = lvl.R, lvl.C
    total = mg.nP * lvl.m
    # the reduced system carries identity rows on the logical border; a
    # nonzero border RHS entry would leave an irreducible residual (CG
    # would silently never converge), so zero it defensively here
    b2d = b2d.at[0, :].set(0.0).at[-1, :].set(0.0)
    b2d = b2d.at[:, 0].set(0.0).at[:, -1].set(0.0)
    bp = jnp.zeros((total, C + 2), b2d.dtype)
    bp = bp.at[:R, 1 : 1 + C].set(b2d)
    bp = jax.device_put(bp, NamedSharding(mesh, P(AXIS, None)))

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(AXIS, None),
        out_specs=(P(AXIS, None), P(), P()),
    )
    def run(bb):
        x, rel, it = mg.cg(bb, tol=tol, maxiter=maxiter)
        return x, rel, it

    x, rel, it = run(bp)
    return x[:R, 1 : 1 + C], float(rel), int(it)
