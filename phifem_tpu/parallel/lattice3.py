"""Distributed 3D lattice multigrid: z-plane slabs over a 1D device mesh.

The 3D counterpart of :mod:`phifem_tpu.parallel.lattice` for
:mod:`phifem_tpu.ops.lattice3`: each device owns ``m`` logical z-planes of
the ``(D, R, C)`` vertex lattice; every 27-point stencil / transfer
application exchanges ONE halo plane per neighbour (``lax.ppermute`` —
ICI on real hardware), Krylov dots ``psum``.  Coarsening keeps slab edges
at even logical planes so transfers never need more than the same 1-plane
halo; when a level's slab height would drop below ``replicate_planes``
the remaining hierarchy tail is ``all_gather``-ed and run redundantly
(coarse-grid agglomeration).  Unlike 2D, levels carry their OWN stencils
(3D uniform terms scale inhomogeneously with h, see ops/lattice3).
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
from ..ops.lattice3 import (
    Lattice3MG,
    _dense_coarse_inv3,
    _terms3,
    build_lattice3_mg,
    hex_element_matrix,
    vertex_stencil_weights3,
)

Array = jnp.ndarray

AXIS = "shard"

__all__ = ["ShardedLattice3MG", "build_sharded_lattice3_mg", "sharded_lattice3_solve"]


def _exchange_planes(x: Array, nP: int) -> Array:
    """(m, R+2, C+2) local block -> (m+2, ...) with neighbour ghost planes."""
    top = lax.ppermute(x[-1:], AXIS, [(i, i + 1) for i in range(nP - 1)])
    bot = lax.ppermute(x[:1], AXIS, [(i + 1, i) for i in range(nP - 1)])
    return jnp.concatenate([top, x, bot], axis=0)


@dataclasses.dataclass(frozen=True)
class _SLevel3:
    D: int  # global logical z-planes (nz + 1)
    R: int
    C: int
    m: int  # planes per device
    terms: Tuple[Tuple[int, int, int, float], ...]


@dataclasses.dataclass
class ShardedLattice3MG:
    """Distributed V-cycle + CG over z-plane slabs.  Local layout per
    level: (m, R+2, C+2); logical (r, c) at (+1, +1); device ``d`` owns
    logical planes ``[d*m, (d+1)*m)`` (planes >= D are dead)."""

    levels: List[_SLevel3]
    tail: Optional[Lattice3MG]
    coarse_inv: Optional[Array]
    nP: int
    dtype: jnp.dtype = jnp.float32
    omega: float = 0.8
    pre_smooth: int = 2
    post_smooth: int = 2

    def _dinv(self, k: int) -> float:
        return 1.0 / next(
            wt
            for a, b, c, wt in self.levels[k].terms
            if (a, b, c) == (1, 1, 1)
        )

    def _plane_valid(self, lvl: _SLevel3, d: Array, interior: bool) -> Array:
        gz = d * lvl.m + lax.broadcasted_iota(jnp.int32, (lvl.m, 1, 1), 0)
        lo = 1 if interior else 0
        hi = lvl.D - 2 if interior else lvl.D - 1
        return (gz >= lo) & (gz <= hi)

    def _conv(self, x: Array, lvl: _SLevel3, d: Array) -> Array:
        e = _exchange_planes(x, self.nP)
        R, C = lvl.R, lvl.C
        acc = None
        for a, b, c, wt in lvl.terms:
            part = jnp.asarray(wt, x.dtype) * e[
                a : a + lvl.m, b : b + R, c : c + C
            ]
            acc = part if acc is None else acc + part
        out = jnp.zeros_like(x)
        out = out.at[:, 2:R, 2:C].set(acc[:, 1 : R - 1, 1 : C - 1])
        return jnp.where(self._plane_valid(lvl, d, True), out, 0.0)

    def _smooth(self, x, bb, lvl: _SLevel3, k: int, d, sweeps: int):
        od = jnp.asarray(self.omega * self._dinv(k), x.dtype)
        for _ in range(sweeps):
            x = x + od * (bb - self._conv(x, lvl, d))
        return x

    def _restrict(self, r: Array, lvl: _SLevel3, nxt: _SLevel3, d: Array) -> Array:
        e = _exchange_planes(r, self.nP)
        Rc, Cc = nxt.R, nxt.C
        out = None
        wts = ((-1, 0.5), (0, 1.0), (1, 0.5))
        for s, ws in wts:
            planes = e[1 + s :: 2][: nxt.m]
            for t, wt in wts:
                rows = planes[:, 1 + t :: 2][:, :Rc]
                for u, wu in wts:
                    part = (ws * wt * wu) * rows[:, :, 1 + u :: 2][:, :, :Cc]
                    out = part if out is None else out + part
        bc = jnp.zeros((nxt.m, Rc + 2, Cc + 2), r.dtype).at[
            :, 1 : 1 + Rc, 1 : 1 + Cc
        ].set(out)
        bc = bc.at[:, 1].set(0.0).at[:, Rc].set(0.0)
        bc = bc.at[:, :, 1].set(0.0).at[:, :, Cc].set(0.0)
        return jnp.where(self._plane_valid(nxt, d, True), bc, 0.0)

    def _prolong(self, ec: Array, lvl: _SLevel3, nxt: _SLevel3, d: Array) -> Array:
        e = _exchange_planes(ec, self.nP)
        Rc, Cc = nxt.R, nxt.C
        R, C = lvl.R, lvl.C
        E = e[:, 1 : 1 + Rc, 1 : 1 + Cc]  # (m_c+2, Rc, Cc), incl z ghosts
        # x then y interpolation (local), then z via the ghost planes
        H = 0.5 * (E[:, :, :-1] + E[:, :, 1:])
        body = jnp.stack([E[:, :, : Cc - 1], H], axis=3).reshape(
            E.shape[0], Rc, -1
        )
        W = jnp.concatenate([body, E[:, :, Cc - 1 :]], axis=2)  # (.., Rc, C)
        Hy = 0.5 * (W[:, :-1] + W[:, 1:])
        body = jnp.stack([W[:, : Rc - 1], Hy], axis=2).reshape(
            E.shape[0], -1, C
        )
        V = jnp.concatenate([body, W[:, Rc - 1 :]], axis=1)  # (.., R, C)
        A = V[1 : 1 + nxt.m]
        B = 0.5 * (A + V[2 : 2 + nxt.m])
        F = jnp.stack([A, B], axis=1).reshape(lvl.m, R, C)
        out = jnp.zeros((lvl.m, R + 2, C + 2), ec.dtype).at[
            :, 1 : 1 + R, 1 : 1 + C
        ].set(F)
        out = out.at[:, 1].set(0.0).at[:, R].set(0.0)
        out = out.at[:, :, 1].set(0.0).at[:, :, C].set(0.0)
        return jnp.where(self._plane_valid(lvl, d, True), out, 0.0)

    def _tail_solve(self, bb: Array, lvl: _SLevel3, d: Array) -> Array:
        allb = lax.all_gather(bb, AXIS)  # (nP, m, R+2, C+2)
        full = allb.reshape(self.nP * lvl.m, lvl.R + 2, lvl.C + 2)
        bp = jnp.zeros((lvl.D + 2, lvl.R + 2, lvl.C + 2), bb.dtype)
        bp = bp.at[1 : 1 + lvl.D].set(full[: lvl.D])
        if self.tail is not None:
            xp = self.tail._cycle(0, bp)
        else:
            v = jnp.matmul(
                self.coarse_inv.astype(bb.dtype),
                bp[2 : lvl.D, 2 : lvl.R, 2 : lvl.C].reshape(-1),
                precision=HIGHEST,
            )
            xp = jnp.zeros_like(bp).at[2 : lvl.D, 2 : lvl.R, 2 : lvl.C].set(
                v.reshape(lvl.D - 2, lvl.R - 2, lvl.C - 2)
            )
        xfull = jnp.zeros(
            (self.nP * lvl.m, lvl.R + 2, lvl.C + 2), bb.dtype
        )
        xfull = xfull.at[: lvl.D].set(xp[1 : 1 + lvl.D])
        return lax.dynamic_slice(
            xfull,
            (d * jnp.int32(lvl.m), jnp.int32(0), jnp.int32(0)),
            (lvl.m, lvl.R + 2, lvl.C + 2),
        )

    def _cycle(self, k: int, bb, d):
        lvl = self.levels[k]
        if k == len(self.levels) - 1:
            return self._tail_solve(bb, lvl, d)
        x = self._smooth(jnp.zeros_like(bb), bb, lvl, k, d, self.pre_smooth)
        r = bb - self._conv(x, lvl, d)
        nxt = self.levels[k + 1]
        bc = self._restrict(r, lvl, nxt, d)
        ec = self._cycle(k + 1, bc, d)
        x = x + self._prolong(ec, lvl, nxt, d)
        return self._smooth(x, bb, lvl, k, d, self.post_smooth)

    def cg(self, bb: Array, tol: float = 1e-10, maxiter: int = 40):
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
            return self._cycle(0, r.astype(self.dtype), d).astype(dt)

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


def build_sharded_lattice3_mg(
    nx: int,
    ny: int,
    nz: int,
    spacing: Tuple[float, float, float],
    mesh: Mesh,
    stiffness: float = 1.0,
    mass: float = 0.0,
    min_n: int = 8,
    replicate_planes: int = 8,
    dtype=jnp.float32,
    **kw,
) -> ShardedLattice3MG:
    """Plan the distributed 3D hierarchy over ``mesh`` (1D, axis 'shard'):
    z-plane slabs with even slab heights on distributed levels, replicated
    tail below ``replicate_planes``."""
    nP = mesh.shape[AXIS]
    hx, hy, hz = spacing
    grids = [(nx, ny, nz)]
    gx, gy, gz = nx, ny, nz
    while (
        gx % 2 == 0 and gy % 2 == 0 and gz % 2 == 0
        and min(gx, gy, gz) // 2 >= min_n
    ):
        gx, gy, gz = gx // 2, gy // 2, gz // 2
        grids.append((gx, gy, gz))
    n_dist = 1
    for k in range(1, len(grids)):
        m_would = -(-(grids[k][2] + 1) // nP)
        if m_would < replicate_planes:
            break
        n_dist = k + 1
    align = 2 ** (n_dist - 1)
    D0 = nz + 1
    m0 = -(-D0 // nP)
    m0 = -(-m0 // align) * align

    def terms_at(k):
        A8 = hex_element_matrix(
            hx * 2**k, hy * 2**k, hz * 2**k, stiffness=stiffness, mass=mass
        )
        return tuple(_terms3(vertex_stencil_weights3(A8)))

    levels = [
        _SLevel3(
            grids[k][2] + 1, grids[k][1] + 1, grids[k][0] + 1,
            m0 // (2**k), terms_at(k),
        )
        for k in range(n_dist)
    ]
    tail = None
    coarse_inv = None
    if n_dist < len(grids):
        gx, gy, gz = grids[n_dist - 1]
        sc = 2 ** (n_dist - 1)
        tail = build_lattice3_mg(
            gx, gy, gz, (hx * sc, hy * sc, hz * sc),
            stiffness=stiffness, mass=mass, min_n=min_n, dtype=dtype,
        )
    else:
        lvl = levels[-1]
        coarse_inv = jnp.asarray(
            _dense_coarse_inv3(lvl.terms, lvl.D, lvl.R, lvl.C), dtype
        )
    return ShardedLattice3MG(levels, tail, coarse_inv, nP, dtype=dtype, **kw)


def sharded_lattice3_solve(
    mg: ShardedLattice3MG,
    mesh: Mesh,
    b3d: Array,
    tol: float = 1e-10,
    maxiter: int = 40,
):
    """Distributed solve of the reduced 3D lattice system.  ``b3d``:
    global (D, R, C) logical RHS.  Returns (u3d, relres, iters); the whole
    MG-CG runs as ONE shard_map program."""
    lvl = mg.levels[0]
    D, R, C = lvl.D, lvl.R, lvl.C
    total = mg.nP * lvl.m
    b3d = b3d.at[0].set(0.0).at[-1].set(0.0)
    b3d = b3d.at[:, 0].set(0.0).at[:, -1].set(0.0)
    b3d = b3d.at[:, :, 0].set(0.0).at[:, :, -1].set(0.0)
    bp = jnp.zeros((total, R + 2, C + 2), b3d.dtype)
    bp = bp.at[:D, 1 : 1 + R, 1 : 1 + C].set(b3d)
    bp = jax.device_put(bp, NamedSharding(mesh, P(AXIS, None, None)))

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(AXIS, None, None),
        out_specs=(P(AXIS, None, None), P(), P()),
    )
    def run(bb):
        x, rel, it = mg.cg(bb, tol=tol, maxiter=maxiter)
        return x, rel, it

    x, rel, it = run(bp)
    return x[:D, 1 : 1 + R, 1 : 1 + C], float(rel), int(it)
