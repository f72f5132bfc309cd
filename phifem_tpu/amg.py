"""Smoothed-aggregation algebraic multigrid for unstructured phi-FEM bulks.

The structured backend's fast path rests on lattice-resident geometric MG
(:mod:`phifem_tpu.ops.lattice`); imported meshes (:class:`~phifem_tpu.umesh.UMesh`
/ :class:`~phifem_tpu.umesh3.UMesh3`) have no lattice, and until round 5 the
workhorse degree-1 unstructured solve had only Jacobi-BiCGStab (the
p-multigrid needs degree >= 2 — its coarse space IS degree 1).  This module
closes that gap the classical way: a smoothed-aggregation AMG hierarchy
(Vanek/Mandel/Brezina 1996) built ONCE on the host from the assembled
sparse operator, then applied entirely on device as ELL gather arithmetic —
the on-device replacement for the PETSc/MUMPS direct factorization every
reference demo uses (``demo/weak-dirichlet/flower/main.py:162-182``).

Design mirrors the lattice preconditioner's splitting: AMG cycles the BULK
rows (active DoFs untouched by any data-dependent batch — pure stiffness
rows), while the h^-3 cut-band penalty block is handled by the existing
multiplicative interface solve (:func:`phifem_tpu.mg.attach_interface_solve`)
— cut-row couplings would otherwise poison the aggregation strength graph
exactly as they diverged the lattice bulk cycle (CLAUDE.md round 2).

Host setup per level: strength-of-connection graph -> greedy MIS
aggregation -> tentative piecewise-constant P -> Jacobi-smoothed
P = (I - omega D^-1 A) T -> Galerkin RAP (scipy spgemm).  Device data per
level: the operator in ELL form, inverse diagonal, and P / P^T in ELL form;
the V-cycle is damped-Jacobi smoothing + gather/scatter transfers, all
fused by XLA.  Coarsest level: dense pseudo-inverse.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ops import HIGHEST

Array = jnp.ndarray

__all__ = ["build_amg", "AMG", "amg_preconditioner"]


def _csr_to_ell(A, pad_row: Optional[int] = None):
    """(cols, vals) ELL arrays of a scipy CSR matrix; padded column index
    is ``pad_row`` (default: n — callers append a zero slot)."""
    n = A.shape[0]
    pad = n if pad_row is None else pad_row
    nnz_row = np.diff(A.indptr)
    nnzmax = max(1, int(nnz_row.max()) if n else 1)
    cols = np.full((n, nnzmax), pad, np.int64)
    vals = np.zeros((n, nnzmax))
    rr = np.repeat(np.arange(n), nnz_row)
    oo = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz_row)
    cols[rr, oo] = A.indices
    vals[rr, oo] = A.data
    return cols, vals


def _aggregate(A, theta: float = 0.08) -> Tuple[np.ndarray, int]:
    """Greedy MIS aggregation on the strength graph
    ``|a_ij| >= theta * sqrt(|a_ii a_jj|)`` — the standard SA coarsening.
    Returns (aggregate id per node, number of aggregates)."""
    import scipy.sparse as sp

    n = A.shape[0]
    d = np.abs(A.diagonal())
    Ac = A.tocoo()
    off = Ac.row != Ac.col
    strong = off & (
        np.abs(Ac.data)
        >= theta * np.sqrt(np.maximum(d[Ac.row] * d[Ac.col], 1e-300))
    )
    S = sp.csr_matrix(
        (np.ones(int(strong.sum())), (Ac.row[strong], Ac.col[strong])),
        shape=(n, n),
    )
    indptr, indices = S.indptr, S.indices
    agg = np.full(n, -1, np.int64)
    na = 0
    # pass 1: roots whose strong neighbourhood is untouched become new
    # aggregates with all their neighbours
    for i in range(n):
        if agg[i] >= 0:
            continue
        nb = indices[indptr[i] : indptr[i + 1]]
        if nb.size and (agg[nb] >= 0).any():
            continue
        agg[i] = na
        agg[nb] = na
        na += 1
    # pass 2: attach leftovers to the aggregate of any strong neighbour
    for i in range(n):
        if agg[i] >= 0:
            continue
        nb = indices[indptr[i] : indptr[i + 1]]
        cand = nb[agg[nb] >= 0] if nb.size else nb
        if cand.size:
            agg[i] = agg[cand[0]]
    # pass 3: isolated nodes become singletons
    for i in range(n):
        if agg[i] < 0:
            agg[i] = na
            na += 1
    return agg, na


def _spectral_radius(A, Dinv, iters: int = 12) -> float:
    """Power-iteration estimate of rho(D^-1 A) (host, for the prolongator
    smoothing weight omega = 4/3 / rho)."""
    n = A.shape[0]
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v) + 1e-300
    lam = 1.0
    for _ in range(iters):
        w = Dinv * (A @ v)
        lam = np.linalg.norm(w)
        if lam < 1e-300:
            return 1.0
        v = w / lam
    return float(lam)


@dataclasses.dataclass
class _AMGLevel:
    n: int
    ecols: Array  # (n, nnz) ELL cols, pad -> n
    evals: Array  # (n, nnz)
    inv_diag: Array  # (n,)
    # transfers to the NEXT (coarser) level; None on the coarsest
    p_cols: Optional[Array] = None  # (n, pnnz) rows of P (fine gathers coarse)
    p_vals: Optional[Array] = None
    r_cols: Optional[Array] = None  # (nc, rnnz) rows of P^T
    r_vals: Optional[Array] = None


@dataclasses.dataclass
class AMG:
    """Device-resident SA-AMG V-cycle on a flat vector (one field's bulk
    block).  ``__call__(b) -> ~A^{-1} b`` in ``dtype``."""

    levels: List[_AMGLevel]
    coarse_inv: Array
    dtype: jnp.dtype = jnp.float32
    omega: float = 0.67
    pre_smooth: int = 1
    post_smooth: int = 1

    def _mv(self, lvl: _AMGLevel, x: Array) -> Array:
        xp = jnp.concatenate([x, jnp.zeros(1, x.dtype)])
        return (lvl.evals.astype(x.dtype) * xp[lvl.ecols]).sum(axis=1)

    def _ell_apply(self, cols, vals, x: Array, out_dtype) -> Array:
        xp = jnp.concatenate([x, jnp.zeros(1, x.dtype)])
        return (vals.astype(out_dtype) * xp[cols]).sum(axis=1)

    def _smooth(self, lvl: _AMGLevel, x, b, sweeps: int):
        om = jnp.asarray(self.omega, x.dtype)
        for _ in range(sweeps):
            x = x + om * lvl.inv_diag.astype(x.dtype) * (b - self._mv(lvl, x))
        return x

    def _cycle(self, k: int, b: Array) -> Array:
        lvl = self.levels[k]
        if k == len(self.levels) - 1:
            return jnp.matmul(
                self.coarse_inv.astype(b.dtype), b, precision=HIGHEST
            )
        x = self._smooth(lvl, jnp.zeros_like(b), b, self.pre_smooth)
        r = b - self._mv(lvl, x)
        rc = self._ell_apply(lvl.r_cols, lvl.r_vals, r, b.dtype)
        ec = self._cycle(k + 1, rc)
        x = x + self._ell_apply(lvl.p_cols, lvl.p_vals, ec, b.dtype)
        return self._smooth(lvl, x, b, self.post_smooth)

    def __call__(self, b: Array) -> Array:
        in_dt = b.dtype
        if in_dt != self.dtype:
            b = b.astype(self.dtype)
        return self._cycle(0, b).astype(in_dt)


def build_amg(
    A,
    dtype=jnp.float32,
    theta: float = 0.08,
    max_coarse: int = 400,
    max_levels: int = 12,
    omega_p: Optional[float] = None,
    **kw,
) -> AMG:
    """Build the SA-AMG hierarchy from a scipy sparse matrix (host) and
    return the device V-cycle."""
    import scipy.sparse as sp

    A = A.tocsr()
    levels: List[_AMGLevel] = []
    while True:
        n = A.shape[0]
        d = A.diagonal()
        dinv = np.where(np.abs(d) > 1e-300, 1.0 / np.where(d == 0, 1.0, d), 1.0)
        ecols, evals = _csr_to_ell(A)
        lvl = _AMGLevel(
            n,
            jnp.asarray(ecols, jnp.int32),
            jnp.asarray(evals, dtype),
            jnp.asarray(dinv, dtype),
        )
        levels.append(lvl)
        if n <= max_coarse or len(levels) >= max_levels:
            break
        agg, na = _aggregate(A, theta)
        if na >= n:  # no coarsening progress — stop
            break
        # tentative prolongator: piecewise constant over aggregates,
        # columns normalized (the near-null space of a Laplacian bulk is
        # the constant vector)
        cnt = np.bincount(agg, minlength=na).astype(np.float64)
        T = sp.csr_matrix(
            (1.0 / np.sqrt(cnt[agg]), (np.arange(n), agg)), shape=(n, na)
        )
        # Jacobi-smoothed prolongator (SA): P = (I - omega D^-1 A) T
        rho = _spectral_radius(A, dinv)
        om = (4.0 / 3.0) / max(rho, 1e-300) if omega_p is None else omega_p
        P = (T - sp.diags(om * dinv) @ (A @ T)).tocsr()
        pcols, pvals = _csr_to_ell(P, pad_row=na)
        R = P.T.tocsr()
        rcols, rvals = _csr_to_ell(R, pad_row=n)
        lvl.p_cols = jnp.asarray(pcols, jnp.int32)
        lvl.p_vals = jnp.asarray(pvals, dtype)
        lvl.r_cols = jnp.asarray(rcols, jnp.int32)
        lvl.r_vals = jnp.asarray(rvals, dtype)
        A = (R @ A @ P).tocsr()
        A.eliminate_zeros()
    Ad = np.asarray(A.todense())
    coarse_inv = np.linalg.pinv(Ad, rcond=1e-12)
    return AMG(levels, jnp.asarray(coarse_inv, dtype), dtype=dtype, **kw)


def amg_preconditioner(
    op,
    bcs=(),
    dtype=jnp.float32,
    theta: float = 0.08,
    interface: bool = True,
    **interface_kw,
):
    """Build the unstructured phi-FEM preconditioner: SA-AMG on each
    scalar field's bulk block + Jacobi on the rest + the multiplicative
    cut-band solve.  Plugs into ``solve(..., precond=...)`` exactly like
    ``SchemeBase.lattice_preconditioner``."""
    from .mg import (
        VCycle,
        Level,
        _masked_matvec,
        attach_interface_solve,
        data_dependent_selection,
    )
    from .solvers import masked_operator

    matvec, inv_diag, active = _masked_matvec(op, bcs, dtype)
    _, _, active_full = masked_operator(op, bcs)
    sel = data_dependent_selection(op, active_full)

    amgs: Dict[str, AMG] = {}
    bulk_masks: Dict[str, Array] = {}
    bulk_ids: Dict[str, Array] = {}
    for name, sp_ in op.system.fields.items():
        if sp_.value_size != 1:
            continue  # vector fields: Jacobi + band (scalar-only AMG)
        act = np.broadcast_to(
            np.asarray(active_full[name]), sp_.dof_shape
        ).reshape(-1)
        bulk = act & ~np.asarray(sel[name]).reshape(-1)
        if bulk.sum() < 32:
            continue
        sel_one = {
            f: (
                bulk.reshape(op.system.fields[f].dof_shape)
                if f == name
                else np.zeros(op.system.fields[f].dof_shape, bool)
            )
            for f in op.system.fields
        }
        A_bb, _ = op.restricted_csr(sel_one)
        amgs[name] = build_amg(A_bb, dtype=dtype, theta=theta)
        bulk_masks[name] = jnp.asarray(bulk.reshape(sp_.dof_shape[0]))
        bulk_ids[name] = jnp.asarray(np.where(bulk)[0], jnp.int32)

    class _AMGVCycle(VCycle):
        def _cycle(self, k, b):
            lvl = self.levels[0]
            out = {}
            for f, v in b.items():
                a = lvl.active[f]
                jac = self.omega * v * lvl.inv_diag[f]
                amg = amgs.get(f)
                if amg is None:
                    out[f] = jnp.where(a, jac, jnp.zeros_like(v))
                    continue
                rb = v.reshape(-1)[bulk_ids[f]]
                z = amg(rb)
                zf = (
                    jnp.zeros(v.reshape(-1).shape, v.dtype)
                    .at[bulk_ids[f]]
                    .set(z)
                    .reshape(v.shape)
                )
                out[f] = jnp.where(
                    bulk_masks[f], zf, jnp.where(a, jac, jnp.zeros_like(v))
                )
            return out

    lvl = Level(None, matvec, inv_diag, active)
    vc = _AMGVCycle([lvl], tuple(amgs), dtype=dtype)
    if interface:
        vc = attach_interface_solve(vc, op, active_full, **interface_kw)
    return vc
