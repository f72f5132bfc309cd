"""Linear solvers: matrix-free preconditioned Krylov + BC handling.

Replaces the PETSc KSP ``preonly`` + MUMPS LU stack of every reference demo
(``demo/weak-dirichlet/flower/main.py:162-182`` and equivalents), including
the MUMPS null-pivot configuration (icntl 24=1/25=0) the reference needs
because box-mode operators are singular on the exterior of Omega_h.  Here
the singular exterior is handled matrix-free: DoFs with a zero diagonal
(touched by no active term) get identity rows and a unit preconditioner
entry, so Krylov iterations leave them at zero — no factorization anywhere.

Solvers operate on pytrees (dicts of per-field DoF arrays), are jittable
end-to-end, and use a Jacobi (inverse-diagonal) preconditioner extracted
from the assembled element matrices.  phi-FEM operators with boundary flux
terms are nonsymmetric, so the default is BiCGStab; CG is available for SPD
cases.  A dense LU fallback supports small problems and tests.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .assembly import Operator, System
from .ops import HIGHEST

Array = jnp.ndarray

__all__ = ["DirichletBC", "masked_operator", "solve", "solve_ir", "SolveResult"]


def _float_dtype():
    from jax import config

    return jnp.float64 if config.jax_enable_x64 else jnp.float32


def tree_dot(a, b) -> Array:
    leaves = jax.tree.map(lambda x, y: jnp.vdot(x, y, precision=HIGHEST), a, b)
    return jax.tree.reduce(jnp.add, leaves)


def tree_dot32(a, b) -> Array:
    """Krylov recurrence dot: float32 products/reduction, cast back to the
    input dtype (whether that still pays on a device with float64
    hardware is ROADMAP C3); alpha/beta only need
    ~1e-6 relative accuracy (inexact-coefficient Krylov behaves like the
    flexible variant — the full-precision vector recurrences keep the
    residual itself accurate)."""
    dt = jax.tree.leaves(a)[0].dtype
    if dt == jnp.float32:
        return tree_dot(a, b)
    leaves = jax.tree.map(
        lambda x, y: jnp.vdot(
            x.astype(jnp.float32), y.astype(jnp.float32), precision=HIGHEST
        ),
        a,
        b,
    )
    return jax.tree.reduce(jnp.add, leaves).astype(dt)


def tree_axpy(alpha, x, y):
    return jax.tree.map(lambda xi, yi: alpha * xi + yi, x, y)


@dataclasses.dataclass(frozen=True)
class DirichletBC:
    """Strong Dirichlet condition on one field: boolean mask over scalar
    DoFs (optionally per-component) + prescribed values.

    Replaces ``dfx.fem.dirichletbc`` + ``apply_lifting`` + ``bc.set``
    (reference ``demo/interface-elasticity/main.py:165-177, 274-277``).
    """

    field: str
    mask: Array  # bool, shape = space.dof_shape (broadcastable)
    values: Array  # same shape as the field's dof array


def _apply_masks(x: Dict[str, Array], bcs, zero: bool) -> Dict[str, Array]:
    out = dict(x)
    for bc in bcs:
        out[bc.field] = jnp.where(
            bc.mask, jnp.zeros_like(out[bc.field]) if zero else bc.values, out[bc.field]
        )
    return out


def masked_operator(
    op: Operator,
    bcs: Tuple[DirichletBC, ...] = (),
    dyn: Optional[Tuple] = None,
) -> Tuple[Callable, Dict[str, Array], Dict[str, Array]]:
    """Wrap an operator with Dirichlet-BC row/column masking and
    exterior-DoF identity rows.

    Returns ``(matvec, diag, active)`` where ``matvec`` acts as the reduced
    operator A_red (identity on constrained/inactive DoFs), ``diag`` is its
    Jacobi diagonal, and ``active`` masks genuinely active DoFs.

    ``dyn = (W, mats_tuple)`` optionally supplies the tap weight buffer and
    the dynamic batches' matrices as TRACED values (in
    ``op.dynamic_batch_ids()`` order) so a jitted consumer keeps working
    after ``reassemble`` without retracing.
    """
    W = mats_tuple = None
    if dyn is not None:
        W, mats_tuple = dyn
    overrides = (
        dict(zip(op.dynamic_batch_ids(), mats_tuple))
        if mats_tuple is not None
        else None
    )
    diag = op.diagonal(overrides)
    active = jax.tree.map(lambda d: d != 0.0, diag)
    for bc in bcs:
        active[bc.field] = jnp.logical_and(
            active[bc.field], jnp.logical_not(bc.mask)
        )

    # tap-form fast path (ops.taps): shifted-slice lattice arithmetic
    # instead of gather -> batched matmul -> scatter per entity batch
    lat = op.lattice_form()
    if lat is not None:
        base_mv = lat.make_matvec(op, W=W)
    elif overrides is not None:

        def base_mv(x):
            y = op.system.zeros()
            for i, b in enumerate(op.batches):
                if i in overrides:
                    y = b.matvec_into(x, y, mats=overrides[i])
                else:
                    y = b.matvec_into(x, y)
            return y

    else:
        base_mv = op.matvec

    def matvec(x):
        xa = jax.tree.map(lambda xi, m: jnp.where(m, xi, 0.0), x, active)
        y = base_mv(xa)
        # identity on inactive/constrained dofs
        return jax.tree.map(
            lambda yi, xi, m: jnp.where(m, yi, xi), y, x, active
        )

    matvec.raw = base_mv  # unmasked operator (BC lifting needs it)
    diag_red = jax.tree.map(lambda d, m: jnp.where(m, d, 1.0), diag, active)
    return matvec, diag_red, active


def lift_rhs(
    op: Operator,
    b: Dict[str, Array],
    bcs: Tuple[DirichletBC, ...],
    active,
    raw_matvec: Optional[Callable] = None,
) -> Dict[str, Array]:
    """Apply Dirichlet lifting: b <- b - A g on active DoFs, b|_bc = g,
    b|_inactive = 0 (reference ``apply_lifting`` + ``bc.set``).

    ``raw_matvec`` optionally supplies the (possibly value-parametric)
    unmasked operator application; defaults to ``op.matvec``."""
    if bcs:
        g = {
            n: jnp.zeros_like(v) for n, v in b.items()
        }
        g = _apply_masks(g, bcs, zero=False)
        Ag = (raw_matvec or op.matvec)(g)
        b = jax.tree.map(lambda bi, ai: bi - ai, b, Ag)
        b = _apply_masks(b, bcs, zero=False)
    b = jax.tree.map(lambda bi, m: jnp.where(m, bi, 0.0), b, active)
    for bc in bcs:
        b[bc.field] = jnp.where(bc.mask, bc.values, b[bc.field])
    return b


class SolveResult:
    """Solution + solver statistics (the PETSc ``KSPGetResidualNorm`` /
    ``KSPGetIterationNumber`` analogue the reference reads from its KSP).

    With ``solve(..., sync=False)`` the packed (relres, iters) stats stay
    on device and cross to the host on first ``residual``/``iterations``/
    ``converged`` access — or packed with other pending fetches via
    :func:`phifem_tpu.utils.fetch_all`, so a warm tag+assemble+solve
    iteration costs ONE host round trip total."""

    __slots__ = ("x", "_residual", "_iterations", "_converged", "_stats", "_tol")

    def __init__(
        self,
        x: Dict[str, Array],
        residual: float = None,
        iterations: int = None,
        converged: bool = None,
        _stats=None,
        _tol: float = None,
    ):
        self.x = x
        self._residual = residual
        self._iterations = iterations
        self._converged = converged
        self._stats = _stats  # device (2,) [relres, iters], or None
        self._tol = _tol

    def __repr__(self) -> str:
        if self._stats is not None:
            return "SolveResult(stats deferred; access .residual to sync)"
        return (
            f"SolveResult(residual={self._residual}, "
            f"iterations={self._iterations}, converged={self._converged})"
        )

    def _pending(self):
        return self._stats

    def _absorb(self, stats) -> None:
        if self._stats is None:
            return
        stats = np.asarray(stats)
        self._stats = None
        self._residual = float(stats[0])
        self._iterations = int(stats[1])
        self._converged = self._residual <= 10 * self._tol

    def _sync(self) -> None:
        if self._stats is not None:
            self._absorb(jax.device_get(self._stats))

    @property
    def residual(self) -> float:
        self._sync()
        return self._residual

    @property
    def iterations(self) -> int:
        self._sync()
        return self._iterations

    @property
    def converged(self) -> bool:
        self._sync()
        return self._converged


def _pcg(matvec, b, x0, *, tol, atol, maxiter, M, dot=None):
    """Preconditioned CG on pytrees as one ``lax.while_loop`` with an
    iteration counter (the PETSc ``KSPGetIterationNumber`` analogue the
    reference reads implicitly from its KSP solves).

    ``dot`` overrides the inner product (default ``tree_dot32``) — the
    partitioned SPMD path passes a ``lax.psum``-reducing one so the
    recurrence runs on device-local blocks inside ``shard_map``."""
    dot = tree_dot32 if dot is None else dot
    bnorm2 = dot(b, b)
    target2 = jnp.maximum(tol * tol * bnorm2, jnp.asarray(atol) ** 2)

    r0 = jax.tree.map(lambda bi, ai: bi - ai, b, matvec(x0))
    z0 = M(r0)
    state = (x0, r0, z0, z0, dot(r0, z0), jnp.asarray(0, jnp.int32))

    def cond(st):
        x, r, p, z, rz, it = st
        return jnp.logical_and(dot(r, r) > target2, it < maxiter)

    def body(st):
        x, r, p, z, rz, it = st
        Ap = matvec(p)
        alpha = rz / dot(p, Ap)
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, Ap, r)
        z = M(r)
        rz_new = dot(r, z)
        p = tree_axpy(rz_new / rz, p, z)
        return x, r, p, z, rz_new, it + 1

    x, r, p, z, rz, it = jax.lax.while_loop(cond, body, state)
    return x, it


def _bicgstab_init(matvec, b, x0, dot):
    """Initial BiCGStab state tuple (shared by the on-chip while_loop
    runner and the host-driven stepper)."""
    r0 = jax.tree.map(lambda bi, ai: bi - ai, b, matvec(x0))
    zeros = jax.tree.map(jnp.zeros_like, b)
    one = jnp.asarray(1.0, jax.tree.leaves(b)[0].dtype)
    rr0 = dot(r0, r0)
    return (
        x0, r0, r0, zeros, zeros, one, one, one,
        jnp.asarray(0, jnp.int32), x0, rr0,
    )


def _bicgstab_half_a(matvec, M, dot, st):
    """First half of one BiCGStab iteration (through the p-direction
    preconditioned matvec): contains exactly one M and one A application.
    Split out so the host-driven runner can compile each half as its own
    program — the half-graphs bound the largest compiled unit."""
    x, r, rhat, p, v, rho, alpha, omega, it, xb, rrb = st
    rho_new = dot(rhat, r)
    rr_cur = dot(r, r)
    rhat2 = dot(rhat, rhat)
    restart = jnp.abs(rho_new) < 1e-12 * jnp.sqrt(rr_cur * rhat2)
    rhat = jax.tree.map(
        lambda hi, ri: jnp.where(restart, ri, hi), rhat, r
    )
    rho_new = jnp.where(restart, rr_cur, rho_new)
    beta = jnp.where(
        jnp.logical_or(it == 0, restart),
        0.0,
        (rho_new / rho) * (alpha / omega),
    )
    p = jax.tree.map(
        lambda ri, pi, vi: ri + beta * (pi - omega * vi), r, p, v
    )
    phat = M(p)
    v = matvec(phat)
    alpha = rho_new / dot(rhat, v)
    s = tree_axpy(-alpha, v, r)
    return (x, r, rhat, p, v, rho_new, alpha, omega, it, xb, rrb, phat, s)


def _bicgstab_half_b(matvec, M, dot, mid):
    """Second half: the s-direction preconditioned matvec, the omega
    update, and the best-iterate tracking (see :func:`_bicgstab_half_a`)."""
    x, r, rhat, p, v, rho, alpha, omega, it, xb, rrb, phat, s = mid
    shat = M(s)
    t = matvec(shat)
    omega = dot(t, s) / dot(t, t)
    x = jax.tree.map(
        lambda xi, ph, sh: xi + alpha * ph + omega * sh, x, phat, shat
    )
    r = tree_axpy(-omega, t, s)
    rr = dot(r, r)
    better = jnp.logical_and(jnp.isfinite(rr), rr < rrb)
    xb = jax.tree.map(
        lambda xi, xbi: jnp.where(better, xi, xbi), x, xb
    )
    rrb = jnp.where(better, rr, rrb)
    return x, r, rhat, p, v, rho, alpha, omega, it + 1, xb, rrb


def _bicgstab_body(matvec, M, dot, st):
    """ONE BiCGStab iteration on the state tuple (classical recurrence,
    right-preconditioned form).  A rho breakdown (loss of rhat
    orthogonality after stagnation — observed on the preconditioned S5-3D
    system around 1e-8 relative) RESTARTS the recurrence with rhat = r
    instead of wandering; the BEST iterate seen is tracked so a late
    breakdown cannot destroy a near-converged solve."""
    return _bicgstab_half_b(
        matvec, M, dot, _bicgstab_half_a(matvec, M, dot, st)
    )


def _pbicgstab(matvec, b, x0, *, tol, atol, maxiter, M, dot=None):
    """Preconditioned BiCGStab on pytrees: one ``lax.while_loop``, counted.

    Exits on the true-residual norm test, omega breakdown (NaNs propagate
    to a non-finite residual, which also stops the loop), or runaway
    divergence (residual 1e8x past its best); returns the best iterate
    (see :func:`_bicgstab_body`).

    ``dot`` as in :func:`_pcg`: overridable inner product for SPMD use."""
    dot = tree_dot32 if dot is None else dot
    bnorm2 = dot(b, b)
    target2 = jnp.maximum(tol * tol * bnorm2, jnp.asarray(atol) ** 2)
    state = _bicgstab_init(matvec, b, x0, dot)

    def cond(st):
        x, r, rhat, p, v, rho, alpha, omega, it, xb, rrb = st
        rr = dot(r, r)
        ok = jnp.logical_and(jnp.isfinite(rr), rr < 1e16 * (rrb + 1e-300))
        return jnp.logical_and(jnp.logical_and(rr > target2, it < maxiter), ok)

    def body(st):
        return _bicgstab_body(matvec, M, dot, st)

    _, r, _, _, _, _, _, _, it, xb, rrb = jax.lax.while_loop(
        cond, body, state
    )
    return xb, it


def _pfgmres(matvec, b, x0, *, tol, atol, maxiter, M, restart=20):
    """Restarted FLEXIBLE GMRES on pytrees (one ``lax.while_loop`` over
    restart cycles, statically-shaped Arnoldi inside).

    The flexible variant (Saad 1993; PETSc ``KSPFGMRES``) stores the
    preconditioned basis Z separately, so M may change between
    applications — required when M itself contains an inner ITERATIVE
    solve that exits on a sweep cap (e.g. the cut-block band Krylov of the
    S5-3D preconditioner): such an M is nonlinear in its input and floors
    classical BiCGStab at the inner inconsistency level (measured ~1e-8),
    while FGMRES converges through it.  Memory: (2*restart+1) basis
    vectors."""
    leaves, treedef = jax.tree.flatten(b)
    sizes = [int(np.prod(l.shape)) for l in leaves]
    shapes = [l.shape for l in leaves]

    def fl(t):
        return jnp.concatenate(
            [x.reshape(-1) for x in jax.tree.leaves(t)]
        )

    def unfl(v):
        out, o = [], 0
        for s, sh in zip(sizes, shapes):
            out.append(v[o : o + s].reshape(sh))
            o += s
        return jax.tree.unflatten(treedef, out)

    A = lambda v: fl(matvec(unfl(v)))
    Mf = lambda v: fl(M(unfl(v)))
    bf = fl(b)
    x0f = fl(x0)
    n = bf.shape[0]
    m = int(restart)
    dt = bf.dtype
    bnorm = jnp.linalg.norm(bf)
    target = jnp.maximum(tol * bnorm, jnp.asarray(atol, dt))
    kidx = jnp.arange(m + 1)

    def arnoldi(j, carry):
        V, Z, H = carry
        z = Mf(V[j])
        w = A(z)
        mask = (kidx <= j).astype(dt)
        h = (V @ w) * mask  # MGS, two passes for orthogonality
        w = w - V.T @ h
        h2 = (V @ w) * mask
        w = w - V.T @ h2
        h = h + h2
        hj = jnp.linalg.norm(w)
        V = V.at[j + 1].set(w / jnp.maximum(hj, 1e-300))
        H = H.at[:, j].set(h + hj * (kidx == j + 1).astype(dt))
        Z = Z.at[j].set(z)
        return V, Z, H

    def cycle(state):
        x, it, _ = state
        r = bf - A(x)
        beta = jnp.linalg.norm(r)
        V0 = jnp.zeros((m + 1, n), dt).at[0].set(
            r / jnp.maximum(beta, 1e-300)
        )
        Z0 = jnp.zeros((m, n), dt)
        H0 = jnp.zeros((m + 1, m), dt)
        V, Z, H = jax.lax.fori_loop(0, m, arnoldi, (V0, Z0, H0))
        e1 = jnp.zeros(m + 1, dt).at[0].set(beta)
        y = jnp.linalg.lstsq(H, e1)[0]
        x = x + Z.T @ y
        rest = jnp.linalg.norm(e1 - H @ y)
        return x, it + m, rest

    def cond(state):
        x, it, rnorm = state
        ok = jnp.isfinite(rnorm)
        return jnp.logical_and(
            jnp.logical_and(rnorm > target, it < maxiter), ok
        )

    r0n = jnp.linalg.norm(bf - A(x0f))
    x, it, _ = jax.lax.while_loop(
        cond, cycle, (x0f, jnp.asarray(0, jnp.int32), r0n)
    )
    return unfl(x), it


def _hoist_precond(precond, b):
    """Trace ``precond`` once and hoist its captured device tables (MG
    level stencils/masks, interface band matrices, dense block inverses)
    out of the closure into runtime arguments: closed-over arrays are
    embedded in the lowered HLO as literal constants, which at production
    sizes makes the module tens of MB and duplicates the tables in every
    executable.  (jax.closure_convert is
    NOT the tool: it only hoists closed-over *tracers*; concrete arrays
    stay embedded.)  Returns ``(pfun(r, consts), consts)`` or
    ``(None, [])``."""
    if precond is None:
        return None, []
    ex = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), b)
    closed, out_shape = jax.make_jaxpr(
        lambda r: precond(r), return_shape=True
    )(ex)
    p_out_tree = jax.tree.structure(out_shape)
    _p_jaxpr, pconsts = closed.jaxpr, list(closed.consts)

    def _pfun(r, consts):
        out = jax.core.eval_jaxpr(_p_jaxpr, consts, *jax.tree.leaves(r))
        return jax.tree.unflatten(p_out_tree, out)

    return _pfun, pconsts


def _eq_context(op, bcs, dyn, defl, pfun, pdyn):
    """The equilibrated (and optionally deflated) system every Krylov
    path solves — shared by the fused on-chip runner in :func:`solve` and
    the host-driven stepper in :func:`_host_bicgstab`.

    Returns ``(matvec, active, dsqrt, dinv_sqrt, mv_eq, M, proj)`` where
    ``mv_eq``/``M`` act on the symmetric-diagonally-equilibrated system
    (phi-FEM penalty rows scale like h^-3 against O(1) stiffness rows;
    solving D^-1/2 A D^-1/2 compresses that range) and ``proj`` projects
    off the deflated null basis (or is ``None``)."""
    matvec, diag, active = masked_operator(op, bcs, dyn=dyn)
    dsqrt = jax.tree.map(
        lambda d: jnp.sqrt(jnp.where(jnp.abs(d) > 1e-30, jnp.abs(d), 1.0)),
        diag,
    )
    dinv_sqrt = jax.tree.map(lambda d: 1.0 / d, dsqrt)

    def mv_eq(y):
        xs = jax.tree.map(lambda yi, di: yi * di, y, dinv_sqrt)
        z = matvec(xs)
        return jax.tree.map(lambda zi, di: zi * di, z, dinv_sqrt)

    if pfun is not None:
        # wrap a preconditioner P ~ A^-1 of the unscaled system:
        # M = D^1/2 P D^1/2 ~ (D^-1/2 A D^-1/2)^-1
        papply = lambda r: pfun(r, pdyn)
        M = lambda r: jax.tree.map(
            lambda vi, di: vi * di,
            papply(jax.tree.map(lambda ri, di: ri * di, r, dsqrt)),
            dsqrt,
        )
    else:
        M = lambda r: r  # scaled system has unit diagonal

    proj = None
    if defl:
        # equilibrated null basis: null(D^-1/2 A D^-1/2) = D^1/2 v;
        # masked to active DoFs, then Gram-Schmidt (full precision —
        # the projection accuracy caps achievable convergence)
        ortho = []
        for v in defl:
            q = jax.tree.map(
                lambda vi, m, di: jnp.where(m, vi, 0.0) * di,
                v, active, dsqrt,
            )
            for o in ortho:
                q = tree_axpy(-tree_dot(o, q), o, q)
            nrm = jnp.sqrt(tree_dot(q, q))
            q = jax.tree.map(lambda qi: qi / jnp.maximum(nrm, 1e-300), q)
            ortho.append(q)

        # The projections run on STACKED flat vectors: per application,
        # tree-mapped per-mode dots cost (num_modes x num_fields) separate
        # full-length f64 REDUCTIONS — ~150 per Krylov iteration for S5's
        # 3 modes x 5 fields x ~10 projection applications — and f64
        # reductions, each a separate pass.  Two (k, n) matmuls per
        # projection keep full precision at a fraction of the passes.
        names_d = sorted(defl[0])
        shapes_d = [defl[0][k].shape for k in names_d]
        sizes_d = [int(np.prod(sh)) for sh in shapes_d]

        def _fl(t):
            return jnp.concatenate([t[k].reshape(-1) for k in names_d])

        def _unfl(vf):
            out, cur = {}, 0
            for k, sh, sz in zip(names_d, shapes_d, sizes_d):
                out[k] = vf[cur : cur + sz].reshape(sh)
                cur += sz
            return out

        Qm = jnp.stack([_fl(o) for o in ortho])  # (k, n_flat)

        def proj(v):
            vf = _fl(v)
            return _unfl(vf - Qm.T @ (Qm @ vf))

        mv_plain, M_plain = mv_eq, M

        def mv_eq(y):
            yf = _fl(y)
            c = Qm @ yf
            z = proj(mv_plain(_unfl(yf - Qm.T @ c)))
            # identity on the deflated span
            return _unfl(_fl(z) + Qm.T @ c)

        M = lambda r: proj(M_plain(proj(r)))
    return matvec, active, dsqrt, dinv_sqrt, mv_eq, M, proj


def solve(
    op: Operator,
    b: Dict[str, Array],
    bcs: Tuple[DirichletBC, ...] = (),
    method: str = "bicgstab",
    tol: float = 1e-10,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    x0: Optional[Dict[str, Array]] = None,
    precond: Optional[Callable] = None,
    deflate: Optional[Tuple[Dict[str, Array], ...]] = None,
    sync: bool = True,
    host_loop: bool = False,
    check_every: int = 10,
) -> SolveResult:
    """Solve ``A x = b`` with preconditioned Krylov iterations (or direct
    factorizations: ``method="dense"`` — lstsq with null-pivot handling,
    small systems — and ``method="sparse"`` — cached SuperLU on the host,
    the reference's MUMPS-LU analogue for mid-size/unstructured/high-degree
    systems).

    ``precond`` overrides the default Jacobi preconditioner (e.g. a
    :class:`phifem_tpu.mg.VCycle`).

    ``deflate`` optionally supplies pytree vectors spanning a KNOWN null
    space of the reduced operator (e.g. the collective rigid-body modes of
    the S5 interface-elasticity system, whose singularity the reference
    hands to MUMPS icntl 24/25 — ``demo/interface-elasticity/main.py:251-254``).
    The Krylov iteration then runs on the deflated operator P A P + Q Q^T
    (P the orthogonal projector off the null basis), which is the iterative
    analogue of the null-pivot LU: the returned solution has zero component
    along the null basis, and the reported residual is the deflated one
    (the raw residual stalls at the RHS's inconsistency level — a
    discretization-consistency term, not a solver failure).

    ``sync=False`` defers the (residual, iterations) stats fetch so it can
    be packed with other host round trips via
    :func:`phifem_tpu.utils.fetch_all` — Krylov methods only.  The direct
    paths (``method="dense"``/``"sparse"``) factor on the host and return
    eagerly-materialized results; ``sync`` is a no-op there."""
    if method in ("dense", "sparse"):
        matvec, diag, active = masked_operator(op, bcs)
        b = lift_rhs(op, b, bcs, active)
        if method == "dense":
            return _dense_solve(op, b, bcs, active)
        return _sparse_solve(op, b, bcs, active, deflate)

    if maxiter is None:
        maxiter = 25 * int(np.sqrt(op.system.num_dofs)) + 1000
    if method not in ("cg", "bicgstab", "gmres", "fgmres"):
        raise ValueError(f"Unknown method {method!r}.")

    if host_loop:
        if method != "bicgstab":
            raise ValueError("host_loop supports method='bicgstab' only")
        return _host_bicgstab(
            op, b, bcs, tol=tol, atol=atol, maxiter=maxiter, x0=x0,
            precond=precond, deflate=deflate, sync=sync,
            check_every=check_every,
        )

    # build (and refresh) the tap form OUTSIDE the trace — host work
    lat = op.lattice_form()
    # the data-dependent values enter the compiled runner as ARGUMENTS, so
    # reassemble() (same structure, new values) reuses the compiled solve
    dyn_args = (
        None if lat is None else lat.W,
        tuple(op.batches[i].matrices for i in op.dynamic_batch_ids()),
    )

    # The ENTIRE solve — diagonal extraction, BC masking, Dirichlet lift,
    # equilibration, the Krylov while_loop, the final residual and the
    # change of variables back — is ONE jitted program, memoized on the
    # operator: anything eager out here would cost a dispatch per op.
    # Key on BC identities (the
    # closure bakes in their masks/values; closures keep the bc objects
    # alive so ids are stable) and on the preconditioner's identity +
    # mutation version (attach_interface_solve bumps _version when it
    # equips an already-built V-cycle).
    cache_key = (
        method,
        float(tol),
        float(atol),
        int(maxiter),
        id(precond),
        getattr(precond, "_version", 0),
        tuple(id(bc) for bc in bcs),
        len(deflate) if deflate else 0,
    )
    cache = getattr(op, "_solve_cache", None)
    if cache is None:
        cache = op._solve_cache = {}
    cached = cache.get(cache_key)
    if cached is None:
        # hoist the preconditioner's device tables into jit arguments —
        # see _hoist_precond
        _pfun, pconsts = _hoist_precond(precond, b)

        @jax.jit
        def _run(b, x0, dyn, defl, pdyn):
            # x0/dyn/pdyn are ARGUMENTS (jax.jit retraces per structure),
            # not closures — callers may pass x0 or not, dyn carries the
            # data-dependent weights/matrices across reassembles, and pdyn
            # carries the preconditioner's hoisted tables
            matvec, active, dsqrt, dinv_sqrt, mv_eq, M, _proj = _eq_context(
                op, bcs, dyn, defl, _pfun, pdyn
            )
            b_l = lift_rhs(op, b, bcs, active, raw_matvec=matvec.raw)
            b_eq = jax.tree.map(lambda bi, di: bi * di, b_l, dinv_sqrt)
            ortho = _proj is not None
            if ortho:
                b_eq = _proj(b_eq)

            x0_eq = (
                jax.tree.map(jnp.zeros_like, b_eq)
                if x0 is None
                else jax.tree.map(lambda xi, di: xi * di, x0, dsqrt)
            )
            if ortho and x0 is not None:
                x0_eq = _proj(x0_eq)
            if method == "gmres":
                x, _ = jax.scipy.sparse.linalg.gmres(
                    mv_eq, b_eq, x0=x0_eq, tol=tol, atol=atol, maxiter=maxiter,
                    M=M, restart=50, solve_method="batched",
                )
                it = jnp.asarray(-1, jnp.int32)  # gmres: count unavailable
            elif method == "fgmres":
                x, it = _pfgmres(
                    mv_eq, b_eq, x0_eq, tol=tol, atol=atol, maxiter=maxiter, M=M
                )
            else:
                runner = _pcg if method == "cg" else _pbicgstab
                x, it = runner(
                    mv_eq, b_eq, x0_eq, tol=tol, atol=atol, maxiter=maxiter, M=M
                )
            r = jax.tree.map(lambda bi, ai: bi - ai, b_eq, mv_eq(x))
            rnorm = jnp.sqrt(tree_dot(r, r))
            bnorm = jnp.sqrt(tree_dot(b_eq, b_eq))
            if ortho:
                x = _proj(x)  # zero-null-component gauge (MUMPS icntl 25=0)
            # undo the equilibration change of variables: x = D^-1/2 y
            x = jax.tree.map(lambda yi, di: yi * di, x, dinv_sqrt)
            # pack (relres, iters) so ONE value fetch syncs the whole solve
            return x, jnp.stack(
                [rnorm / jnp.maximum(bnorm, 1e-300), it.astype(rnorm.dtype)]
            )

        cached = cache[cache_key] = (_run, pconsts)

    _run, pconsts = cached
    x, stats = _run(b, x0, dyn_args, deflate, pconsts)
    res = SolveResult(x=x, _stats=stats, _tol=tol)
    if sync:
        res._sync()  # one packed (relres, iters) value fetch
    return res


def _host_bicgstab(
    op: Operator,
    b: Dict[str, Array],
    bcs: Tuple[DirichletBC, ...] = (),
    *,
    tol: float,
    atol: float,
    maxiter: int,
    x0,
    precond,
    deflate,
    sync: bool,
    check_every: int = 10,
) -> SolveResult:
    """HOST-DRIVEN preconditioned BiCGStab: the same iteration as
    :func:`_pbicgstab`, but the Krylov loop runs in Python over THREE
    small jitted programs (prep / one-iteration step / finish) instead of
    one fused ``lax.while_loop`` graph.

    Purpose: compiled-surface control.  Splitting the while_loop off the
    fused S5 solve graph (outer BiCGStab x [block-lattice-MG + rank-k
    coarse + inner band Krylov] preconditioner) leaves the per-iteration
    body as the largest compiled unit.  Runtime cost: step dispatches are
    ASYNC (they queue on device); the only host syncs are one convergence
    fetch per ``check_every`` iterations.  Whether the fused loop is
    faster is ROADMAP C2.  Semantics match ``solve(method="bicgstab")``:
    same equilibration, deflation, best-iterate return, and packed
    (relres, iters) stats."""
    lat = op.lattice_form()
    dyn_args = (
        None if lat is None else lat.W,
        tuple(op.batches[i].matrices for i in op.dynamic_batch_ids()),
    )
    cache_key = (
        "host-bicgstab",
        float(tol),
        float(atol),
        id(precond),
        getattr(precond, "_version", 0),
        tuple(id(bc) for bc in bcs),
        len(deflate) if deflate else 0,
    )
    cache = getattr(op, "_solve_cache", None)
    if cache is None:
        cache = op._solve_cache = {}
    cached = cache.get(cache_key)
    if cached is None:
        _pfun, pconsts = _hoist_precond(precond, b)

        @jax.jit
        def _prep(b, x0, dyn, defl, pdyn):
            matvec, active, dsqrt, dinv_sqrt, mv_eq, M, _proj = _eq_context(
                op, bcs, dyn, defl, _pfun, pdyn
            )
            b_l = lift_rhs(op, b, bcs, active, raw_matvec=matvec.raw)
            b_eq = jax.tree.map(lambda bi, di: bi * di, b_l, dinv_sqrt)
            if _proj is not None:
                b_eq = _proj(b_eq)
            x0_eq = (
                jax.tree.map(jnp.zeros_like, b_eq)
                if x0 is None
                else jax.tree.map(lambda xi, di: xi * di, x0, dsqrt)
            )
            if _proj is not None and x0 is not None:
                x0_eq = _proj(x0_eq)
            st = _bicgstab_init(mv_eq, b_eq, x0_eq, tree_dot32)
            bnorm2 = tree_dot32(b_eq, b_eq)
            target2 = jnp.maximum(tol * tol * bnorm2, jnp.asarray(atol) ** 2)
            return st, b_eq, target2

        split = os.environ.get("PHIFEM_HOST_SPLIT") == "1"

        if split:
            # two half-iteration programs (one M + one A each): the
            # smallest compiled units
            @jax.jit
            def _step_a(st, dyn, defl, pdyn):
                _, _, _, _, mv_eq, M, _ = _eq_context(
                    op, bcs, dyn, defl, _pfun, pdyn
                )
                return _bicgstab_half_a(mv_eq, M, tree_dot32, st)

            @jax.jit
            def _step_b(mid, dyn, defl, pdyn):
                _, _, _, _, mv_eq, M, _ = _eq_context(
                    op, bcs, dyn, defl, _pfun, pdyn
                )
                return _bicgstab_half_b(mv_eq, M, tree_dot32, mid)

            def _step(st, dyn, defl, pdyn):
                return _step_b(_step_a(st, dyn, defl, pdyn), dyn, defl, pdyn)

        else:

            @jax.jit
            def _step(st, dyn, defl, pdyn):
                _, _, _, _, mv_eq, M, _ = _eq_context(
                    op, bcs, dyn, defl, _pfun, pdyn
                )
                return _bicgstab_body(mv_eq, M, tree_dot32, st)

        @jax.jit
        def _chk(st, target2):
            rr = tree_dot32(st[1], st[1])
            rrb = st[10]
            diverged = jnp.logical_not(
                jnp.logical_and(jnp.isfinite(rr), rr < 1e16 * (rrb + 1e-300))
            )
            done = jnp.logical_or(rr <= target2, diverged)
            return jnp.stack([done.astype(rr.dtype), rr])

        @jax.jit
        def _fin(st, b_eq, dyn, defl, pdyn):
            _, _, _, dinv_sqrt, mv_eq, _, _proj = _eq_context(
                op, bcs, dyn, defl, _pfun, pdyn
            )
            xb, it = st[9], st[8]
            r = jax.tree.map(lambda bi, ai: bi - ai, b_eq, mv_eq(xb))
            rnorm = jnp.sqrt(tree_dot(r, r))
            bnorm = jnp.sqrt(tree_dot(b_eq, b_eq))
            x = _proj(xb) if _proj is not None else xb
            x = jax.tree.map(lambda yi, di: yi * di, x, dinv_sqrt)
            return x, jnp.stack(
                [rnorm / jnp.maximum(bnorm, 1e-300), it.astype(rnorm.dtype)]
            )

        cached = cache[cache_key] = (_prep, _step, _chk, _fin, pconsts)

    _prep, _step, _chk, _fin, pconsts = cached
    st, b_eq, target2 = _prep(b, x0, dyn_args, deflate, pconsts)
    it = 0
    while it < maxiter:
        k = min(check_every, maxiter - it)
        for _ in range(k):  # async dispatches; no host sync inside
            st = _step(st, dyn_args, deflate, pconsts)
        it += k
        flags = np.asarray(_chk(st, target2))  # ONE fetch per window
        if flags[0] != 0.0:
            break
    x, stats = _fin(st, b_eq, dyn_args, deflate, pconsts)
    res = SolveResult(x=x, _stats=stats, _tol=tol)
    if sync:
        res._sync()
    return res


def solve_ir(
    op: Operator,
    b: Dict[str, Array],
    bcs: Tuple[DirichletBC, ...] = (),
    precond: Optional[Callable] = None,
    method: str = "cg",
    tol: float = 1e-10,
    inner_tol: float = 1e-6,
    inner_maxiter: int = 100,
    max_outer: int = 6,
    inner_dtype=jnp.float32,
) -> SolveResult:
    """Mixed-precision iterative refinement: float32 Krylov corrections
    inside a full-precision residual loop.

    Running the whole Krylov solve in f64 doubles the memory traffic of
    every vector.  Classical iterative refinement gets f64-grade
    residuals (the reference's MUMPS solves in f64,
    ``demo/weak-dirichlet/flower/main.py:162-182``) at f32 bandwidth:

        r_k = b - A x_k            (full precision, 1 matvec per round)
        solve A e ~= r_k           (f32 equilibrated CG/BiCGStab + precond)
        x_{k+1} = x_k + e

    Each round multiplies the residual by ``max(inner_tol, O(kappa(A) *
    eps_f32))`` — the f32 matvec's rounding alone injects a relative error
    ~kappa*eps32 per correction, which no inner accuracy can beat.  For 2D
    Poisson kappa ~ h^-2, so IR is the right tool up to ~1M DoFs (kappa
    1e6 -> ~0.1x/round worst case, usually far better); beyond that prefer
    full-precision CG with an f32 V-cycle *preconditioner* (``solve`` with
    ``precond=VCycle(dtype=f32)``), which converges at MG rate independent
    of kappa and stalls only at the f64 floor eps64*kappa.  ``precond``
    here should be an f32-compute preconditioner (e.g. ``VCycle(dtype=
    f32)``).
    """
    from .mg import _masked_matvec

    matvec_f, diag, active = masked_operator(op, bcs)
    b = lift_rhs(op, b, bcs, active)
    out_dtype = jax.tree.leaves(b)[0].dtype

    matvec_i, _, _ = _masked_matvec(op, bcs, inner_dtype)

    # symmetric diagonal equilibration of the inner system (see solve())
    dsqrt = jax.tree.map(
        lambda d: jnp.sqrt(jnp.where(jnp.abs(d) > 1e-30, jnp.abs(d), 1.0)), diag
    )
    dsqrt_i = jax.tree.map(lambda d: d.astype(inner_dtype), dsqrt)
    dinv_i = jax.tree.map(lambda d: 1.0 / d, dsqrt_i)

    def matvec_eq(y):
        xs = jax.tree.map(jnp.multiply, y, dinv_i)
        return jax.tree.map(jnp.multiply, matvec_i(xs), dinv_i)

    if precond is not None:
        M = lambda r: jax.tree.map(
            jnp.multiply,
            precond(jax.tree.map(jnp.multiply, r, dsqrt_i)),
            dsqrt_i,
        )
    else:
        M = lambda r: r

    solvers = {
        "cg": jax.scipy.sparse.linalg.cg,
        "bicgstab": jax.scipy.sparse.linalg.bicgstab,
    }

    cache_key = (
        "ir",
        method,
        float(inner_tol),
        int(inner_maxiter),
        str(inner_dtype),
        id(precond),
        getattr(precond, "_version", 0),
        tuple(id(bc) for bc in bcs),
    )
    cache = getattr(op, "_solve_cache", None)
    if cache is None:
        cache = op._solve_cache = {}
    runners = cache.get(cache_key)
    if runners is None:

        @jax.jit
        def _resid(x, b):
            r = jax.tree.map(lambda bi, ai: bi - ai, b, matvec_f(x))
            rel = jnp.sqrt(tree_dot(r, r)) / jnp.maximum(
                jnp.sqrt(tree_dot(b, b)), 1e-300
            )
            return r, rel

        @jax.jit
        def _correct(x, r):
            rs = jax.tree.map(
                lambda ri, di: ri.astype(inner_dtype) * di, r, dinv_i
            )
            es, _ = solvers[method](
                matvec_eq, rs, tol=inner_tol, atol=0.0, maxiter=inner_maxiter, M=M
            )
            return jax.tree.map(
                lambda xi, ei, di: xi + (ei * di).astype(out_dtype),
                x,
                es,
                dinv_i,
            )

        runners = cache[cache_key] = (_resid, _correct)
    _resid, _correct = runners

    x = jax.tree.map(jnp.zeros_like, b)
    r, rel = _resid(x, b)
    rel = float(rel)
    it = 0
    while rel > tol and it < max_outer:
        x = _correct(x, r)
        r, rel = _resid(x, b)
        rel = float(rel)
        it += 1
    return SolveResult(x=x, residual=rel, iterations=it, converged=rel <= tol)


def _sparse_solve(op: Operator, b, bcs, active, deflate=None) -> SolveResult:
    """Host sparse direct LU (SuperLU) of the reduced system — the
    reference's PETSc/MUMPS-LU analogue (``demo/weak-dirichlet/flower/
    main.py:45``: every reference solve is LU) at scales where the dense
    ``lstsq`` path's O(n^2) memory is prohibitive.  O(nnz) assembly via the
    operator's COO triplets, identity on inactive/BC rows.  The
    factorization is cached on the operator (keyed by data version + BC
    identities) so repeated RHS solves re-use it — the production pattern
    of the reference's convergence loops.

    ``deflate`` (pytree vectors spanning a KNOWN exact null space, e.g.
    S5's collective rigid modes) switches to the BORDERED system

        [A  Q] [x]     [b]
        [Q'  0] [lam] = [0]

    — the sparse-direct analogue of MUMPS null-pivot handling (icntl
    24/25, ``demo/interface-elasticity/main.py:251-254``): x is the
    zero-null-gauge solution (Q' x = 0) and Q lam absorbs the RHS's
    inconsistent component; the reported residual is the DEFLATED one,
    matching the deflated-Krylov path's semantics."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu

    n = op.system.num_dofs
    off = op.system.offsets()
    act = np.zeros(n, bool)
    bv = np.zeros(n)
    for name, s in op.system.fields.items():
        sl = slice(off[name], off[name] + s.num_dofs)
        act[sl] = np.broadcast_to(
            np.asarray(active[name]), s.dof_shape
        ).reshape(-1)
        bv[sl] = np.asarray(b[name]).reshape(-1)

    Q = None
    if deflate:
        Q = np.zeros((n, len(deflate)))
        for j, m in enumerate(deflate):
            for name, s in op.system.fields.items():
                sl = slice(off[name], off[name] + s.num_dofs)
                Q[sl, j] = np.asarray(m[name]).reshape(-1)
        Q[~act] = 0.0
        Q, _ = np.linalg.qr(Q)

    key = (op.data_version, tuple(id(bc) for bc in bcs), len(deflate or ()))
    cached = getattr(op, "_splu_cache", None)
    if cached is None or cached[0] != key:
        sel = {
            name: np.ones(s.dof_shape, bool)
            for name, s in op.system.fields.items()
        }
        A, _ = op.restricted_csr(sel)
        A = A.tocoo()
        keep = act[A.row] & act[A.col]
        # factor the ACTIVE submatrix only: bg-mode mixed systems carry
        # huge identity blocks (flux/auxiliary fields live only on the
        # cut band, u fields on their regions) whose rows would bloat
        # SuperLU's int32 workspace past overflow at million-DoF scale —
        # inactive rows are x = b, no factorization needed.
        idx = np.where(act)[0]
        ren = np.full(n, -1, np.int64)
        ren[idx] = np.arange(len(idx))
        na = len(idx)
        Ared = sp.csc_matrix(
            (A.data[keep], (ren[A.row[keep]], ren[A.col[keep]])),
            shape=(na, na),
        )
        Afac = Ared
        if Q is not None:
            Qa = sp.csc_matrix(Q[idx])
            Afac = sp.bmat([[Ared, Qa], [Qa.T, None]], format="csc")
        try:
            lu = splu(Afac)
        except (RuntimeError, MemoryError):
            # COLAMD fill-in can overflow SuperLU's int32 workspace on
            # million-DoF mixed systems (SUPERLU_MALLOC failure with RAM
            # to spare).  MMD on the symmetrized pattern gives the
            # classic low-fill FEM ordering — retry with it.
            lu = splu(
                Afac,
                permc_spec="MMD_AT_PLUS_A",
                options={"SymmetricMode": True},
            )
        # keep the bc objects referenced so the id()-based key stays unique
        cached = op._splu_cache = (key, lu, Ared, idx, tuple(bcs))
    _, lu, Ared, idx = cached[:4]

    ba = bv[idx]
    xv = bv.copy()  # inactive identity rows: x = b
    if Q is None:
        xa = lu.solve(ba)
        r = np.linalg.norm(Ared @ xa - ba) / max(np.linalg.norm(ba), 1e-300)
    else:
        Qa = Q[idx]  # orthonormal: Q has no mass on inactive rows
        xa = lu.solve(np.concatenate([ba, np.zeros(Qa.shape[1])]))[: len(idx)]
        rv = ba - Ared @ xa
        rv -= Qa @ (Qa.T @ rv)  # deflated residual (Krylov-path semantics)
        bd = ba - Qa @ (Qa.T @ ba)
        r = np.linalg.norm(rv) / max(np.linalg.norm(bd), 1e-300)
    xv[idx] = xa
    x = {}
    for name, s in op.system.fields.items():
        sl = slice(off[name], off[name] + s.num_dofs)
        x[name] = jnp.asarray(xv[sl].reshape(s.dof_shape))
    return SolveResult(x=x, residual=float(r), iterations=1, converged=True)


def _dense_solve(op: Operator, b, bcs, active) -> SolveResult:
    A = op.to_dense()
    off = op.system.offsets()
    n = op.system.num_dofs
    act = np.zeros(n, bool)
    bv = np.zeros(n)
    for name, s in op.system.fields.items():
        sl = slice(off[name], off[name] + s.num_dofs)
        act[sl] = np.broadcast_to(
            np.asarray(active[name]), s.dof_shape
        ).reshape(-1)
        bv[sl] = np.asarray(b[name]).reshape(-1)
    A[~act, :] = 0.0
    A[:, ~act] = 0.0
    A[~act, ~act] = 1.0
    # least-squares = minimum-norm on any numerically-null pivots, the
    # analogue of the reference's MUMPS icntl 24/25 null-pivot handling
    xv, *_ = np.linalg.lstsq(A, bv, rcond=None)
    x = {}
    for name, s in op.system.fields.items():
        sl = slice(off[name], off[name] + s.num_dofs)
        x[name] = jnp.asarray(xv[sl].reshape(s.dof_shape))
    r = np.linalg.norm(A @ xv - bv) / max(np.linalg.norm(bv), 1e-300)
    return SolveResult(x=x, residual=float(r), iterations=1, converged=True)
