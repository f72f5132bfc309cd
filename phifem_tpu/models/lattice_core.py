"""Shared machinery for the hand-built 3D lattice schemes.

The 3D schemes (:mod:`weak_dirichlet3`, :mod:`neumann3`) bypass the
generic 2D assembly layer: their operators are masked uniform stencils +
static per-orientation face matrices + batched cut-cell blocks.  This
module holds the pieces every such scheme needs:

* :func:`equilibrated_solve` — the compiled symmetric-diagonal-
  equilibrated Krylov runner (the 3D analogue of ``solvers.solve``'s
  jitted path; penalty rows scale ``h^-3``-class, so equilibration is
  mandatory, see CLAUDE.md);
* :func:`hex_quadrature` / :func:`face_quadrature` — trilinear basis
  tables on the reference hex and its axis-aligned faces;
* :func:`cell_dofs_of` — closed-form (ne, 8) vertex gather lists.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..solvers import SolveResult, _pbicgstab, _pcg, _pfgmres

Array = jnp.ndarray

HEX_OFFS = tuple(
    (dx, dy, dz) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)
)


def float_dtype():
    from jax import config

    return jnp.float64 if config.jax_enable_x64 else jnp.float32


def gauss01(n: int):
    """n-point Gauss nodes/weights on [0, 1] (weights sum to 1)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def hex_shape(xi: np.ndarray):
    """Trilinear values (8,) and reference gradients (8, 3) at xi in
    [0,1]^3 (node order = HEX_OFFS)."""
    vals = np.empty(8)
    grads = np.empty((8, 3))
    for i, (dx, dy, dz) in enumerate(HEX_OFFS):
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


def hex_quadrature(npd: int):
    """(nq,) weights, (nq, 8) values, (nq, 8, 3) ref gradients of the
    npd^3 tensor Gauss rule on [0,1]^3."""
    g, w = gauss01(npd)
    W, V, G = [], [], []
    for gz, wz in zip(g, w):
        for gy, wy in zip(g, w):
            for gx, wx in zip(g, w):
                vals, grads = hex_shape(np.array([gx, gy, gz]))
                W.append(wx * wy * wz)
                V.append(vals)
                G.append(grads)
    return np.asarray(W), np.asarray(V), np.asarray(G)


def hex_quadrature_points(npd: int) -> np.ndarray:
    """(nq, 3) reference coordinates (x, y, z in [0,1]) of the npd^3
    tensor Gauss rule, ordered to match :func:`hex_quadrature`."""
    g, _ = gauss01(npd)
    P = []
    for gz in g:
        for gy in g:
            for gx in g:
                P.append((gx, gy, gz))
    return np.asarray(P)


def face_quadrature(ax_lat: int, at_upper: bool, npd: int = 2):
    """Quadrature on the hex face normal to lattice axis ``ax_lat``
    (0=z, 1=y, 2=x): (nq,) weights, (nq, 8) values, (nq, 8, 3) ref
    gradients, and the physical coordinate index the face is normal to."""
    k_phys = {0: 2, 1: 1, 2: 0}[ax_lat]
    g, w = gauss01(npd)
    W, V, G = [], [], []
    for ga, wa in zip(g, w):
        for gb, wb in zip(g, w):
            xi = np.empty(3)
            xi[k_phys] = 1.0 if at_upper else 0.0
            t = [i for i in range(3) if i != k_phys]
            xi[t[0]], xi[t[1]] = ga, gb
            vals, grads = hex_shape(xi)
            W.append(wa * wb)
            V.append(vals)
            G.append(grads)
    return np.asarray(W), np.asarray(V), np.asarray(G), k_phys


def face_quadrature_points(ax_lat: int, at_upper: bool, npd: int = 2):
    """(nqf, 3) reference coordinates of the face rule, ordered to match
    :func:`face_quadrature`."""
    k_phys = {0: 2, 1: 1, 2: 0}[ax_lat]
    g, _ = gauss01(npd)
    P = []
    for ga in g:
        for gb in g:
            xi = np.empty(3)
            xi[k_phys] = 1.0 if at_upper else 0.0
            t = [i for i in range(3) if i != k_phys]
            xi[t[0]], xi[t[1]] = ga, gb
            P.append(xi.copy())
    return np.asarray(P)


def cell_dofs_of(lattice_shape: Tuple[int, int, int], cells: np.ndarray):
    """(ne, 8) int flat vertex ids of hex cells given as (ne, 3)
    (iz, iy, ix) — node order = HEX_OFFS."""
    D, R, C = lattice_shape
    out = np.empty((cells.shape[0], 8), np.int64)
    for i, (dx, dy, dz) in enumerate(HEX_OFFS):
        out[:, i] = (
            (cells[:, 0] + dz) * R + cells[:, 1] + dy
        ) * C + cells[:, 2] + dx
    return out


def hex_offsets(degree: int):
    """Local node offsets of the Q_degree tensor-Lagrange hex: tuples
    (ox, oy, oz) in {0..degree}^3, x fastest — reduces to :data:`HEX_OFFS`
    at degree 1."""
    r = range(degree + 1)
    return tuple((ox, oy, oz) for oz in r for oy in r for ox in r)


def lagrange1d_coeffs(degree: int) -> np.ndarray:
    """(degree+1, degree+1) ascending poly coefficients of the 1D Lagrange
    basis at equispaced nodes k/degree on [0, 1] (row i = L_i)."""
    nodes = np.arange(degree + 1) / max(degree, 1)
    V = np.vander(nodes, degree + 1, increasing=True)
    return np.linalg.inv(V).T


def hexd_shape(xi: np.ndarray, degree: int):
    """Values (nloc,), gradients (nloc, 3) and PURE second derivatives
    (nloc, 3) (d2/dx_k^2 — enough for the Laplacian; mixed seconds are not
    needed) of the Q_degree basis at xi in [0,1]^3, node order
    :func:`hex_offsets`."""
    C = lagrange1d_coeffs(degree)

    def ev(t):
        vals = np.array([np.polyval(C[i][::-1], t) for i in range(degree + 1)])
        d1 = np.array(
            [np.polyval(np.polyder(C[i][::-1]), t) for i in range(degree + 1)]
        )
        if degree >= 2:
            d2 = np.array(
                [
                    np.polyval(np.polyder(C[i][::-1], 2), t)
                    for i in range(degree + 1)
                ]
            )
        else:
            d2 = np.zeros(degree + 1)
        return vals, d1, d2

    fx, dfx, ddx = ev(xi[0])
    fy, dfy, ddy = ev(xi[1])
    fz, dfz, ddz = ev(xi[2])
    offs = hex_offsets(degree)
    nloc = len(offs)
    vals = np.empty(nloc)
    grads = np.empty((nloc, 3))
    sec = np.empty((nloc, 3))
    for i, (ox, oy, oz) in enumerate(offs):
        vals[i] = fx[ox] * fy[oy] * fz[oz]
        grads[i] = (
            dfx[ox] * fy[oy] * fz[oz],
            fx[ox] * dfy[oy] * fz[oz],
            fx[ox] * fy[oy] * dfz[oz],
        )
        sec[i] = (
            ddx[ox] * fy[oy] * fz[oz],
            fx[ox] * ddy[oy] * fz[oz],
            fx[ox] * fy[oy] * ddz[oz],
        )
    return vals, grads, sec


def hexd_quadrature(npd: int, degree: int):
    """npd^3 tensor Gauss rule tabulated on the Q_degree hex basis:
    (nq,) weights, (nq, nloc) values, (nq, nloc, 3) ref gradients,
    (nq, nloc, 3) pure ref second derivatives."""
    g, w = gauss01(npd)
    W, V, G, S = [], [], [], []
    for gz, wz in zip(g, w):
        for gy, wy in zip(g, w):
            for gx, wx in zip(g, w):
                vals, grads, sec = hexd_shape(np.array([gx, gy, gz]), degree)
                W.append(wx * wy * wz)
                V.append(vals)
                G.append(grads)
                S.append(sec)
    return np.asarray(W), np.asarray(V), np.asarray(G), np.asarray(S)


def faced_quadrature(ax_lat: int, at_upper: bool, npd: int, degree: int):
    """Q_degree version of :func:`face_quadrature`: quadrature on the hex
    face normal to lattice axis ``ax_lat`` (0=z, 1=y, 2=x) — (nq,) weights,
    (nq, nloc) values, (nq, nloc, 3) ref gradients, normal coord index."""
    k_phys = {0: 2, 1: 1, 2: 0}[ax_lat]
    g, w = gauss01(npd)
    W, V, G = [], [], []
    for ga, wa in zip(g, w):
        for gb, wb in zip(g, w):
            xi = np.empty(3)
            xi[k_phys] = 1.0 if at_upper else 0.0
            t = [i for i in range(3) if i != k_phys]
            xi[t[0]], xi[t[1]] = ga, gb
            vals, grads, _ = hexd_shape(xi, degree)
            W.append(wa * wb)
            V.append(vals)
            G.append(grads)
    return np.asarray(W), np.asarray(V), np.asarray(G), k_phys


def cell_nodes_of(
    node_shape: Tuple[int, int, int], cells: np.ndarray, degree: int
):
    """(ne, (degree+1)^3) int flat NODE ids of hex cells (ne, 3) =
    (iz, iy, ix) on the degree-refined node lattice
    ``(degree*nz+1, degree*ny+1, degree*nx+1)`` — reduces to
    :func:`cell_dofs_of` at degree 1."""
    _, Rn, Cn = node_shape
    offs = hex_offsets(degree)
    out = np.empty((cells.shape[0], len(offs)), np.int64)
    for i, (ox, oy, oz) in enumerate(offs):
        out[:, i] = (
            (degree * cells[:, 0] + oz) * Rn + degree * cells[:, 1] + oy
        ) * Cn + degree * cells[:, 2] + ox
    return out


def lattice_l2_h1_errors_d(
    grid,
    region_mask: np.ndarray,
    u_nodes: Array,
    exact: Callable,
    degree: int,
    npd: Optional[int] = None,
) -> Dict[str, float]:
    """Relative L2/H10 errors of a degree-d lattice field vs a callable —
    the Q_degree generalization of :func:`lattice_l2_h1_errors` (dense
    masked cellwise Gauss sums; per-node strided slices instead of corner
    slices)."""
    dt = float_dtype()
    hx, hy, hz = grid.spacing
    d = degree
    npd = npd if npd is not None else d + 1
    W, V, G, _ = hexd_quadrature(npd, d)
    Pq = hex_quadrature_points(npd)
    offs = hex_offsets(d)
    mask = jnp.asarray(region_mask.astype(np.float64), dt)
    nz, ny, nx = mask.shape
    (x0_, y0_, z0_), _b = grid.bbox
    z0 = z0_ + hz * jnp.arange(nz, dtype=dt)[:, None, None]
    y0 = y0_ + hy * jnp.arange(ny, dtype=dt)[None, :, None]
    x0 = x0_ + hx * jnp.arange(nx, dtype=dt)[None, None, :]
    x0 = jnp.broadcast_to(x0, (nz, ny, nx))
    y0 = jnp.broadcast_to(y0, (nz, ny, nx))
    z0 = jnp.broadcast_to(z0, (nz, ny, nx))
    nodes = [
        u_nodes[
            oz : oz + d * nz : d, oy : oy + d * ny : d, ox : ox + d * nx : d
        ]
        for (ox, oy, oz) in offs
    ]
    num_l2 = den_l2 = num_h1 = den_h1 = jnp.asarray(0.0, dt)
    for q in range(W.shape[0]):
        wq3 = float(W[q])
        Nq = jnp.asarray(V[q], dt)
        Gd = jnp.asarray(G[q], dt) / np.array([hx, hy, hz])[None, :]
        uq = sum(Nq[i] * nodes[i] for i in range(len(offs)))
        px = x0 + float(Pq[q, 0]) * hx
        py = y0 + float(Pq[q, 1]) * hy
        pz = z0 + float(Pq[q, 2]) * hz
        pe = jnp.stack([px, py, pz], axis=-1)
        ue = exact(pe)
        ge = jax.vmap(
            jax.vmap(jax.vmap(jax.grad(lambda p: exact(p[None])[0])))
        )(pe)
        num_l2 += wq3 * jnp.sum(mask * (uq - ue) ** 2)
        den_l2 += wq3 * jnp.sum(mask * ue**2)
        for k in range(3):
            gk = sum(Gd[i, k] * nodes[i] for i in range(len(offs)))
            num_h1 += wq3 * jnp.sum(mask * (gk - ge[..., k]) ** 2)
            den_h1 += wq3 * jnp.sum(mask * ge[..., k] ** 2)
    return {
        "l2": float(jnp.sqrt(num_l2 / den_l2)),
        "h10": float(jnp.sqrt(num_h1 / den_h1)),
    }


def make_equilibrated_runner(
    matvec: Callable[[Dict[str, Array]], Dict[str, Array]],
    diag: Dict[str, Array],
    active: Dict[str, Array],
    method: str = "bicgstab",
    tol: float = 1e-10,
    maxiter: int = 4000,
    precond: Optional[Callable] = None,
    deflate: Optional[tuple] = None,
):
    """Compile ``run(b) -> (x, [rel_residual, iterations])``: symmetric
    diagonal equilibration, identity on inactive DoFs, one packed stats
    fetch (solvers.solve's discipline on pytree lattice operators).

    ``deflate`` optionally supplies pytree vectors spanning a (near-)null
    space; the iteration then runs on the projected operator
    ``P A P + Q Q^T`` exactly like :func:`phifem_tpu.solvers.solve`'s
    ``deflate`` (the iterative analogue of MUMPS null-pivot handling)."""

    def _tdot(a, b):
        return sum(
            jnp.vdot(x, y).real
            for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
        )

    def _taxpy(alpha, x, y):
        return jax.tree.map(lambda xi, yi: alpha * xi + yi, x, y)

    @jax.jit
    def run(b):
        dsqrt = jax.tree.map(lambda d: jnp.sqrt(jnp.abs(d)), diag)
        dinv = jax.tree.map(lambda d: 1.0 / d, dsqrt)

        def mv(y):
            xs = jax.tree.map(
                lambda yi, di, m: jnp.where(m, yi * di, 0.0), y, dinv, active
            )
            z = matvec(xs)
            return jax.tree.map(
                lambda zi, di, yi, m: jnp.where(m, zi * di, yi),
                z, dinv, y, active,
            )

        b_eq = jax.tree.map(
            lambda bi, di, m: jnp.where(m, bi * di, 0.0), b, dinv, active
        )
        if precond is not None:
            M = lambda r: jax.tree.map(
                lambda vi, di: vi * di,
                precond(jax.tree.map(lambda ri, di: ri * di, r, dsqrt)),
                dsqrt,
            )
        else:
            M = lambda r: r

        ortho = []
        if deflate:
            # null(D^-1/2 A D^-1/2) = D^1/2 v, masked to active DoFs,
            # Gram-Schmidt orthonormalized (solvers.solve:370-386)
            for v in deflate:
                q = jax.tree.map(
                    lambda vi, m, di: jnp.where(m, vi, 0.0) * di,
                    v, active, dsqrt,
                )
                for o in ortho:
                    q = _taxpy(-_tdot(o, q), o, q)
                nrm = jnp.sqrt(_tdot(q, q))
                q = jax.tree.map(lambda qi: qi / jnp.maximum(nrm, 1e-300), q)
                ortho.append(q)

            def _proj(v):
                for o in ortho:
                    v = _taxpy(-_tdot(o, v), o, v)
                return v

            mv_plain, M_plain = mv, M

            def mv(y):
                z = _proj(mv_plain(_proj(y)))
                for o in ortho:  # identity on the deflated span
                    z = _taxpy(_tdot(o, y), o, z)
                return z

            M = lambda r: _proj(M_plain(_proj(r)))
            b_eq = _proj(b_eq)

        x0 = jax.tree.map(jnp.zeros_like, b_eq)
        if method == "cg":
            runner = _pcg
        elif method == "fgmres":
            runner = _pfgmres
        else:
            runner = _pbicgstab
        x, it = runner(mv, b_eq, x0, tol=tol, atol=0.0, maxiter=maxiter, M=M)
        r = jax.tree.map(lambda bi, ai: bi - ai, b_eq, mv(x))
        rn = jnp.sqrt(sum(jnp.vdot(v, v).real for v in jax.tree.leaves(r)))
        bn = jnp.sqrt(sum(jnp.vdot(v, v).real for v in jax.tree.leaves(b_eq)))
        if ortho:
            for o in ortho:  # zero-null-component gauge
                x = _taxpy(-_tdot(o, x), o, x)
        x = jax.tree.map(lambda yi, di: yi * di, x, dinv)
        return x, jnp.stack(
            [rn / jnp.maximum(bn, 1e-300), it.astype(rn.dtype)]
        )

    return run


def cached_equilibrated_solve(
    scheme,
    method: str,
    tol: float,
    maxiter: int,
    precond: Optional[Callable],
    deflate: Optional[tuple] = None,
) -> Tuple[Dict[str, Array], float, int]:
    """Memoized compiled solve on a scheme exposing ``matvec``/``diag``/
    ``active``/``b`` — returns (x, rel_residual, iterations)."""
    key = (
        method, float(tol), int(maxiter), id(precond),
        len(deflate) if deflate else 0, id(deflate),
    )
    cache = getattr(scheme, "_solve_cache", None)
    if cache is None:
        cache = scheme._solve_cache = {}
    run = cache.get(key)
    if run is None:
        run = cache[key] = make_equilibrated_runner(
            scheme.matvec, scheme.diag, scheme.active,
            method=method, tol=tol, maxiter=maxiter, precond=precond,
            deflate=deflate,
        )
    x, stats = run(scheme.b)
    stats = np.asarray(stats)
    return x, float(stats[0]), int(stats[1])


def build_interface_block(
    blocks, total: int, selectable: np.ndarray
):
    """Assemble the sparse data-dependent DoF block of a lattice scheme.

    ``blocks``: iterable of ``(row_dofs (ne, r), col_dofs (ne, c), mats
    (ne, r, c) or (r, c))`` in GLOBAL flat ids; ``selectable`` (total,)
    bool marks active DoFs eligible for the block.  Returns
    ``(ids, A_csr, entity_blocks)``: the selected global ids, the CSR
    matrix restricted to them, and per-entity overlapping index lists in
    compact index space (for RAS).  The generic version of
    ``WeakDirichletPoisson3._interface_csr`` (nonsymmetric rectangular
    couplings allowed — e.g. S3-3D's one-sided u<-y_k flux blocks)."""
    import scipy.sparse as sp

    sel = np.zeros(total, bool)
    rows_l, cols_l, vals_l, entity_dofs = [], [], [], []
    for row_dofs, col_dofs, mats in blocks:
        row_dofs = np.asarray(row_dofs)
        col_dofs = np.asarray(col_dofs)
        ne, r = row_dofs.shape
        c = col_dofs.shape[1]
        m = np.broadcast_to(np.asarray(mats), (ne, r, c))
        rows_l.append(np.broadcast_to(row_dofs[:, :, None], m.shape))
        cols_l.append(np.broadcast_to(col_dofs[:, None, :], m.shape))
        vals_l.append(m)
        sel[row_dofs.reshape(-1)] = True
        sel[col_dofs.reshape(-1)] = True
        entity_dofs.extend(
            np.concatenate([row_dofs, col_dofs], axis=1)
        )
    sel &= selectable

    ids = np.where(sel)[0]
    m_sel = ids.shape[0]
    idx_of = -np.ones(total, np.int64)
    idx_of[ids] = np.arange(m_sel)
    r = np.concatenate([v.reshape(-1) for v in rows_l])
    c = np.concatenate([v.reshape(-1) for v in cols_l])
    v = np.concatenate([v.reshape(-1) for v in vals_l])
    rl, cl = idx_of[r], idx_of[c]
    keep = (rl >= 0) & (cl >= 0)
    A = sp.coo_matrix(
        (v[keep], (rl[keep], cl[keep])), shape=(m_sel, m_sel)
    ).tocsr()
    ras = []
    for d in entity_dofs:
        bl = idx_of[d]
        bl = np.unique(bl[bl >= 0])
        if bl.size:
            ras.append(bl)
    return ids, A, ras


def lattice_sparse_solve(blocks, b_concat: np.ndarray, active: np.ndarray):
    """Host SuperLU direct solve of a lattice scheme's active-restricted
    system — the 3D analogue of :func:`phifem_tpu.solvers._sparse_solve`
    (the reference solves everything with PETSc LU/MUMPS,
    `demo/weak-dirichlet/flower/main.py:45`).  ``blocks`` are the FULL
    operator's entity batches in global flat ids (same format as
    :func:`build_interface_block`); inactive DoFs get x = 0 (the identity-
    row convention of :func:`make_equilibrated_runner`).  No null-pivot
    handling — exactly singular systems stay on deflated Krylov."""
    from scipy.sparse.linalg import splu

    total = active.shape[0]
    ids, A, _ = build_interface_block(blocks, total, active)
    x = np.zeros(total)
    x[ids] = splu(A.tocsc()).solve(b_concat[ids])
    return x


def make_interface_apply(
    ids, A_csr, ras_blocks, dense_max=4000, sweeps=None,
    inner="krylov", inner_omega=1.0,
):
    """Compile the interface-block correction ``corr = A_II^{-1} rf[ids]``:
    a dense inverse for small blocks, else an inner solve on the
    device-resident ELL band matrix with RAS block preconditioning (the
    generic version of the solve inside
    ``WeakDirichletPoisson3.lattice_preconditioner``).

    ``inner="krylov"`` (default) runs inner BiCGStab — fastest per sweep
    but NONLINEAR in the right-hand side when it exits on the sweep cap
    instead of its tolerance, which floors an outer classical BiCGStab at
    the inner inconsistency level.  ``inner="richardson"`` runs ``sweeps``
    damped RAS-Richardson iterations — a LINEAR fixed operator, safe under
    any outer Krylov."""
    m = ids.shape[0]
    ids_j = jnp.asarray(ids)
    if m <= dense_max:
        Ad = np.asarray(A_csr.todense())
        inv_j = jnp.asarray(np.linalg.inv(Ad))

        def apply(rf):
            return ids_j, inv_j.astype(rf.dtype) @ rf[ids_j]

        return apply

    K = max(bl.size for bl in ras_blocks)
    nb = len(ras_blocks)
    bids_np = np.full((nb, K), m, np.int64)
    for i, bl in enumerate(ras_blocks):
        bids_np[i, : bl.size] = bl
    owner = -np.ones(m, np.int64)
    own_np = np.zeros((nb, K), bool)
    for i, bl in enumerate(ras_blocks):
        new = bl[owner[bl] < 0]
        owner[new] = i
        own_np[i, : bl.size] = owner[ras_blocks[i]] == i
    mats = np.zeros((nb, K, K))
    mats[:, np.arange(K), np.arange(K)] = 1.0
    for i, bl in enumerate(ras_blocks):
        Ab = np.asarray(A_csr[bl][:, bl].todense())
        dz0 = np.abs(np.diag(Ab)) < 1e-300
        Ab[dz0, dz0] = 1.0
        mats[i, : bl.size, : bl.size] = Ab
    binv = jnp.asarray(np.linalg.inv(mats))
    nnz_row = np.diff(A_csr.indptr)
    nnzmax = max(1, int(nnz_row.max()))
    ecols_np = np.full((m, nnzmax), m, np.int64)
    evals_np = np.zeros((m, nnzmax))
    rows_rep = np.repeat(np.arange(m), nnz_row)
    offs2 = np.arange(A_csr.nnz) - np.repeat(A_csr.indptr[:-1], nnz_row)
    ecols_np[rows_rep, offs2] = A_csr.indices
    evals_np[rows_rep, offs2] = A_csr.data
    zr = nnz_row == 0
    ecols_np[zr, 0] = np.where(zr)[0]
    evals_np[zr, 0] = 1.0
    bids = jnp.asarray(bids_np)
    own = jnp.asarray(own_np)
    ecols = jnp.asarray(ecols_np, jnp.int32)
    evals = jnp.asarray(evals_np)
    n_sweeps = sweeps if sweeps is not None else max(10, int(0.3 * m**0.5))

    def apply(rf):
        rb = rf[ids_j]
        dt = rb.dtype

        def band_mv(v):
            vpad = jnp.concatenate([v, jnp.zeros(1, dt)])
            return (evals.astype(dt) * vpad[ecols]).sum(axis=1)

        def band_ras(v):
            vpad = jnp.concatenate([v, jnp.zeros(1, dt)])
            cb = jnp.einsum("bkl,bl->bk", binv.astype(dt), vpad[bids])
            upd = jnp.where(own, cb, 0.0)
            out = jnp.zeros(m + 1, dt).at[bids].add(upd)
            return out[:m]

        if inner == "richardson":
            om = jnp.asarray(inner_omega, dt)

            def rich_step(k, z):
                return z + om * band_ras(rb - band_mv(z))

            corr = jax.lax.fori_loop(
                0, n_sweeps, rich_step, om * band_ras(rb)
            )
        else:
            # fixed-sweep fori_loop BiCGStab (mg._band_bicgstab): bounded
            # work, no nested-while condition machinery (same class as the
            # 2D band solve)
            from ..mg import _band_bicgstab

            corr = _band_bicgstab(band_mv, band_ras, rb, n_sweeps)
        return ids_j, corr

    return apply


def lattice_l2_h1_errors_vec(
    grid, region_mask: np.ndarray, u_lat: Array, exact: Callable
) -> Dict[str, float]:
    """Vector version of :func:`lattice_l2_h1_errors`: ``u_lat`` is
    (nc_fields, D, R, C) channels-first, ``exact((..., 3)) -> (..., nc)``;
    L2/H10 norms sum over channels (the 3D analogue of the 2D
    ``SchemeBase.l2_h1_errors`` on vector spaces)."""
    dt = float_dtype()
    hx, hy, hz = grid.spacing
    ncf = u_lat.shape[0]
    mask = jnp.asarray(region_mask.astype(np.float64), dt)
    nz, ny, nx = mask.shape
    D, R, C = grid.lattice_shape
    x, y, z = grid.vertex_coords_lattice(dt)
    x0 = jnp.broadcast_to(x, (D, R, C))[:nz, :ny, :nx]
    y0 = jnp.broadcast_to(y, (D, R, C))[:nz, :ny, :nx]
    z0 = jnp.broadcast_to(z, (D, R, C))[:nz, :ny, :nx]
    corners = [
        [
            u_lat[c, dz : dz + nz, dy : dy + ny, dx : dx + nx]
            for (dx, dy, dz) in HEX_OFFS
        ]
        for c in range(ncf)
    ]
    W, V, G = hex_quadrature(2)
    Pq = hex_quadrature_points(2)
    num_l2 = den_l2 = num_h1 = den_h1 = jnp.asarray(0.0, dt)
    jac_exact = jax.vmap(
        jax.vmap(jax.vmap(jax.jacfwd(lambda p: exact(p[None])[0])))
    )
    for q in range(W.shape[0]):
        wq3 = float(W[q])
        Nq = jnp.asarray(V[q], dt)
        Gd = jnp.asarray(G[q], dt) / np.array([hx, hy, hz])[None, :]
        px = x0 + float(Pq[q, 0]) * hx
        py = y0 + float(Pq[q, 1]) * hy
        pz = z0 + float(Pq[q, 2]) * hz
        pe = jnp.stack([px, py, pz], axis=-1)
        ue = exact(pe)  # (..., ncf)
        ge = jac_exact(pe)  # (..., ncf, 3)
        for c in range(ncf):
            uq = sum(Nq[i] * corners[c][i] for i in range(8))
            num_l2 += wq3 * jnp.sum(mask * (uq - ue[..., c]) ** 2)
            den_l2 += wq3 * jnp.sum(mask * ue[..., c] ** 2)
            for k in range(3):
                gk = sum(Gd[i, k] * corners[c][i] for i in range(8))
                num_h1 += wq3 * jnp.sum(mask * (gk - ge[..., c, k]) ** 2)
                den_h1 += wq3 * jnp.sum(mask * ge[..., c, k] ** 2)
    return {
        "l2": float(jnp.sqrt(num_l2 / den_l2)),
        "h10": float(jnp.sqrt(num_h1 / den_h1)),
    }


def lattice_l2_h1_errors(
    grid, region_mask: np.ndarray, u_lat: Array, exact: Callable
) -> Dict[str, float]:
    """Relative L2/H10 errors of a scalar lattice field vs a callable, by
    2x2x2 cellwise Gauss quadrature over the masked cells (dense masked
    lattice sums — no per-cell gathers)."""
    dt = float_dtype()
    hx, hy, hz = grid.spacing
    W, V, G = hex_quadrature(2)
    mask = jnp.asarray(region_mask.astype(np.float64), dt)
    nz, ny, nx = mask.shape
    D, R, C = grid.lattice_shape
    x, y, z = grid.vertex_coords_lattice(dt)
    x0 = jnp.broadcast_to(x, (D, R, C))[:nz, :ny, :nx]
    y0 = jnp.broadcast_to(y, (D, R, C))[:nz, :ny, :nx]
    z0 = jnp.broadcast_to(z, (D, R, C))[:nz, :ny, :nx]
    corners = [
        u_lat[dz : dz + nz, dy : dy + ny, dx : dx + nx]
        for (dx, dy, dz) in HEX_OFFS
    ]
    pts, wts = [], []
    g1, w1 = gauss01(2)
    for qz, wz in zip(g1, w1):
        for qy, wy in zip(g1, w1):
            for qx, wx in zip(g1, w1):
                pts.append((qx, qy, qz))
                wts.append(wx * wy * wz)
    num_l2 = den_l2 = num_h1 = den_h1 = jnp.asarray(0.0, dt)
    for (qx, qy, qz), wq3, Vq, Gq in zip(pts, wts, V, G):
        Nq = jnp.asarray(Vq, dt)
        Gd = jnp.asarray(Gq, dt) / np.array([hx, hy, hz])[None, :]
        uq = sum(Nq[i] * corners[i] for i in range(8))
        px = x0 + qx * hx
        py = y0 + qy * hy
        pz = z0 + qz * hz
        pe = jnp.stack([px, py, pz], axis=-1)
        ue = exact(pe)
        ge = jax.vmap(
            jax.vmap(jax.vmap(jax.grad(lambda p: exact(p[None])[0])))
        )(pe)
        num_l2 += wq3 * jnp.sum(mask * (uq - ue) ** 2)
        den_l2 += wq3 * jnp.sum(mask * ue**2)
        for k in range(3):
            gk = sum(Gd[i, k] * corners[i] for i in range(8))
            num_h1 += wq3 * jnp.sum(mask * (gk - ge[..., k]) ** 2)
            den_h1 += wq3 * jnp.sum(mask * ge[..., k] ** 2)
    return {
        "l2": float(jnp.sqrt(num_l2 / den_l2)),
        "h10": float(jnp.sqrt(num_h1 / den_h1)),
    }
