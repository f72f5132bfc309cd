"""Lattice-resident MG (ops.lattice): the 2D north-star Poisson path.

Oracles: the general masked-operator path (same discretization, so results
must agree to solver tolerance) and the analytic solution.  Also pins two
V-cycle preconditioner bugs found via this path (mg.py): BC-row residual
leak through restriction, and M singular on the identity block.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import phifem_tpu as pf
from phifem_tpu.models import BoxPoisson
from phifem_tpu.ops.lattice import (
    _conv_interior,
    _embed,
    _prolong,
    _restrict,
    build_lattice_mg,
    lattice_cg,
    vertex_stencil_weights,
)
from phifem_tpu.solvers import masked_operator


def _problem(n, ct):
    g = pf.Grid(n, n, ((0.0, 0.0), (1.0, 1.0)), ct)
    uex = lambda x: jnp.sin(jnp.pi * x[..., 0]) * jnp.sin(jnp.pi * x[..., 1]) + x[..., 0]
    f = lambda x: 2.0 * jnp.pi**2 * (uex(x) - x[..., 0])
    s = BoxPoisson(g).setup(f, uex)
    s.assemble()
    return s, uex


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_conv_matches_masked_operator(ct):
    """The 9-point vertex-stencil convolution equals the general masked
    matvec at every interior node (boundary rows are identity vs zero)."""
    n = 24
    s, _ = _problem(n, ct)
    mg = s.lattice_solver(min_n=12, dtype=jnp.float64)
    R = C = n + 1
    rng = np.random.default_rng(0)
    x2 = np.zeros((R, C))
    x2[1:-1, 1:-1] = rng.standard_normal((R - 2, C - 2))
    xp = jnp.zeros((R + 2, C + 2)).at[1 : 1 + R, 1 : 1 + C].set(x2)
    y_lat = np.asarray(_embed(_conv_interior(xp, mg.terms, R, C), R, C))[
        1 : 1 + R, 1 : 1 + C
    ]
    mv, _, _ = masked_operator(s.op, s.bcs)
    y_gen = np.asarray(mv({"u": jnp.asarray(x2.reshape(-1))})["u"]).reshape(R, C)
    assert np.abs(y_lat[1:-1, 1:-1] - y_gen[1:-1, 1:-1]).max() < 1e-11


def test_tri_stiffness_is_five_point():
    """P1 stiffness on the right-triangle split degenerates to the classic
    5-point Laplacian: the diagonal couplings cancel and are dropped."""
    s, _ = _problem(8, "triangle")
    mg = s.lattice_solver(min_n=4, dtype=jnp.float64)
    assert len(mg.terms) == 5
    offs = {(a, b) for a, b, w in mg.terms}
    assert offs == {(1, 1), (0, 1), (2, 1), (1, 0), (1, 2)}


def test_transfer_adjointness():
    """restrict == prolong^T (weight sum 4) on reduced vectors."""
    rng = np.random.default_rng(1)
    Rc = Cc = 9
    R, C = 2 * Rc - 1, 2 * Cc - 1
    ec = np.zeros((Rc + 2, Cc + 2))
    ec[2:Rc, 2:Cc] = rng.standard_normal((Rc - 2, Cc - 2))
    rf = rng.standard_normal((R - 2, C - 2))
    # <P e, r>_f (interior inner product)
    Pe = np.asarray(_prolong(jnp.asarray(ec), Rc, Cc))[1:-1, 1:-1]
    lhs = float((Pe * rf).sum())
    # <e, R r>_c
    Rr = np.asarray(_restrict(jnp.asarray(rf), Rc, Cc))
    rhs = float((ec * Rr).sum())
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_lattice_solve_matches_general(ct):
    """solve_lattice == the general equilibrated MG-CG path, with
    NONZERO Dirichlet data (pins the two mg.py BC fixes: residual masking
    before restriction + identity on inactive rows in the preconditioner)."""
    n = 48
    s, uex = _problem(n, ct)
    r = s.solve_lattice(tol=1e-11, maxiter=60)
    assert r.converged and r.iterations <= 15
    vc = s.mg_preconditioner(min_n=12)
    rg = s.solve(method="cg", tol=1e-11, maxiter=200, precond=vc)
    assert rg.converged, rg.residual
    du = np.abs(np.asarray(r.x["u"] - rg.x["u"])).max()
    assert du < 1e-7, du
    # and both match the analytic solution at discretization accuracy
    ue = np.asarray(pf.interpolate(uex, s.V).data)
    err = np.linalg.norm(np.asarray(r.x["u"]) - ue) / np.linalg.norm(ue)
    assert err < 5e-3, err


def test_lattice_grid_independent_iterations():
    """MG quality: iteration count must not grow with refinement."""
    iters = []
    for n in (32, 64, 128):
        s, _ = _problem(n, "triangle")
        r = s.solve_lattice(tol=1e-10, maxiter=60)
        assert r.converged
        iters.append(r.iterations)
    assert max(iters) <= 15, iters
    assert iters[-1] <= iters[0] + 3, iters


def test_lattice_f32_preconditioner_reaches_f64_floor():
    """f32 V-cycle inside f64 CG converges to 1e-10 (the bench config)."""
    s, _ = _problem(64, "triangle")
    mg = s.lattice_solver(min_n=16, dtype=jnp.float32)
    r = s.solve_lattice(tol=1e-10, maxiter=60, mg=mg)
    assert r.converged and r.residual <= 1e-10, (r.iterations, r.residual)


def test_scheme_lattice_preconditioner_s1():
    """Full-box lattice V-cycle + cut-block correction preconditions the
    S1 weak-Dirichlet operator: same solution as the re-discretized
    hierarchy, no per-level tagging (models/base.lattice_preconditioner)."""
    from phifem_tpu.models import WeakDirichletPoisson

    n = 48
    grid = pf.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), pf.CellType.triangle)
    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 1.0
    f = lambda x: jnp.ones(x.shape[:-1])
    s = WeakDirichletPoisson(grid, mode="bg")
    s.setup(phi, f)
    s.assemble()
    vc = s.lattice_preconditioner(min_n=12)
    r1 = s.solve(method="bicgstab", tol=1e-9, maxiter=80, precond=vc)
    assert r1.converged, r1.residual
    r2 = s.solve(method="bicgstab", tol=1e-9, maxiter=400)
    du = np.abs(np.asarray(r1.x["u"] - r2.x["u"])).max()
    scale = np.abs(np.asarray(r2.x["u"])).max()
    assert du / scale < 1e-5, du / scale


def test_scheme_lattice_preconditioner_schwarz_band():
    """The scalable interface path (inner BiCGStab on the ELL band matrix
    with RAS block preconditioning) must converge where one-level RAS
    sweeps stalled; dense_max=1 forces it even for small bands."""
    from phifem_tpu.models import WeakDirichletPoisson

    n = 128
    grid = pf.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), pf.CellType.triangle)
    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 1.0
    f = lambda x: jnp.ones(x.shape[:-1])
    s = WeakDirichletPoisson(grid, mode="bg")
    s.setup(phi, f)
    s.assemble()
    vc = s.lattice_preconditioner(min_n=12, dense_max=1)
    assert vc.band_ell_vals is not None  # Schwarz path chosen
    r = s.solve(method="bicgstab", tol=1e-8, maxiter=60, precond=vc)
    assert r.converged, r.residual


def test_block_mg_matches_scalar_on_uncoupled_channels():
    """LatticeBlockMG with a block stencil whose (vsz, vsz) blocks are
    diagonal must act channelwise exactly like the scalar LatticeMG (the
    vector generalization is then pinned to the proven scalar cycle)."""
    from phifem_tpu.assembly import CellTerm, System, assemble_operator
    from phifem_tpu.ops.lattice import (
        block_vertex_stencil_weights,
        build_lattice_block_mg,
        build_lattice_mg,
        vertex_stencil_weights,
    )
    from phifem_tpu.ops.stencil import _TRI_OFFS, StencilCellBatch
    from phifem_tpu.spaces import Space

    n = 32
    g = pf.Grid(n, n, ((0.0, 0.0), (1.0, 1.0)), pf.CellType.triangle)
    lap = lambda u, v, d, x, ctx: jnp.sum(u["u"].grad * v["u"].grad)
    op_s = assemble_operator(
        System({"u": Space.lagrange(g, 1)}), g,
        cell_terms=[(CellTerm(lap, None, degree=2, uniform=True), {})],
    )
    ws = sum(
        vertex_stencil_weights(np.asarray(b.matrices), _TRI_OFFS)
        for b in op_s.batches
        if isinstance(b, StencilCellBatch)
    )
    op_v = assemble_operator(
        System({"u": Space.lagrange(g, 1, (2,))}), g,
        cell_terms=[(CellTerm(lap, None, degree=2, uniform=True), {})],
    )
    wb = sum(
        block_vertex_stencil_weights(np.asarray(b.matrices), _TRI_OFFS, 2)
        for b in op_v.batches
    )
    assert np.allclose(wb[:, :, 0, 0], ws) and np.abs(wb[:, :, 0, 1]).max() == 0.0
    mg_s = build_lattice_mg(n, n, ws, min_n=8, dtype=jnp.float64)
    mg_b = build_lattice_block_mg(n, n, wb, min_n=8, dtype=jnp.float64)
    R = C = n + 1
    r = np.random.default_rng(0).standard_normal((R, C))
    zs = mg_s(jnp.zeros((R + 2, C + 2)).at[1:1 + R, 1:1 + C].set(r))
    rp = (
        jnp.zeros((2, R + 2, C + 2))
        .at[0, 1:1 + R, 1:1 + C].set(r)
        .at[1, 1:1 + R, 1:1 + C].set(2 * r)
    )
    zb = mg_b(rp)
    assert float(jnp.abs(zb[0] - zs).max()) < 1e-12
    assert float(jnp.abs(zb[1] - 2 * zs).max()) < 1e-12


def test_block_mg_elasticity_cg():
    """MG-preconditioned CG on a full-box vector-P1 elasticity operator
    (Dirichlet ring) converges fast — the S5 bulk cycle in isolation."""
    from phifem_tpu.assembly import CellTerm, System, assemble_operator
    from phifem_tpu.models.interface_elasticity import _eps, _sigma, lame
    from phifem_tpu.ops.lattice import (
        block_vertex_stencil_weights,
        build_lattice_block_mg,
    )
    from phifem_tpu.ops.stencil import _TRI_OFFS
    from phifem_tpu.spaces import Space

    n = 48
    g = pf.Grid(n, n, ((0.0, 0.0), (1.0, 1.0)), pf.CellType.triangle)
    li, mi = lame(1.0, 0.3)
    stiff = lambda u, v, d, x, ctx: jnp.sum(
        _sigma(u["u"].grad, li, mi) * _eps(v["u"].grad)
    )
    op = assemble_operator(
        System({"u": Space.lagrange(g, 1, (2,))}), g,
        cell_terms=[(CellTerm(stiff, None, degree=2, uniform=True), {})],
    )
    wb = sum(
        block_vertex_stencil_weights(np.asarray(b.matrices), _TRI_OFFS, 2)
        for b in op.batches
    )
    mask = np.zeros((n + 1, n + 1), bool)
    mask[1:-1, 1:-1] = True
    mg = build_lattice_block_mg(n, n, wb, min_n=8, dtype=jnp.float64, mask=mask)
    R = C = n + 1
    mj = jnp.asarray(mask)
    xstar = jnp.asarray(
        np.random.default_rng(1).standard_normal((2, R, C))
    ) * mj

    def A(x3):
        xf = jnp.moveaxis(x3, 0, -1).reshape(-1, 2)
        y = op.batches[0].matvec_into({"u": xf}, {"u": jnp.zeros_like(xf)})
        return jnp.moveaxis(y["u"].reshape(R, C, 2), -1, 0) * mj

    def Minv(r):
        rp = jnp.zeros((2, R + 2, C + 2)).at[:, 1:1 + R, 1:1 + C].set(r * mj)
        return mg(rp)[:, 1:1 + R, 1:1 + C] * mj

    b = A(xstar)
    x = jnp.zeros_like(b)
    r = b
    z = Minv(r)
    p = z
    rz = jnp.sum(r * z)
    b2 = jnp.sum(b * b)
    for it in range(40):
        Ap = A(p)
        alpha = rz / jnp.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        if float(jnp.sum(r * r) / b2) ** 0.5 < 1e-10:
            break
        z = Minv(r)
        rz_new = jnp.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    assert it < 39, float(jnp.sum(r * r) / b2) ** 0.5
    assert float(jnp.abs(x - xstar).max()) < 1e-8


def test_scheme_lattice_preconditioner_iteration_scaling():
    """Outer BiCGStab iteration ceilings at two sizes spanning BOTH
    interface-solve variants (n=160 -> dense inverse, n=320 -> Schwarz
    band): a regression in the RAS/inner-Krylov interface solve would
    otherwise surface only as silent slowdown.
    Measured: 12 and 17 iterations."""
    from phifem_tpu.models import WeakDirichletPoisson

    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 1.0
    f = lambda x: jnp.ones(x.shape[:-1])
    bounds = {160: 20, 320: 28}
    for n, bound in bounds.items():
        g = pf.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), pf.CellType.triangle)
        s = WeakDirichletPoisson(g, mode="bg")
        s.setup(phi, f)
        s.assemble()
        vc = s.lattice_preconditioner()
        r = s.solve(method="bicgstab", tol=1e-9, maxiter=bound + 10, precond=vc)
        assert r.converged, (n, r.residual)
        assert 0 <= r.iterations <= bound, (n, r.iterations)
    # both paths really were exercised


def test_scheme_lattice_preconditioner_s3_mixed():
    """lattice_preconditioner on the MIXED S3 system (P1 u + vector-P1 y
    + DG0 p): the scalar primal bulk rides the stencil V-cycle, auxiliary
    fields fall back to Jacobi + the interface solve."""
    import jax
    from phifem_tpu.models import NeumannPoisson

    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49
    uex = lambda x: jnp.sin(x[..., 0]) * jnp.cos(x[..., 1])
    f = lambda x: 2.0 * uex(x) + uex(x)

    def du_dn(x):
        g = jax.vmap(jax.grad(lambda p: jnp.sin(p[0]) * jnp.cos(p[1])))(x)
        gp = 2.0 * x
        nrm = jnp.maximum(jnp.linalg.norm(gp, axis=-1), 1e-12)
        return jnp.sum(g * gp, axis=-1) / nrm

    g = pf.Grid(48, 48, ((-1.0, -1.0), (1.0, 1.0)), "triangle")
    s = NeumannPoisson(g, mode="bg")
    s.setup(phi, f, du_dn)
    s.assemble()
    vc = s.lattice_preconditioner(min_n=12)
    r1 = s.solve(method="bicgstab", tol=1e-9, maxiter=120, precond=vc)
    assert r1.converged, r1.residual
    r2 = s.solve(method="bicgstab", tol=1e-9, maxiter=2000)
    for k in r1.x:
        du = np.abs(np.asarray(r1.x[k] - r2.x[k])).max()
        sc = max(np.abs(np.asarray(r2.x[k])).max(), 1e-12)
        # the DG0 auxiliary p is tiny (max ~2e-3): its relative agreement
        # is bounded by the outer tolerance against ||x||, not ||p||
        tol_k = 1e-3 if k == "p" else 1e-4
        assert du / sc < tol_k, (k, du / sc)
