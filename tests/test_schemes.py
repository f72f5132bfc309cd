"""End-to-end scheme tests: manufactured solutions on a circle levelset,
checking the phi-FEM convergence rates the reference demos establish
(S3/S4 print relative H1 errors; S5 fits L2/H10 slopes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import phifem_tpu as pf
from phifem_tpu.models import (
    InterfaceElasticity,
    NeumannPoisson,
    RobinPoisson,
    StrongDirichletPoisson,
    WeakDirichletPoisson,
)

BOX = ((-1.0, -1.0), (1.0, 1.0))
R = 0.7


def phi_circle(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 - R**2


def u_ex(x):
    return jnp.sin(jnp.pi * x[..., 0]) * jnp.cos(jnp.pi * x[..., 1])


def f_poisson(x):
    return 2.0 * jnp.pi**2 * u_ex(x)


def f_helmholtz(x):
    return 2.0 * jnp.pi**2 * u_ex(x) + u_ex(x)


def normal_derivative(x):
    """du/dn with n = grad(phi)/|grad(phi)| (defined away from the origin)."""
    g = jax.vmap(jax.grad(lambda p: u_ex(p)))(x)
    gp = 2.0 * x
    norm = jnp.maximum(jnp.linalg.norm(gp, axis=-1), 1e-12)
    return jnp.sum(g * gp, axis=-1) / norm


# smooth low-frequency manufactured solution for S1 (the dual-penalty
# scheme converges at O(h^2) but with a large constant for oscillatory
# data; an affine patch test below pins exactness)
def u_mild(x):
    return jnp.cos(x[..., 0]) * jnp.sin(x[..., 1])


def f_mild(x):
    return 2.0 * u_mild(x)


def _weak_dirichlet_error(n, method="dense", uex=u_mild, f=f_mild):
    g = pf.Grid(n, n, BOX, pf.CellType.triangle)
    s = WeakDirichletPoisson(g, mode="bg")
    s.setup(phi_circle, f, u_D=uex)
    s.assemble()
    res = s.solve(method=method, tol=1e-12)
    assert res.converged, res.residual
    return s.l2_h1_errors(s.u_h, uex)


def test_weak_dirichlet_patch_exact():
    """Affine solutions are reproduced to machine precision (stiffness,
    boundary flux, penalty, u_D data path all exactly consistent)."""
    uex = lambda x: 1.0 + 2.0 * x[..., 0] - x[..., 1]
    fz = lambda x: jnp.zeros(x.shape[:-1])
    e = _weak_dirichlet_error(10, uex=uex, f=fz)
    assert e["l2"] < 1e-10 and e["h10"] < 1e-10, e


def test_weak_dirichlet_convergence():
    e1 = _weak_dirichlet_error(10)
    e2 = _weak_dirichlet_error(20)
    rate_l2 = np.log2(e1["l2"] / e2["l2"])
    rate_h1 = np.log2(e1["h10"] / e2["h10"])
    assert e2["l2"] < 0.12, (e1, e2)
    assert rate_l2 > 1.5, (e1, e2)
    assert rate_h1 > 0.7, (e1, e2)


def test_weak_dirichlet_sub_mode_matches_bg():
    ebg = _weak_dirichlet_error(12)
    g = pf.Grid(12, 12, BOX, pf.CellType.triangle)
    s = WeakDirichletPoisson(g, mode="sub")
    s.setup(phi_circle, f_mild, u_D=u_mild)
    s.assemble()
    s.solve(method="dense")
    esub = s.l2_h1_errors(s.u_h, u_mild)
    # bg vs sub solve the same discrete problem here (domain away from box)
    assert np.isclose(esub["l2"], ebg["l2"], rtol=1e-8), (ebg, esub)


def test_weak_dirichlet_bicgstab_matches_dense():
    ed = _weak_dirichlet_error(10, method="dense")
    ei = _weak_dirichlet_error(10, method="bicgstab")
    assert np.isclose(ed["l2"], ei["l2"], rtol=1e-4), (ed, ei)


def test_strong_dirichlet_convergence():
    def w_ex(x):
        return jnp.cos(x[..., 0] + 0.5 * x[..., 1])

    def u_exact(x):
        return phi_circle(x) * w_ex(x)

    def f(x):
        H = jax.vmap(jax.hessian(lambda p: phi_circle(p) * w_ex(p)))(x)
        return -jnp.trace(H, axis1=-2, axis2=-1)

    errs = []
    for n in (10, 20):
        g = pf.Grid(n, n, BOX, pf.CellType.triangle)
        s = StrongDirichletPoisson(g, mode="bg")
        s.setup(phi_circle, f)
        s.assemble()
        res = s.solve(method="dense")
        errs.append(s.l2_h1_errors(s.u_h, u_exact))
    rate = np.log2(errs[0]["l2"] / errs[1]["l2"])
    assert errs[1]["l2"] < 0.05, errs
    assert rate > 1.5, errs


@pytest.mark.parametrize("cell_type", ["quadrilateral", "triangle"])
def test_neumann_convergence(cell_type):
    errs = []
    for n in (10, 20):
        g = pf.Grid(n, n, BOX, cell_type)
        s = NeumannPoisson(g, mode="bg")
        s.setup(phi_circle, f_helmholtz, normal_derivative)
        s.assemble()
        res = s.solve(method="dense")
        errs.append(s.l2_h1_errors(s.u_h, u_ex))
    assert errs[1]["h1"] < 0.2, errs
    rate = np.log2(errs[0]["l2"] / errs[1]["l2"])
    assert rate > 1.3, errs


def test_robin_convergence():
    alpha = 1.0

    def robin_data(x):
        return normal_derivative(x) + alpha * u_ex(x)

    errs = []
    for n in (10, 20):
        g = pf.Grid(n, n, BOX, "triangle")
        s = RobinPoisson(g, mode="bg", robin_coef=alpha)
        s.setup(phi_circle, f_helmholtz, robin_data)
        s.assemble()
        res = s.solve(method="dense")
        errs.append(s.l2_h1_errors(s.u_h, u_ex))
    assert errs[1]["h1"] < 0.2, errs
    rate = np.log2(errs[0]["l2"] / errs[1]["l2"])
    assert rate > 1.3, errs


# ---------------------------------------------------------------- S5
E_IN, E_OUT = 1.0, 0.001


def phi_iface(x):
    return 1.0 - (x[..., 0] ** 2 + x[..., 1] ** 2)


def exact_elastic(x):
    # reference demo/interface-elasticity/data.py:43-48
    r = jnp.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
    val = (jnp.cos(r) - jnp.cos(1.0)) / E_IN
    val = jnp.where(r < 1.0, val * (E_IN / E_OUT), val)
    return jnp.stack([val, val], axis=-1)


def source_elastic(x):
    # f = -div sigma_in(cos_vec) / E_in via autodiff (reference main.py:147)
    from phifem_tpu.models.interface_elasticity import lame

    lmbda, mu = lame(E_IN, 0.3)

    def sigma(p):
        G = jax.jacfwd(
            lambda q: jnp.stack(
                [jnp.cos(jnp.sqrt(q[0] ** 2 + q[1] ** 2))] * 2
            )
        )(p)
        eps = 0.5 * (G + G.T)
        return lmbda * jnp.trace(G) * jnp.eye(2) + 2 * mu * eps

    D = jax.vmap(jax.jacfwd(sigma))(x)  # (n, 2, 2, 2): d_k sigma_ij
    div = jnp.einsum("nijj->ni", D)
    return -div / E_IN


def _elastic_errors(n):
    g = pf.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), "triangle")
    s = InterfaceElasticity(g, mode="bg", E_in=E_IN, E_out=E_OUT)
    s.setup(phi_iface, source_elastic, exact_elastic)
    s.assemble()
    res = s.solve(method="dense")
    err = s.l2_h1_errors(s.u_h, exact_elastic, region=None)
    return err, s.U.num_dofs


def test_interface_elasticity_convergence():
    e1, d1 = _elastic_errors(8)
    e2, d2 = _elastic_errors(16)
    # reference oracle: L2 slope ~ -1, H10 slope ~ -0.5 vs DoF
    slope_l2 = (np.log(e2["l2"]) - np.log(e1["l2"])) / (np.log(d2) - np.log(d1))
    assert e2["l2"] < e1["l2"], (e1, e2)
    assert slope_l2 < -0.5, (e1, e2, slope_l2)


def test_weak_dirichlet_p2_convergence():
    """P2 end-to-end: S1 with primal_degree=2 (+ P2 level set) converges
    at O(h^3) in L2 — the degree machinery (quadratures, ghost npts,
    penalty phi-weights) is exercised beyond the reference's P1 demos."""
    import jax

    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 1.0
    uex = lambda x: jnp.cos(x[..., 0]) * jnp.exp(x[..., 1] / 2.0)

    def f(x):
        u = lambda p: jnp.cos(p[0]) * jnp.exp(p[1] / 2.0)
        H = jax.vmap(jax.hessian(u))(x)
        return -jnp.trace(H, axis1=-2, axis2=-1)

    errs = []
    for n in (24, 48):
        g = pf.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), "triangle")
        s = WeakDirichletPoisson(g, mode="bg", primal_degree=2, levelset_degree=2)
        s.setup(phi, f, u_D=uex)
        s.assemble()
        r = s.solve(method="bicgstab", tol=1e-12, maxiter=5000)
        assert r.converged, r.residual
        e = s.l2_h1_errors(s.u_h, uex, region=(1, 2))
        errs.append(e["l2"])
    # measured 8.8x per halving (O(h^3) = 8x); require well above the
    # P1 rate (4x) to catch degree regressions
    assert errs[0] / errs[1] > 6.0, errs
    assert errs[1] < 2e-4, errs


def test_weak_dirichlet_p3_convergence():
    """P3 end-to-end (degree-3 support must be exercised, not just
    tabulated): S1 with primal_degree=3 converges at O(h^4) in L2."""
    import jax

    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 1.0
    uex = lambda x: jnp.cos(x[..., 0]) * jnp.exp(x[..., 1] / 2.0)

    def f(x):
        u = lambda p: jnp.cos(p[0]) * jnp.exp(p[1] / 2.0)
        H = jax.vmap(jax.hessian(u))(x)
        return -jnp.trace(H, axis1=-2, axis2=-1)

    errs = []
    for n in (8, 16):
        g = pf.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), "triangle")
        s = WeakDirichletPoisson(g, mode="bg", primal_degree=3, levelset_degree=3)
        s.setup(phi, f, u_D=uex)
        s.assemble()
        # penalized degree-3 systems are too ill-conditioned for plain
        # Jacobi-Krylov (residual floors ~1e-6); the ON-DEVICE p-multigrid
        # preconditioner (phifem_tpu.pmg: degree-1 rediscretized coarse
        # level + cut-band solve) converges fgmres to ~1e-12 in ~20 iters
        vc = s.p_multigrid_preconditioner()
        r = s.solve(method="fgmres", tol=1e-10, maxiter=200, precond=vc)
        assert r.converged, r.residual
        e = s.l2_h1_errors(s.u_h, uex, region=(1, 2))
        errs.append(e["l2"])
    # O(h^4) = 16x per halving; require well above the P2 rate (8x)
    assert errs[0] / errs[1] > 10.0, errs
    assert errs[1] < 1e-4, errs


def test_weak_dirichlet_q3_convergence():
    """Q3 on the quadrilateral grid, end-to-end: the tensor-product
    degree-3 element path (quadratures, ghost terms on quad facets)."""
    import jax

    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 1.0
    uex = lambda x: jnp.cos(x[..., 0]) * jnp.exp(x[..., 1] / 2.0)

    def f(x):
        u = lambda p: jnp.cos(p[0]) * jnp.exp(p[1] / 2.0)
        H = jax.vmap(jax.hessian(u))(x)
        return -jnp.trace(H, axis1=-2, axis2=-1)

    errs = []
    for n in (8, 16):
        g = pf.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), "quadrilateral")
        s = WeakDirichletPoisson(g, mode="bg", primal_degree=3, levelset_degree=3)
        s.setup(phi, f, u_D=uex)
        s.assemble()
        # on-device p-multigrid instead of host sparse LU (see the P3
        # twin above)
        vc = s.p_multigrid_preconditioner()
        r = s.solve(method="fgmres", tol=1e-10, maxiter=200, precond=vc)
        assert r.converged, r.residual
        e = s.l2_h1_errors(s.u_h, uex, region=(1, 2))
        errs.append(e["l2"])
    assert errs[0] / errs[1] > 10.0, errs
    assert errs[1] < 1e-4, errs


def test_interface_elasticity_deflated_krylov():
    """S5's system is exactly singular (collective rigid-body modes of
    (u_in, u_out) — the reference hands this to MUMPS icntl 24/25,
    demo/interface-elasticity/main.py:251-254).  The iterative analogue:
    rigid-mode deflation (InterfaceElasticity.rigid_modes) + the block
    lattice-MG preconditioner must converge in few outer iterations and
    reproduce the dense null-pivot solution's errors."""
    n = 16
    g = pf.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), "triangle")
    s = InterfaceElasticity(g, mode="bg", E_in=E_IN, E_out=E_OUT)
    s.setup(phi_iface, source_elastic, exact_elastic)
    s.assemble()
    vc = s.lattice_preconditioner(min_n=8)
    r = s.solve(method="bicgstab", tol=1e-10, maxiter=60, precond=vc)
    assert r.converged, r.residual
    assert 0 <= r.iterations <= 40, r.iterations
    e_it = s.l2_h1_errors(s.u_h, exact_elastic, region=None)
    s.solve(method="dense")
    e_d = s.l2_h1_errors(s.u_h, exact_elastic, region=None)
    # different null-space gauges (deflation zeroes rigid content; lstsq
    # minimizes norm) — scheme errors must agree to consistency level
    assert abs(e_it["l2"] - e_d["l2"]) / e_d["l2"] < 0.05, (e_it, e_d)
    assert abs(e_it["h10"] - e_d["h10"]) / e_d["h10"] < 0.05, (e_it, e_d)


def test_interface_elasticity_sparse_lu():
    """S5 on the sparse direct path (``method="sparse"``, plain SuperLU —
    the reference's MUMPS-LU, demo/interface-elasticity/main.py:251-254):
    the assembled system is ill-conditioned but NOT exactly singular
    (smallest singular values ~3e-5 at level 0), so plain LU must
    reproduce the dense null-pivot path's errors.  This is the solver the
    large convergence-study levels ride (scripts/run_s5_ext.sh), where
    flat-preconditioned BiCGStab breaks down before converging."""
    n = 16
    g = pf.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), "triangle")
    s = InterfaceElasticity(g, mode="bg", E_in=E_IN, E_out=E_OUT)
    s.setup(phi_iface, source_elastic, exact_elastic)
    s.assemble()
    r = s.solve(method="sparse")
    assert r.residual < 1e-10, r.residual
    e_sp = s.l2_h1_errors(s.u_h, exact_elastic, region=None)
    s.solve(method="dense")
    e_d = s.l2_h1_errors(s.u_h, exact_elastic, region=None)
    assert abs(e_sp["l2"] - e_d["l2"]) / e_d["l2"] < 0.01, (e_sp, e_d)
    assert abs(e_sp["h10"] - e_d["h10"]) / e_d["h10"] < 0.01, (e_sp, e_d)


def test_neumann_q2_convergence():
    """Q2 on the quadrilateral grid, end-to-end (degree 2-3 elements
    exercised beyond P2-triangle).
    Matches the reference's degree parametrization
    (tests/test_compute_meshtags.py, degrees 1-3) and S3's degree-2
    levelset (demo/neumann/square/main.py:49-51)."""
    errs = []
    for n in (10, 20):
        g = pf.Grid(n, n, BOX, "quadrilateral")
        s = NeumannPoisson(
            g, mode="bg", primal_degree=2, vector_degree=2, levelset_degree=2
        )
        s.setup(phi_circle, f_helmholtz, normal_derivative)
        s.assemble()
        s.solve(method="dense")
        errs.append(s.l2_h1_errors(s.u_h, u_ex))
    rate = np.log2(errs[0]["l2"] / errs[1]["l2"])
    # must clearly beat the Q1 rate (2.0); the mixed DG0 auxiliary caps
    # the full O(h^3)
    assert rate > 2.2, errs
    assert errs[1]["l2"] < 5e-3, errs


def test_interface_elasticity_iteration_scaling():
    """S5 outer-iteration growth under the interface-Fourier coarse space
    (s5_fourier_modes, K auto-scaled ~n/4): the flat preconditioner's
    transmission modes contract at 1-O(kh), so without the coarse space
    outer iterations grow ~2.3x per grid doubling (15/34/80 measured at
    n=32/64/128, round 3); with it the growth factor must stay <= 1.5
    small on this doubling (10/13 -> 16/20 measured — BiCGStab iteration
    counts wobble ~20% with summation order, so the pin is on absolute
    counts; full record through n=256 in docs/s5_preconditioner.md)."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "s5_data_scaling",
        os.path.join(
            os.path.dirname(__file__), "..", "demo", "interface-elasticity",
            "data.py",
        ),
    )
    D = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(D)

    iters = {}
    for n in (32, 64):
        g = pf.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), "triangle")
        s = InterfaceElasticity(
            g, mode="bg", E_in=D.E_in, nu_in=D.nu_in,
            E_out=D.E_out, nu_out=D.nu_out,
        )
        s.setup(D.levelset, D.source_term, D.exact_solution)
        s.assemble()
        vc = s.lattice_preconditioner(coupled=False)
        r = s.solve(method="bicgstab", tol=1e-8, maxiter=200, precond=vc)
        assert r.converged, (n, r.residual)
        iters[n] = r.iterations
    # Caps sit well above the measured 10-16/13-20 band: BiCGStab counts
    # wobble ~20% with summation order (CLAUDE.md), so leave real headroom.
    # The guard is against the round-3 rigid-only space (15/34).
    assert iters[32] <= 20, iters
    assert iters[64] <= 28, iters
