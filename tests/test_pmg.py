"""p-multigrid (phifem_tpu.pmg): transfers + on-device degree>=2 solves.

The reference LU-solves every degree (PETSc/MUMPS,
``demo/weak-dirichlet/flower/main.py:45``); p-MG is the on-device
replacement that retires the host-SuperLU detour for degree>=2 systems."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import phifem_tpu as pf
from phifem_tpu.models import WeakDirichletPoisson
from phifem_tpu.pmg import _apply_P, _apply_PT, p_transfer
from phifem_tpu.spaces import Space, interpolate


@pytest.mark.parametrize("cell", ["triangle", "quadrilateral"])
@pytest.mark.parametrize("degree", [2, 3])
def test_p_transfer_reproduces_linears(cell, degree):
    """P interpolates the low space into the high nodal points: linear
    (P1-exact) functions must transfer exactly, and P^T must be the exact
    adjoint of P."""
    g = pf.Grid(7, 5, ((-1.0, -0.5), (2.0, 1.5)), cell)
    hi, lo = Space.lagrange(g, degree), Space.lagrange(g, 1)
    idx, wts = p_transfer(hi, lo)
    f = lambda x: 0.75 * x[..., 0] - 1.25 * x[..., 1] + 0.5
    v_lo = interpolate(f, lo).data
    v_hi = _apply_P(jnp.asarray(idx), jnp.asarray(wts), v_lo)
    np.testing.assert_allclose(
        np.asarray(v_hi), np.asarray(interpolate(f, hi).data), atol=1e-12
    )
    # adjoint identity <P v, w> == <v, P^T w> on random vectors
    rng = np.random.default_rng(3)
    v = jnp.asarray(rng.standard_normal(lo.num_scalar_dofs))
    w = jnp.asarray(rng.standard_normal(hi.num_scalar_dofs))
    lhs = float(jnp.vdot(_apply_P(jnp.asarray(idx), jnp.asarray(wts), v), w))
    rhs = float(
        jnp.vdot(v, _apply_PT(jnp.asarray(idx), jnp.asarray(wts), lo.num_scalar_dofs, w))
    )
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


def test_pmg_degree2_exactness():
    """S1 at P2 with the p-MG preconditioner reproduces a quadratic
    solution to solver tolerance on device (no host factorization)."""
    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 1.0
    uex = lambda x: 1.0 + x[..., 0] - 0.5 * x[..., 1] + x[..., 0] * x[..., 1]
    fz = lambda x: jnp.zeros(x.shape[:-1])
    g = pf.Grid(12, 12, ((-1.5, -1.5), (1.5, 1.5)), "triangle")
    s = WeakDirichletPoisson(g, mode="bg", primal_degree=2, levelset_degree=2)
    s.setup(phi, fz, u_D=uex)
    s.assemble()
    vc = s.p_multigrid_preconditioner()
    r = s.solve(method="fgmres", tol=1e-11, maxiter=200, precond=vc)
    assert r.converged, r.residual
    e = s.l2_h1_errors(s.u_h, uex, region=(1, 2))
    assert e["l2"] < 1e-9 and e["h10"] < 1e-8, e


def test_pmg_beats_jacobi_floor():
    """The documented degree-3 Jacobi-Krylov floor (~1e-6 relative
    residual) is below what p-MG fgmres reaches on the same system."""
    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 1.0
    uex = lambda x: jnp.cos(x[..., 0]) * jnp.exp(x[..., 1] / 2.0)

    def f(x):
        u = lambda p: jnp.cos(p[0]) * jnp.exp(p[1] / 2.0)
        H = jax.vmap(jax.hessian(u))(x)
        return -jnp.trace(H, axis1=-2, axis2=-1)

    g = pf.Grid(10, 10, ((-1.5, -1.5), (1.5, 1.5)), "triangle")
    s = WeakDirichletPoisson(g, mode="bg", primal_degree=3, levelset_degree=3)
    s.setup(phi, f, u_D=uex)
    s.assemble()
    vc = s.p_multigrid_preconditioner()
    r = s.solve(method="fgmres", tol=1e-10, maxiter=200, precond=vc)
    assert r.converged and r.residual < 1e-9, (r.iterations, r.residual)
