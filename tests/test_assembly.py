"""Assembly engine checks: exact integrals, operator identities, and a full
standard-FEM Poisson solve (machinery shared by all phi-FEM schemes)."""

import jax.numpy as jnp
import numpy as np
import pytest

import phifem_tpu as pf
from phifem_tpu.assembly import (
    BoundaryTerm,
    CellTerm,
    FacetTerm,
    System,
    assemble_operator,
    assemble_scalar,
    assemble_vector,
)
from phifem_tpu.measures import one_sided_facets
from phifem_tpu.solvers import DirichletBC, solve
from phifem_tpu.spaces import boundary_dof_mask

BOX = ((0.0, 0.0), (2.0, 1.0))


def mass(u, v, d, x, ctx):
    return u["u"].val * v["u"].val


def stiffness(u, v, d, x, ctx):
    return jnp.dot(u["u"].grad, v["u"].grad)


@pytest.mark.parametrize("cell_type", ["triangle", "quadrilateral"])
@pytest.mark.parametrize("deg", [1, 2])
def test_mass_matrix_total(cell_type, deg):
    g = pf.Grid(4, 3, BOX, cell_type)
    sys = System({"u": pf.Space.lagrange(g, deg)})
    op = assemble_operator(
        g_sys := sys,
        g,
        cell_terms=[(CellTerm(mass, None, degree=2 * deg, uniform=True), {})],
    )
    ones = {"u": jnp.ones(sys.fields["u"].dof_shape)}
    area = float(jnp.sum(op.matvec(ones)["u"]))
    assert np.isclose(area, 2.0, rtol=1e-12)  # 1^T M 1 = |Omega|


@pytest.mark.parametrize("cell_type", ["triangle", "quadrilateral"])
@pytest.mark.parametrize("deg", [1, 2])
def test_stiffness_annihilates_linears(cell_type, deg):
    g = pf.Grid(5, 4, BOX, cell_type)
    sp = pf.Space.lagrange(g, deg)
    sys = System({"u": sp})
    op = assemble_operator(
        sys, g, cell_terms=[(CellTerm(stiffness, None, degree=2 * deg, uniform=True), {})]
    )
    lin = pf.interpolate(lambda x: 3.0 * x[..., 0] - 2.0 * x[..., 1] + 1.0, sp)
    y = op.matvec({"u": lin.data})
    # stiffness * affine function: interior rows vanish (boundary rows carry
    # the Neumann flux), so test the energy u^T A u = int |grad u|^2 = 13*|O|
    energy = float(jnp.vdot(lin.data, y["u"]))
    assert np.isclose(energy, 13.0 * 2.0, rtol=1e-12)


@pytest.mark.parametrize("cell_type", ["triangle", "quadrilateral"])
def test_ghost_jump_vanishes_on_smooth_gradient(cell_type):
    # jump of grad(u) across facets is zero for a globally affine u
    g = pf.Grid(4, 4, BOX, cell_type)
    sp = pf.Space.lagrange(g, 1)
    sys = System({"u": sp})

    def ghost(u0, u1, v0, v1, d0, d1, x, n, ctx):
        ju = jnp.dot(u0["u"].grad - u1["u"].grad, n)
        jv = jnp.dot(v0["u"].grad - v1["u"].grad, n)
        return ctx.h * ju * jv

    ftags = jnp.ones(g.num_facets, jnp.int8)  # all facets "region 1"
    op = assemble_operator(
        sys, g, facet_terms=[(FacetTerm(ghost, region=(1,), npts=2), {})],
        facet_tags=ftags,
    )
    lin = pf.interpolate(lambda x: 3.0 * x[..., 0] - 2.0 * x[..., 1], sp)
    y = op.matvec({"u": lin.data})
    assert float(jnp.max(jnp.abs(y["u"]))) < 1e-12
    # and a kinked function produces nonzero jumps
    kink = pf.interpolate(lambda x: jnp.abs(x[..., 0] - 1.0), sp)
    yk = op.matvec({"u": kink.data})
    assert float(jnp.max(jnp.abs(yk["u"]))) > 1e-10


@pytest.mark.parametrize("cell_type", ["triangle", "quadrilateral"])
def test_boundary_functional_divergence_theorem(cell_type):
    # int_dOmega x.n ds = 2 |Omega| over the full box boundary
    g = pf.Grid(6, 5, BOX, cell_type)
    ct = np.ones(g.num_cells, np.int8)
    bfacets = np.where(np.asarray(g.boundary_facet_mask))[0]
    fl = one_sided_facets(g, bfacets, ct, (1,))
    val = assemble_scalar(
        g,
        boundary_terms=[
            (BoundaryTerm(lambda d, x, n, ctx: jnp.dot(x, n), fl, npts=2), {})
        ],
    )
    assert np.isclose(float(val), 2.0 * 2.0, rtol=1e-12)


def _poisson_error(cell_type, n, method):
    g = pf.Grid(n, n, ((0.0, 0.0), (1.0, 1.0)), cell_type)
    sp = pf.Space.lagrange(g, 1)
    sys = System({"u": sp})

    uex = lambda x: jnp.sin(jnp.pi * x[..., 0]) * jnp.sin(jnp.pi * x[..., 1])
    f = lambda x: 2.0 * jnp.pi**2 * uex(x)
    f_h = pf.interpolate(f, sp)

    op = assemble_operator(
        sys, g, cell_terms=[(CellTerm(stiffness, None, degree=2, uniform=True), {})]
    )
    b = assemble_vector(
        sys,
        g,
        cell_terms=[
            (
                CellTerm(lambda v, d, x, ctx: d["f"].val * v["u"].val, None, degree=3),
                {"f": f_h},
            )
        ],
    )
    bc = DirichletBC("u", boundary_dof_mask(sp), jnp.zeros(sp.dof_shape))
    res = solve(op, b, bcs=(bc,), method=method, tol=1e-12)
    assert res.converged, res.residual
    uh = pf.Function(sp, res.x["u"])
    # L2 error via fine quadrature functional
    err = assemble_scalar(
        g,
        cell_terms=[
            (
                CellTerm(
                    lambda d, x, ctx: (d["uh"].val - uex(x)) ** 2, None, degree=6
                ),
                {"uh": uh},
            )
        ],
    )
    return float(jnp.sqrt(err))


@pytest.mark.parametrize("cell_type", ["triangle", "quadrilateral"])
def test_poisson_dirichlet_convergence(cell_type):
    e1 = _poisson_error(cell_type, 8, "cg")
    e2 = _poisson_error(cell_type, 16, "cg")
    rate = np.log2(e1 / e2)
    assert 1.7 < rate < 2.4, (e1, e2, rate)


def test_cg_matches_dense():
    e_cg = _poisson_error("triangle", 6, "cg")
    e_dense = _poisson_error("triangle", 6, "dense")
    assert np.isclose(e_cg, e_dense, rtol=1e-6)


def test_sparse_lu_matches_dense():
    """method='sparse' (host SuperLU, the reference's MUMPS-LU analogue)
    reproduces the dense lstsq path on a BC'd system to direct-solver
    accuracy, and its cached factorization survives repeated solves."""
    e_sp = _poisson_error("triangle", 10, "sparse")
    e_dn = _poisson_error("triangle", 10, "dense")
    assert np.isclose(e_sp, e_dn, rtol=1e-9), (e_sp, e_dn)


def test_sparse_lu_phifem_system():
    """Sparse LU on a real phi-FEM S1 system (penalty + ghost + one-sided
    boundary batches, mixed u/p fields): matches dense entrywise and the
    factorization cache is invalidated by reassemble()."""
    from phifem_tpu.models import WeakDirichletPoisson

    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49
    uex = lambda x: jnp.cos(x[..., 0]) * jnp.sin(x[..., 1])
    f = lambda x: 2.0 * uex(x)
    g = pf.Grid(12, 12, ((-1.0, -1.0), (1.0, 1.0)), "triangle")
    s = WeakDirichletPoisson(g, mode="bg")
    s.setup(phi, f, u_D=uex)
    s.assemble()
    rd = solve(s.op, s.b, method="dense")
    rs = solve(s.op, s.b, method="sparse")
    assert rs.residual < 1e-10, rs.residual
    for k in rd.x:
        du = np.abs(np.asarray(rd.x[k]) - np.asarray(rs.x[k])).max()
        sc = max(np.abs(np.asarray(rd.x[k])).max(), 1e-300)
        assert du < 1e-8 * sc, (k, du)
    # cache: second solve reuses the LU object
    lu1 = s.op._splu_cache[1]
    solve(s.op, s.b, method="sparse")
    assert s.op._splu_cache[1] is lu1
    # reassemble with scaled data invalidates it
    s.phi_h.data = 2.0 * s.phi_h.data
    s.op.reassemble()
    r2 = solve(s.op, s.b, method="sparse")
    assert s.op._splu_cache[1] is not lu1
    assert r2.residual < 1e-10


def test_stencil_rhs_matches_generic():
    """The data-linear vertex-stencil RHS path (assembly._try_stencil_rhs)
    must reproduce the generic gathered assembly exactly — same local
    matrices, different evaluation order (the stencil path keeps per-cell
    tables off the device at n=3200-class grids)."""
    import phifem_tpu as pf
    from phifem_tpu.assembly import CellTerm, System, assemble_vector
    from phifem_tpu.spaces import Space, interpolate

    for ct in (pf.CellType.triangle, pf.CellType.quadrilateral):
        g = pf.Grid(9, 7, ((-1.0, -1.0), (1.0, 1.0)), ct)
        V = Space.lagrange(g, 1)
        system = System({"u": V, "p": V})
        f_h = interpolate(lambda x: jnp.sin(x[..., 0]) + x[..., 1] ** 2, V)
        tags = np.zeros(g.num_cells, np.int8)
        tags[: g.num_cells // 2] = 1
        tags[g.num_cells // 2 :] = 2

        def rhs_bulk(v, d, x, ctx):
            return d["f"].val * v["u"].val

        b_sten = assemble_vector(
            system, g,
            cell_terms=[(CellTerm(rhs_bulk, (1,), degree=3, uniform=True), {"f": f_h})],
            cell_tags=tags,
        )
        b_gen = assemble_vector(
            system, g,
            cell_terms=[(CellTerm(rhs_bulk, (1,), degree=3), {"f": f_h})],
            cell_tags=tags,
        )
        du = np.abs(np.asarray(b_sten["u"]) - np.asarray(b_gen["u"])).max()
        scale = np.abs(np.asarray(b_gen["u"])).max()
        assert du < 1e-13 * scale, (ct, du)
        assert np.asarray(b_sten["p"]).max() == 0.0

        # a NONLINEAR-in-data term mis-flagged uniform must fall back to
        # the generic path (linearity verification), not assemble wrong
        def rhs_sq(v, d, x, ctx):
            return d["f"].val ** 2 * v["u"].val

        b_s = assemble_vector(
            system, g,
            cell_terms=[(CellTerm(rhs_sq, (1,), degree=3, uniform=True), {"f": f_h})],
            cell_tags=tags,
        )
        b_g = assemble_vector(
            system, g,
            cell_terms=[(CellTerm(rhs_sq, (1,), degree=3), {"f": f_h})],
            cell_tags=tags,
        )
        dsq = np.abs(np.asarray(b_s["u"]) - np.asarray(b_g["u"])).max()
        assert dsq < 1e-13 * np.abs(np.asarray(b_g["u"])).max(), (ct, dsq)


@pytest.mark.parametrize("cell_type", ["triangle", "quadrilateral"])
def test_maskless_stencil_matches_masked(cell_type):
    """A term covering every cell builds ``masks=None``; that maskless
    stencil must match the same matrices with explicit all-ones masks and
    the generic gathered batch, lattice-boundary rows and columns
    included."""
    from phifem_tpu.ops.stencil import StencilCellBatch

    g = pf.Grid(20, 12, ((-1.0, -1.0), (1.0, 1.0)), cell_type)
    sp = pf.Space.lagrange(g, 1)
    sys_ = System({"u": sp})

    def bulk(u, v, d, x, ctx):
        return jnp.dot(u["u"].grad, v["u"].grad) + u["u"].val * v["u"].val

    op = assemble_operator(
        sys_, g, cell_terms=[(CellTerm(bulk, None, degree=2, uniform=True), {})]
    )
    batch = op.batches[0]
    assert isinstance(batch, StencilCellBatch)
    assert batch.masks is None

    x = jnp.asarray(np.random.default_rng(7).normal(size=sp.dof_shape))
    y = np.asarray(op.matvec({"u": x})["u"])
    no = 2 if g.is_simplex else 1
    masked = StencilCellBatch(g, "u", batch.matrices, jnp.ones((no, g.ny, g.nx)))
    y_masked = masked.matvec_into({"u": x}, {"u": jnp.zeros_like(x)})["u"]
    generic = assemble_operator(
        sys_, g, cell_terms=[(CellTerm(bulk, None, degree=2), {})]
    )
    assert not isinstance(generic.batches[0], StencilCellBatch)
    y_generic = generic.matvec({"u": x})["u"]
    scale = np.abs(y).max()
    assert np.abs(y - np.asarray(y_masked)).max() < 1e-13 * scale
    assert np.abs(y - np.asarray(y_generic)).max() < 1e-13 * scale


def test_sparse_solve_bordered_singular():
    """``solve(method="sparse", deflate=...)`` handles an EXACTLY singular
    system — pure-Neumann stiffness, constant null vector — through the
    bordered SuperLU system [A Q; Q' 0] (the sparse analogue of the
    reference's MUMPS null-pivot icntl 24/25; the dense path's lstsq).
    The solution must match the dense minimum-norm one and carry the
    zero-null gauge (zero mean)."""
    g = pf.Grid(6, 5, BOX, "triangle")
    sp = pf.Space.lagrange(g, 1)
    sys = System({"u": sp})
    op = assemble_operator(
        sys, g,
        cell_terms=[(CellTerm(stiffness, None, degree=2, uniform=True), {})],
    )
    # compatible RHS: int f = 0 (f odd around the box center)
    f = pf.interpolate(lambda x: x[..., 0] - 1.0, sp)
    M = assemble_operator(
        sys, g, cell_terms=[(CellTerm(mass, None, degree=2, uniform=True), {})]
    )
    b = M.matvec({"u": f.data})
    const = {"u": jnp.ones(sp.dof_shape)}
    r_sp = solve(op, b, method="sparse", deflate=(const,))
    r_de = solve(op, b, method="dense")
    assert r_sp.residual < 1e-10, r_sp.residual
    x_sp = np.asarray(r_sp.x["u"]).reshape(-1)
    x_de = np.asarray(r_de.x["u"]).reshape(-1)
    # zero-null gauge: zero component along the constant
    assert abs(x_sp.sum()) < 1e-8 * np.linalg.norm(x_sp) * len(x_sp) ** 0.5
    # same solution up to the constant gauge
    d = x_sp - x_de
    d -= d.mean()
    assert np.linalg.norm(d) < 1e-8 * np.linalg.norm(x_de), np.linalg.norm(d)
