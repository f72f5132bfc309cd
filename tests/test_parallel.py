"""SPMD parallelism: the halo-exchange matvec must equal the single-device
operator exactly, and the sharded solve must match the dense solution — on
awkward (non-divisible) grid sizes (conftest forces an 8-device CPU mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import phifem_tpu as pf
from phifem_tpu.models import NeumannPoisson, WeakDirichletPoisson
from phifem_tpu.parallel import (
    HaloOperator,
    halo_solve,
    make_mesh,
    shard_vector,
    sharded_solve,
)
from phifem_tpu.solvers import masked_operator, solve

multidevice = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs a multi-device mesh"
)


def _problem(n):
    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49
    uex = lambda x: jnp.cos(x[..., 0]) * jnp.sin(x[..., 1])
    f = lambda x: 2.0 * uex(x)
    g = pf.Grid(n, n, ((-1.0, -1.0), (1.0, 1.0)), "triangle")
    s = WeakDirichletPoisson(g, mode="bg")
    s.setup(phi, f, u_D=uex)
    s.assemble()
    return s


@multidevice
@pytest.mark.parametrize("n", [15, 33])  # 33 -> 34 rows: NOT divisible by 8
def test_halo_matvec_matches_masked_operator(n):
    s = _problem(n)
    mesh = make_mesh(8)
    H = HaloOperator(s.op, s.grid, mesh)
    mv_ref, diag, active = masked_operator(s.op)
    rng = np.random.default_rng(0)
    x = {k: jnp.asarray(rng.normal(size=v.shape)) for k, v in s.b.items()}
    y_ref = mv_ref(x)
    y_halo = H.unpad(H.matvec(H.pad(x)))
    for k in y_ref:
        err = float(jnp.max(jnp.abs(y_ref[k] - y_halo[k])))
        sc = float(jnp.max(jnp.abs(y_ref[k])))
        assert err < 1e-10 * max(sc, 1.0), (k, err, sc)
    # the padded vectors really are distributed across the mesh
    xp = H.pad(x)
    assert len(xp["u"].sharding.device_set) == 8


@multidevice
def test_sharded_solve_matches_dense_nondivisible():
    s = _problem(33)
    mesh = make_mesh(8)
    x_sh, rel = sharded_solve(
        s.op, s.b, mesh, method="bicgstab", tol=1e-10, maxiter=4000
    )
    assert rel < 1e-8, rel
    ref = solve(s.op, s.b, method="dense")
    du = float(jnp.max(jnp.abs(x_sh["u"] - ref.x["u"])))
    scale = float(jnp.max(jnp.abs(ref.x["u"])))
    assert du < 1e-6 * max(scale, 1.0), du


@multidevice
def test_halo_solve_mixed_dg0_system():
    """S3 Neumann: P1 x vector-P1 x DG0 mixed system through the slab
    decomposition (DG0 cell-row layout + vector fields)."""
    import sys, os

    sys.path.insert(
        0,
        os.path.join(os.path.dirname(__file__), "..", "demo", "neumann", "square"),
    )
    from data import levelset, neumann_data, source_term  # noqa: E402

    g = pf.Grid(24, 24, ((-1.0, -1.0), (1.0, 1.0)), "quadrilateral")
    s = NeumannPoisson(g, mode="bg")
    s.setup(levelset, source_term, neumann_data)
    s.assemble()
    mesh = make_mesh(8)
    x_sh, rel = halo_solve(
        s.op, g, s.b, mesh, bcs=getattr(s, "bcs", ()),
        method="bicgstab", tol=1e-10, maxiter=4000,
    )
    assert rel < 1e-7, rel
    ref = solve(s.op, s.b, method="dense")
    for k in x_sh:
        du = float(jnp.max(jnp.abs(x_sh[k] - ref.x[k])))
        scale = float(jnp.max(jnp.abs(ref.x[k])))
        assert du < 1e-5 * max(scale, 1.0), (k, du, scale)


@multidevice
def test_dryrun_multichip_entry():
    import __graft_entry__ as ge

    ge.dryrun_multichip(len(jax.devices()))


@multidevice
def test_sharded_lattice_mg_matches_single_device():
    """Distributed lattice MG-CG (shard_map row slabs, ppermute halos,
    psum dots) must reproduce the single-device ops.lattice solve on the
    north-star Poisson problem — including a replicated coarse tail and a
    row count (n+1 = 49) NOT divisible by the 8-device mesh."""
    from phifem_tpu.models import BoxPoisson
    from phifem_tpu.parallel import build_sharded_lattice_mg, sharded_lattice_solve
    from phifem_tpu.parallel.sharding import make_mesh

    n = 48
    g = pf.Grid(n, n, ((0.0, 0.0), (1.0, 1.0)), "triangle")
    uex = lambda x: jnp.sin(jnp.pi * x[..., 0]) * jnp.sin(jnp.pi * x[..., 1])
    f = lambda x: 2.0 * jnp.pi**2 * uex(x)
    s = BoxPoisson(g).setup(f)
    s.assemble()
    r_ref = s.solve_lattice(tol=1e-11, maxiter=60)

    from phifem_tpu.ops.lattice import vertex_stencil_weights
    from phifem_tpu.ops.stencil import _TRI_OFFS

    batch = s.op.batches[0]
    w = vertex_stencil_weights(np.asarray(batch.matrices), _TRI_OFFS)
    mesh = make_mesh(8)
    mg = build_sharded_lattice_mg(n, n, w, mesh, min_n=12, replicate_rows=4)
    assert len(mg.levels) >= 2, "expected at least one distributed coarse level"
    b2d = s.b["u"].reshape(n + 1, n + 1)
    u2d, rel, it = sharded_lattice_solve(mg, mesh, b2d, tol=1e-11, maxiter=60)
    assert rel < 1e-10, rel
    du = np.abs(np.asarray(u2d.reshape(-1)) - np.asarray(r_ref.x["u"])).max()
    scale = np.abs(np.asarray(r_ref.x["u"])).max()
    assert du < 1e-8 * max(scale, 1.0), du


@multidevice
def test_sharded_solve_p2():
    """Degree-2 S1 through the GSPMD-constraint fallback (halo.py is
    P1/DG0-only): the advertised P2 capability needs a multi-device
    path too."""
    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49
    uex = lambda x: jnp.cos(x[..., 0]) * jnp.sin(x[..., 1])
    f = lambda x: 2.0 * uex(x)
    g = pf.Grid(17, 17, ((-1.0, -1.0), (1.0, 1.0)), "triangle")
    s = WeakDirichletPoisson(g, mode="bg", primal_degree=2, levelset_degree=2)
    s.setup(phi, f, u_D=uex)
    s.assemble()
    mesh = make_mesh(8)
    x_sh, rel = sharded_solve(
        s.op, s.b, mesh, method="bicgstab", tol=1e-10, maxiter=4000
    )
    assert rel < 1e-8, rel
    ref = solve(s.op, s.b, method="dense")
    du = float(jnp.max(jnp.abs(x_sh["u"] - ref.x["u"])))
    scale = float(jnp.max(jnp.abs(ref.x["u"])))
    assert du < 1e-6 * max(scale, 1.0), du


@multidevice
def test_sharded_lattice3_matches_single_device():
    """Distributed 3D MG-CG (z-plane slabs, 1-plane ppermute halos,
    psum dots, agglomerated tail) equals the single-device lattice3
    solve — on a z size NOT divisible by 8 (D = 25 planes)."""
    from phifem_tpu.grid3 import Grid3
    from phifem_tpu.models import BoxPoisson3
    from phifem_tpu.parallel import (
        build_sharded_lattice3_mg,
        make_mesh,
        sharded_lattice3_solve,
    )

    n = 24
    g = Grid3(n, n, n, ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)))
    uex = lambda x: (
        jnp.sin(jnp.pi * x[..., 0])
        * jnp.sin(jnp.pi * x[..., 1])
        * jnp.sin(jnp.pi * x[..., 2])
    )
    f = lambda x: 3.0 * jnp.pi**2 * uex(x)
    s = BoxPoisson3(g).setup(f)
    s.assemble()
    r_ref = s.solve_lattice(tol=1e-11, maxiter=40)
    assert r_ref.converged

    mesh = make_mesh(8)
    mg = build_sharded_lattice3_mg(
        n, n, n, g.spacing, mesh, min_n=4, replicate_planes=2,
        dtype=jnp.float64,
    )
    assert len(mg.levels) >= 2, "want at least 2 distributed levels"
    u3, rel, it = sharded_lattice3_solve(
        mg, mesh, s.b_lat, tol=1e-11, maxiter=40
    )
    assert rel < 1e-10, rel
    du = float(jnp.abs(u3 - s.u_lat).max())
    scale = float(jnp.abs(s.u_lat).max())
    assert du < 1e-8 * max(scale, 1.0), du


# ------------------------------------------------- unstructured (imported)
def _umesh_problem(n, amp=0.25):
    """S1 on a genuinely irregular (perturbed) imported mesh."""
    from phifem_tpu.models import WeakDirichletPoissonU
    from phifem_tpu.umesh import UMesh

    g = pf.Grid(n, n, ((-1.0, -1.0), (1.0, 1.0)), "triangle")
    um, _ = UMesh.from_grid(g)
    verts = um.verts.copy()
    rng = np.random.default_rng(3)
    h = 2.0 / n
    interior = (
        (np.abs(np.abs(verts[:, 0]) - 1.0) > 1e-12)
        & (np.abs(np.abs(verts[:, 1]) - 1.0) > 1e-12)
    )
    verts[interior] += amp * h * (rng.random((int(interior.sum()), 2)) - 0.5)
    um = type(um)(verts, um.cells)

    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49
    uex = lambda x: jnp.cos(x[..., 0]) * jnp.sin(x[..., 1])
    f = lambda x: 2.0 * uex(x)
    s = WeakDirichletPoissonU(um, mode="bg")
    s.setup(phi, f, u_D=uex)
    s.assemble()
    return s


@multidevice
def test_element_sharded_matvec_matches_masked_operator():
    """The element-distributed matvec (entity batches sharded over the
    mesh, one psum) equals the single-device masked operator exactly on an
    irregular imported mesh whose entity counts do NOT divide 8."""
    from phifem_tpu.parallel import ElementShardedOperator, make_mesh

    s = _umesh_problem(13)
    mesh = make_mesh(8)
    E = ElementShardedOperator(s.op, mesh)
    mv_ref, diag, active = masked_operator(s.op)
    rng = np.random.default_rng(0)
    x = {k: jnp.asarray(rng.normal(size=v.shape)) for k, v in s.b.items()}
    y_ref = mv_ref(x)
    from jax.sharding import NamedSharding, PartitionSpec

    y_sh = E.matvec(jax.device_put(x, NamedSharding(mesh, PartitionSpec())))
    for k in y_ref:
        err = float(jnp.max(jnp.abs(y_ref[k] - y_sh[k])))
        sc = float(jnp.max(jnp.abs(y_ref[k])))
        assert err < 1e-10 * max(sc, 1.0), (k, err, sc)
    # batch tables really are distributed
    assert len(E._mats[0].sharding.device_set) == 8 or len(
        E._segdofs[0][0].sharding.device_set
    ) == 8


@multidevice
def test_element_sharded_solve_matches_dense():
    from phifem_tpu.parallel import element_sharded_solve, make_mesh

    s = _umesh_problem(13)
    mesh = make_mesh(8)
    x_sh, rel, it = element_sharded_solve(
        s.op, s.b, mesh, method="bicgstab", tol=1e-11, maxiter=4000
    )
    assert rel < 1e-9, rel
    assert it > 0
    ref = solve(s.op, s.b, method="dense")
    for k in x_sh:
        du = float(jnp.max(jnp.abs(x_sh[k] - ref.x[k])))
        scale = float(jnp.max(jnp.abs(ref.x[k])))
        assert du < 1e-6 * max(scale, 1.0), (k, du)


@multidevice
def test_element_sharded_solve_s5_deflated():
    """S5 on an imported mesh through the distributed path: singular
    system + rigid-mode deflation + Dirichlet lifting, all sharded."""
    from phifem_tpu.models import InterfaceElasticityU
    from phifem_tpu.parallel import element_sharded_solve, make_mesh
    from phifem_tpu.umesh import UMesh

    n = 10
    g = pf.Grid(n, n, ((-1.0, -1.0), (1.0, 1.0)), "triangle")
    um, _ = UMesh.from_grid(g)
    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49
    uv = lambda x: jnp.stack(
        [jnp.sin(x[..., 0]) * jnp.cos(x[..., 1]), x[..., 0] * x[..., 1]], -1
    )
    fv = lambda x: jnp.stack(
        [jnp.cos(x[..., 0]) + x[..., 1], jnp.sin(x[..., 1]) - x[..., 0]], -1
    )
    s = InterfaceElasticityU(um, mode="bg", E_in=1.0, E_out=0.1)
    s.setup(phi, fv, uv)
    s.assemble()
    x_sh, rel, it = element_sharded_solve(
        s.op, s.b, mesh=make_mesh(8), bcs=s.bcs,
        method="bicgstab", tol=1e-9, maxiter=2000,
        deflate=s.rigid_modes(),
    )
    assert rel < 1e-7, rel
    # compare against the single-device deflated solve (same gauge)
    r_ref = s.solve(method="bicgstab", tol=1e-9, maxiter=2000)
    assert r_ref.converged
    for k in ("u_in", "u_out"):
        du = float(jnp.max(jnp.abs(x_sh[k] - r_ref.x[k])))
        scale = max(float(jnp.max(jnp.abs(r_ref.x[k]))), 1.0)
        assert du < 1e-5 * scale, (k, du)


@multidevice
def test_element_sharded_refresh_after_reassemble():
    """Distributed assembly: after op.reassemble() with new level-set data,
    ElementShardedOperator.refresh() repartitions the rebuilt element
    matrices and the distributed matvec tracks the single-device one."""
    from phifem_tpu.parallel import ElementShardedOperator, make_mesh

    s = _umesh_problem(11)
    mesh = make_mesh(8)
    E = ElementShardedOperator(s.op, mesh)
    s.phi_h.data = 1.7 * s.phi_h.data
    s.op.reassemble()
    E.refresh()
    mv_ref, diag, active = masked_operator(s.op)
    rng = np.random.default_rng(1)
    x = {k: jnp.asarray(rng.normal(size=v.shape)) for k, v in s.b.items()}
    y_ref = mv_ref(x)
    y_sh = E.matvec(x)
    for k in y_ref:
        err = float(jnp.max(jnp.abs(y_ref[k] - y_sh[k])))
        sc = float(jnp.max(jnp.abs(y_ref[k])))
        assert err < 1e-10 * max(sc, 1.0), (k, err, sc)


# ---------------------------------------------------- partitioned DoF path
@multidevice
def test_partitioned_matvec_matches_masked_operator():
    """The owner-block partitioned matvec (PartitionedUOperator: ghost
    all_to_all exchange + local element work + reverse exchange) equals
    the single-device masked operator exactly on an irregular imported
    mesh with entity/DoF counts that do NOT divide 8."""
    from phifem_tpu.parallel import PartitionedUOperator, make_mesh

    s = _umesh_problem(13)
    mesh = make_mesh(8)
    E = PartitionedUOperator(s.op, mesh)
    mv_ref, diag, active = masked_operator(s.op)
    rng = np.random.default_rng(0)
    x = {k: jnp.asarray(rng.normal(size=v.shape)) for k, v in s.b.items()}
    y_ref = mv_ref(x)
    y = E.unpartition(E.matvec(E.partition(x)))
    for k in y:
        np.testing.assert_allclose(
            np.asarray(y[k]), np.asarray(y_ref[k]), rtol=1e-12, atol=1e-12
        )
    # per-device vector memory scales ~1/n_devices: each Krylov-vector
    # shard is the owner chunk, not a replica
    xp = E.partition(x)
    for k, v in xp.items():
        shard = v.addressable_shards[0].data
        assert shard.shape[0] == 1 and shard.shape[1] == E.chunk[k]
        assert len(v.addressable_shards) == 8


@multidevice
def test_partitioned_solve_matches_dense():
    from phifem_tpu.parallel import make_mesh, partitioned_solve

    s = _umesh_problem(13)
    mesh = make_mesh(8)
    x_sh, rel, it = partitioned_solve(
        s.op, s.b, mesh, method="bicgstab", tol=1e-11, maxiter=4000
    )
    assert rel < 1e-9, rel
    assert it > 0
    r_d = solve(s.op, s.b, method="dense")
    for k, v in x_sh.items():
        scale = float(jnp.max(jnp.abs(r_d.x[k])))
        du = float(jnp.max(jnp.abs(v - r_d.x[k])))
        assert du < 1e-6 * max(scale, 1.0), (k, du)


@multidevice
def test_partitioned_solve_s5_deflated():
    """S5 through the partitioned path: singular system + rigid-mode
    deflation + Dirichlet lifting, vectors owner-block sharded."""
    from phifem_tpu.models import InterfaceElasticityU
    from phifem_tpu.parallel import make_mesh, partitioned_solve
    from phifem_tpu.umesh import UMesh

    n = 10
    g = pf.Grid(n, n, ((-1.0, -1.0), (1.0, 1.0)), "triangle")
    um, _ = UMesh.from_grid(g)
    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49
    uv = lambda x: jnp.stack(
        [jnp.cos(x[..., 0]), jnp.sin(x[..., 1])], axis=-1
    )
    fv = lambda x: jnp.stack(
        [jnp.cos(x[..., 0]), jnp.sin(x[..., 1])], axis=-1
    )
    s = InterfaceElasticityU(um, mode="bg", E_in=1.0, E_out=0.1)
    s.setup(phi, fv, uv)
    s.assemble()
    x_sh, rel, it = partitioned_solve(
        s.op, s.b, mesh=make_mesh(8), bcs=s.bcs,
        method="bicgstab", tol=1e-9, maxiter=2000,
        deflate=s.rigid_modes(),
    )
    # deflated BiCGStab floors a little above tol on this singular system
    # (the floor moves with reduction order; psum-tree vs replicated sums)
    assert rel < 1e-6, rel
    x_ref, rel_ref, _ = __import__("phifem_tpu").parallel.element_sharded_solve(
        s.op, s.b, mesh=make_mesh(8), bcs=s.bcs,
        method="bicgstab", tol=1e-9, maxiter=2000, deflate=s.rigid_modes(),
    )
    for k, v in x_sh.items():
        scale = max(float(jnp.max(jnp.abs(x_ref[k]))), 1.0)
        du = float(jnp.max(jnp.abs(v - x_ref[k])))
        assert du < 1e-5 * scale, (k, du)


@multidevice
def test_partitioned_refresh_after_reassemble():
    from phifem_tpu.parallel import PartitionedUOperator, make_mesh

    s = _umesh_problem(11)
    mesh = make_mesh(8)
    E = PartitionedUOperator(s.op, mesh)
    s.phi_h.data = 1.7 * s.phi_h.data
    s.op.reassemble()
    E.refresh()
    mv_ref, diag, active = masked_operator(s.op)
    rng = np.random.default_rng(1)
    x = {k: jnp.asarray(rng.normal(size=v.shape)) for k, v in s.b.items()}
    y_ref = mv_ref(x)
    y = E.unpartition(E.matvec(E.partition(x)))
    for k in y:
        np.testing.assert_allclose(
            np.asarray(y[k]), np.asarray(y_ref[k]), rtol=1e-12, atol=1e-12
        )
