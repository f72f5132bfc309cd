"""Aux subsystems: I/O round trips, config loading (incl. the reference's S5
YAML schema), checkpoints, detection-vector parity, profiling."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import phifem_tpu as pf
from phifem_tpu.levelset import detection_vector
from phifem_tpu.utils import (
    Timer,
    load_checkpoint,
    load_config,
    save_checkpoint,
    write_vtu,
    write_xdmf,
)


def test_xdmf_roundtrip(tmp_path):
    h5py = pytest.importorskip("h5py")
    g = pf.Grid(6, 5, ((0.0, 0.0), (2.0, 1.0)), "triangle")
    f = pf.interpolate(lambda x: x[..., 0] + 2 * x[..., 1], pf.Space.lagrange(g, 1))
    tags = np.asarray(pf.tag_cells(g, lambda x: x[..., 0] - 1.0, 1))
    path = tmp_path / "out.xdmf"
    write_xdmf(path, g, point_data={"u": f}, cell_data={"tags": tags})
    with h5py.File(tmp_path / "out.h5") as h5:
        geo = np.asarray(h5["/Mesh/geometry"])
        topo = np.asarray(h5["/Mesh/topology"])
        u = np.asarray(h5["/Function/u"])
        t = np.asarray(h5["/CellData/tags"])
    assert geo.shape == (g.num_vertices, 2)
    assert topo.shape == (g.num_cells, 3)
    assert np.allclose(u, np.asarray(f.data))
    assert np.array_equal(t, tags)
    assert (tmp_path / "out.xdmf").read_text().startswith("<?xml")


def test_vtu_writer(tmp_path):
    g = pf.Grid(4, 4, ((0.0, 0.0), (1.0, 1.0)), "quadrilateral")
    f = pf.interpolate(lambda x: x[..., 1], pf.Space.lagrange(g, 2))  # downsamples
    path = tmp_path / "out.vtu"
    write_vtu(path, g, point_data={"u": f})
    text = path.read_text()
    assert "UnstructuredGrid" in text and 'Name="u"' in text


def test_vtu_umesh_writer(tmp_path):
    """Unstructured VTU writer: 2D tri mesh and 3D tet mesh round-trip
    through ParaView-parsable XML with vertex + cell fields."""
    from phifem_tpu.umesh3 import UMesh3
    from phifem_tpu.utils import write_vtu_umesh

    um, _ = pf.UMesh.from_grid(
        pf.Grid(3, 3, ((0.0, 0.0), (1.0, 1.0)), "triangle")
    )
    p2 = tmp_path / "tri.vtu"
    write_vtu_umesh(
        p2, um,
        point_data={"u": um.verts[:, 0]},
        cell_data={"tag": np.ones(um.num_cells)},
    )
    t = p2.read_text()
    assert 'Name="u"' in t and 'Name="tag"' in t and ">5<" not in t

    m3 = UMesh3.box(2, 2, 2)
    p3 = tmp_path / "tet.vtu"
    write_vtu_umesh(p3, m3, point_data={"u": m3.verts[:, 2]})
    t3 = p3.read_text()
    assert "UnstructuredGrid" in t3 and t3.count("10") >= m3.num_cells


def test_checkpoint_roundtrip(tmp_path):
    path = tmp_path / "ck.npz"
    save_checkpoint(path, u=jnp.arange(5.0), tags=np.array([1, 2, 3], np.int8))
    back = load_checkpoint(path)
    assert np.allclose(back["u"], np.arange(5.0))
    assert back["tags"].dtype == np.int8


def test_load_reference_s5_yaml():
    cfg = load_config("demo/interface-elasticity/param1.yaml")
    assert cfg.initial_mesh_size == 0.2
    assert cfg.num_iterations == 5
    assert cfg.mode == "bg"  # box_mode: true
    assert cfg.bbox == ((-1.5, -1.5), (1.5, 1.5))
    assert cfg.resolve_resolution() == (15, 15)


def test_load_s5_yaml_without_pyyaml(monkeypatch):
    """The S5 parameter files load to the same config when PyYAML is not
    installed."""
    import sys

    paths = [
        f"demo/interface-elasticity/{name}.yaml"
        for name in ("param1", "param1_l7", "param_quick")
    ]
    expected = {
        "param1": (0.2, 5),
        "param1_l7": (0.2, 7),
        "param_quick": (0.25, 2),
    }
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml -> ImportError
    for path in paths:
        cfg = load_config(path)
        name = path.rsplit("/", 1)[1][: -len(".yaml")]
        assert (cfg.initial_mesh_size, cfg.num_iterations) == expected[name]
        assert cfg.mode == "bg"
        assert cfg.cell_type == "triangle"
        assert cfg.stabilization_coefficient == 1.0
        assert cfg.bbox == ((-1.5, -1.5), (1.5, 1.5))


def test_detection_vector_matches_reference_semantics():
    g = pf.Grid(10, 10, ((-1.5, -1.5), (1.5, 1.5)), "quadrilateral")
    phi = lambda x: x[..., 0] + 0.35
    d = np.asarray(detection_vector(g, phi, 1))
    tags = np.asarray(pf.tag_cells(g, phi, 1))
    # d == -1 <-> inside, d == +1 <-> outside, else cut (reference
    # mesh_scripts.py:343-347)
    assert np.all(tags[d == -1.0] == 1)
    assert np.all(tags[d == 1.0] == 3)
    assert np.all(tags[np.abs(d) < 1.0] == 2)


def test_timer():
    t = Timer()
    with t.phase("a"):
        pass
    assert "a" in t.phases and "total" in t.report()


def test_write_vti_3d(tmp_path):
    """Grid3 VTI writer: valid XML, correct extents, point+cell data."""
    import xml.etree.ElementTree as ET

    from phifem_tpu.grid3 import Grid3
    from phifem_tpu.utils import write_vti

    g = Grid3(4, 3, 2, ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)))
    u = np.arange(g.num_vertices, dtype=float).reshape(g.lattice_shape)
    tags = np.ones((g.nz, g.ny, g.nx))
    p = tmp_path / "out.vti"
    write_vti(p, g, point_data={"u": u}, cell_data={"tags": tags})
    root = ET.parse(p).getroot()
    img = root.find("ImageData")
    assert img.get("WholeExtent") == "0 4 0 3 0 2"
    arr = img.find("Piece/PointData/DataArray")
    vals = np.fromstring(arr.text.strip(), sep=" ")
    assert vals.size == g.num_vertices
    assert np.allclose(vals, u.reshape(-1))


def test_pfgmres_flexible_nonlinear_preconditioner():
    """FGMRES must converge THROUGH a nonlinear (inner-iterative) M that
    floors classical BiCGStab — the S5-3D failure mode in miniature: M is
    an inner CG truncated at a fixed sweep cap, a nonlinear map of its
    input.  Also pins plain-fgmres correctness against a dense solve."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from phifem_tpu.solvers import _pfgmres

    rng = np.random.default_rng(11)
    n = 120
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = Q @ np.diag(np.geomspace(1.0, 1e4, n)) @ Q.T  # SPD, cond 1e4
    A = A + 0.05 * rng.standard_normal((n, n))  # mildly nonsymmetric
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A)
    bt = {"u": jnp.asarray(b)}
    mv = lambda x: {"u": Aj @ x["u"]}

    def M(r):  # truncated inner CG on the symmetric part: NONLINEAR in r
        S = 0.5 * (Aj + Aj.T)
        x = jnp.zeros_like(r["u"])
        p = rr = r["u"]
        rs = rr @ rr
        for _ in range(15):
            Ap = S @ p
            al = rs / (p @ Ap)
            x = x + al * p
            rr = rr - al * Ap
            rs_new = rr @ rr
            p = rr + (rs_new / rs) * p
            rs = rs_new
        return {"u": x}

    x, it = _pfgmres(
        mv, bt, {"u": jnp.zeros(n)}, tol=1e-10, atol=0.0, maxiter=300, M=M
    )
    xd = np.linalg.solve(A, b)
    # measured: 160 iterations, err 1.2e-11
    assert np.allclose(np.asarray(x["u"]), xd, atol=1e-7), (
        np.abs(np.asarray(x["u"]) - xd).max()
    )
    assert int(it) <= 300


def test_save_tags_and_levelset(tmp_path):
    """Debug-dump helpers (reference tests/utils_test.py analogue): cell
    tags as VTU cell data, levelsets as vertex fields, on both mesh
    backends."""
    import jax.numpy as jnp

    import phifem_tpu as pf
    from phifem_tpu.umesh import UMesh
    from phifem_tpu.utils import save_levelset, save_tags

    g = pf.Grid(6, 6, ((-1.0, -1.0), (1.0, 1.0)), "triangle")
    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.4
    res = pf.compute_tags_measures(g, phi, 1, box_mode=True)
    save_tags(tmp_path / "tags.vtu", g, res.cells_tags)
    save_levelset(tmp_path / "phi.vtu", g, phi)
    um, _ = UMesh.from_grid(g)
    resu = pf.compute_tags_measures(um, phi, 1, box_mode=True)
    save_tags(tmp_path / "tags_u.vtu", um, resu.cells_tags)
    save_levelset(tmp_path / "phi_u.vtu", um, phi)
    for name in ("tags.vtu", "phi.vtu", "tags_u.vtu", "phi_u.vtu"):
        text = (tmp_path / name).read_text()
        assert "<VTKFile" in text and "DataArray" in text
