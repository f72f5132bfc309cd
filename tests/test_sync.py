"""Deferred host synchronization: lazy tag fetch, ``solve(sync=False)``
and the packed ``fetch_all`` round trip.

Every ``jax.device_get`` is a host synchronization, so the warm tag ->
reassemble -> solve iteration synchronizes ONCE (`bench.py` pipeline).
These tests pin the host-visible semantics: lazy
results must be value-identical to eager ones, and ``fetch_all`` must
materialize everything it is handed.  (The reference never faces this —
dolfinx/PETSc values are host-resident by construction.)
"""

import warnings

import jax.numpy as jnp
import numpy as np

import phifem_tpu as pf
from phifem_tpu.models import WeakDirichletPoisson
from phifem_tpu.utils import fetch_all

BOX = ((-1.0, -1.0), (1.0, 1.0))


def phi_circle(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 - 0.7**2


def u_ex(x):
    return jnp.sin(jnp.pi * x[..., 0]) * jnp.cos(jnp.pi * x[..., 1])


def f_rhs(x):
    return 2.0 * jnp.pi**2 * u_ex(x)


def _scheme(n=20):
    s = WeakDirichletPoisson(pf.Grid(n, n, BOX, pf.CellType.triangle), mode="bg")
    s.setup(phi_circle, f_rhs, u_D=u_ex)
    s.assemble()
    return s


def test_lazy_tags_match_eager_access():
    g = pf.Grid(24, 24, BOX, "triangle")
    res = pf.compute_tags_measures(g, phi_circle, 1, box_mode=True)
    # nothing fetched yet
    assert res._pending() is not None
    ct = res.cells_tags.as_numpy()
    ft = res.facets_tags.as_numpy()
    # one access materializes the packed triple for both tag sets
    assert res._pending() is None
    res2 = pf.compute_tags_measures(g, phi_circle, 1, box_mode=True)
    fetch_all(res2)
    np.testing.assert_array_equal(ct, res2.cells_tags.as_numpy())
    np.testing.assert_array_equal(ft, res2.facets_tags.as_numpy())
    # find() and the one-sided measure ride the same lazy values
    assert len(res2.facets_tags.find(4)) > 0
    assert set(res2.boundaries_measure.ids()) == {100, 101}


def test_solve_sync_false_matches_sync_true():
    s = _scheme()
    r_eager = s.solve(tol=1e-10)
    r_lazy = s.solve(tol=1e-10, sync=False)
    assert r_lazy._pending() is not None
    fetch_all(r_lazy)
    assert r_lazy._pending() is None
    assert r_lazy.iterations == r_eager.iterations
    assert r_lazy.converged
    np.testing.assert_allclose(
        np.asarray(r_lazy.x["u"]), np.asarray(r_eager.x["u"]), rtol=1e-12
    )
    # property access alone must also synchronize (no fetch_all needed)
    r3 = s.solve(tol=1e-10, sync=False)
    assert r3.residual == r_eager.residual


def test_fetch_all_packs_tags_and_solve_stats():
    """The bench pipeline shape: re-tag + reassemble + solve, one sync."""
    s = _scheme()
    res = pf.compute_tags_measures(s.grid, phi_circle, 1, box_mode=True)
    s.op.reassemble()
    r = s.solve(tol=1e-10, sync=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # healthy levelset
        fetch_all(res, r)
    assert res._pending() is None and r._pending() is None
    assert r.converged and r.iterations > 0
    assert np.any(res.cells_tags.as_numpy() == 2)
    # fetch_all on already-materialized objects is a no-op
    fetch_all(res, r)
