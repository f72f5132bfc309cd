"""Smoke run of the phi-FEM main path on an NVIDIA GPU.

Drives the scheme classes' normal ``setup -> assemble -> precondition ->
solve`` path at the sizes users run, checks every result against a plain
reference (host sparse-direct solve, the generic entity-batch matvec, an
element-by-element matvec, the analytic solution), and prints per phase
its cold (compile-inclusive) and warm seconds, iterations, residuals and
peak device memory.

    python chip_smoke.py               # phases 0-5 + the stencil finding, 1 GPU
    python chip_smoke.py --devices 4   # the 4-GPU checks only (a)-(c)

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU the script exits non-zero before any phase runs.  A failed
check raises, so the script then exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

os.environ.setdefault("PHIFEM_X64", "1")

HERE = os.path.dirname(os.path.abspath(__file__))

# Iterations of the phase-4 S5 solve (n=64, tol 1e-10, flat lattice
# preconditioner) on the CPU backend, float32 preconditioner products at
# full precision.  BiCGStab counts move by a few iterations with the
# summation order alone; a TF32 preconditioner shows up as a larger count.
S5_CPU_ITERATIONS = 19


# ----------------------------------------------------------------- helpers
def nvidia_smi_line() -> str:
    """``name, power.limit`` of every card, from a child that stays off JAX."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip()


def require_gpu(count: int):
    """The device gate: the GPUs JAX sees, or SystemExit(2) — no CPU
    fallback."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU (JAX platform {devs[0].platform!r}); "
            "this script measures the GPU only"
        )
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: need {count} GPUs, JAX sees {len(devs)}")
    return devs


def demo_data(*rel):
    """A demo's ``data.py`` under a unique module name."""
    path = os.path.join(HERE, "demo", *rel, "data.py")
    name = "chip_smoke_data_" + "_".join(rel).replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed(fn, *args, **kw):
    """``(out, seconds)``; the clock stops once every array in ``out`` is
    ready on the device."""
    import jax

    t0 = time.perf_counter()
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def report(phase: str, info: dict) -> None:
    info = dict(info, peak_bytes_in_use=peak_bytes())
    print(f"[{phase}] " + json.dumps(info, default=float), flush=True)


def check(name: str, value: float, limit: float, info: dict) -> None:
    """Record ``value <= limit`` in ``info``; raise when it fails."""
    info[name] = value
    info[name + "_limit"] = limit
    if not value <= limit:
        raise AssertionError(f"{name} = {value:.3e} exceeds {limit:.3e}")


def rel_l2(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def rel_max_tree(y, ref) -> float:
    """max over fields of |y - ref| over max over fields of |ref|."""
    import jax.numpy as jnp

    num = max(float(jnp.max(jnp.abs(y[k] - ref[k]))) for k in ref)
    den = max(float(jnp.max(jnp.abs(ref[k]))) for k in ref)
    return num / max(den, 1e-300)


def operator_forms(op, seed: int) -> dict:
    """The tap form against the generic entity-batch matvec on one random
    vector: f64 tap form (summation order only) and the f32 preconditioner
    copy (float32 rounding of weights and vector)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    lat = op.lattice_form()
    if lat is None:
        raise AssertionError("operator has no tap form")
    rng = np.random.default_rng(seed)
    x = {
        k: jnp.asarray(rng.standard_normal(v.shape))
        for k, v in op.system.zeros().items()
    }
    # the reference runs op by op: jitted whole, it would carry every
    # batch's tables as constants (~3 GB at n=3200)
    y_gen = op.matvec(x)
    # the weights enter as an argument, as they do in solve()
    y64 = jax.jit(lambda x, W: lat.make_matvec(op, W=W)(x))(x, lat.W)
    y32 = jax.jit(lambda x, W: lat.make_matvec(op, jnp.float32, W=W)(x))(x, lat.W)
    dense = lat.make_matvec(op).dense_form
    info = {"tap_form": "dense" if dense else "per-tap loop"}
    # f64: the two forms differ in summation order only
    check("tap_vs_generic_f64", rel_max_tree(y64, y_gen), 1e-12, info)
    # f32: weights and vector rounded to 2^-24 (6e-8) and rows of up to ~50
    # terms; the CPU backend measures 1.5e-7 at n=200 (limit: 70x that)
    check("tap_f32_vs_f64", rel_max_tree(y32, y64), F32_OPERATOR_TOL, info)
    return info


F32_OPERATOR_TOL = 1e-5


# ------------------------------------------------------------------ phases
def phase_s1(n: int = 200, tol: float = 1e-8) -> dict:
    """S1 weak-Dirichlet on the flower at the reference's headline size:
    lattice-preconditioned BiCGStab against the host sparse-direct solve,
    one warm re-tag + reassemble + solve iteration, and both operator
    forms."""
    import jax

    import phifem_tpu as pf
    from phifem_tpu.models import WeakDirichletPoisson

    D = demo_data("weak-dirichlet", "flower")
    grid = pf.Grid(n, n, ((-4.5, -4.5), (4.5, 4.5)), pf.CellType.triangle)
    s = WeakDirichletPoisson(
        grid, mode="bg", detection_degree=1, single_layer_cut=True
    )
    t0 = time.perf_counter()
    s.setup(D.levelset, D.source_term, detection_levelset=D.detection_levelset)
    s.assemble()
    jax.block_until_ready(s.b)
    t_setup = time.perf_counter() - t0
    vc, t_pc = timed(s.lattice_preconditioner, min_n=13)

    kw = dict(method="bicgstab", tol=tol, maxiter=60, precond=vc)
    _, t_cold = timed(lambda: s.solve(**kw).x)
    _, t_warm = timed(lambda: s.solve(**kw).x)
    res = s.result

    def pipeline_once():
        tags = pf.compute_tags_measures(
            grid, D.detection_levelset, 1, box_mode=True, single_layer_cut=True
        )
        s.op.reassemble()
        r = s.solve(**kw)
        return tags.cells_tags.values, r.x

    _, t_pipe_cold = timed(pipeline_once)
    (_, x_pipe), t_pipe = timed(pipeline_once)
    pipe = s.result

    x_ref, t_ref = timed(lambda: s.solve(method="sparse").x)
    info = {
        "n": n,
        "ndofs": s.system.num_dofs,
        "setup_assemble_s": t_setup,
        "precond_setup_s": t_pc,
        "solve_cold_s": t_cold,
        "solve_warm_s": t_warm,
        "iterations": res.iterations,
        "residual": res.residual,
        "pipeline_cold_s": t_pipe_cold,
        "pipeline_warm_s": t_pipe,
        "pipeline_iterations": pipe.iterations,
        "pipeline_residual": pipe.residual,
        "sparse_reference_s": t_ref,
    }
    if not (res.converged and pipe.converged):
        raise AssertionError(f"S1 solve did not converge: {info}")
    # relres <= 1e-8 on the equilibrated system and the sparse LU solves
    # the same matrix to ~1e-14, so the difference is the Krylov forward
    # error: at most cond(D^-1/2 A D^-1/2) x 1e-8 in the equilibrated
    # variables.  The limit allows an effective condition of 100; the CPU
    # backend measures 1e-10 at n=200
    check("u_vs_sparse_rel_l2", rel_l2(x_pipe["u"], x_ref["u"]), S1_U_TOL, info)
    info.update(operator_forms(s.op, seed=1))
    return info


S1_U_TOL = 1e-6


def cg_attainable(tol: float, n: int) -> float:
    """Limit on the true relative residual of a CG iterate whose recursive
    residual met ``tol``: rounding lets the two drift apart by ~eps64 times
    the condition number, ~4 n^2 / pi^2 for the grid Laplacian; the limit
    allows twice that."""
    import numpy as np

    return tol + 2 * np.finfo(np.float64).eps * 4 * n * n / np.pi**2


def phase_box(n: int = 3200, tol: float = 1e-10) -> dict:
    """BoxPoisson: f64 lattice CG with the f32 V-cycle, checked by the
    generic entity-batch matvec (independent of the lattice convolution)
    and against the analytic solution."""
    import jax
    import jax.numpy as jnp

    import phifem_tpu as pf
    from phifem_tpu.models import BoxPoisson

    grid = pf.Grid(n, n, ((0.0, 0.0), (1.0, 1.0)), pf.CellType.triangle)
    uex = lambda x: jnp.sin(jnp.pi * x[..., 0]) * jnp.sin(jnp.pi * x[..., 1])
    f = lambda x: 2.0 * jnp.pi**2 * uex(x)
    s = BoxPoisson(grid)
    t0 = time.perf_counter()
    s.setup(f)
    s.assemble()
    jax.block_until_ready(s.b)
    t_setup = time.perf_counter() - t0
    mg, t_mg = timed(s.lattice_solver, min_n=16, dtype=jnp.float32)
    _, t_cold = timed(lambda: s.solve_lattice(tol=tol, maxiter=40, mg=mg).x)
    _, t_warm = timed(lambda: s.solve_lattice(tol=tol, maxiter=40, mg=mg).x)
    r = s.result
    u = r.x["u"]

    R, C = n + 1, n + 1

    @jax.jit
    def true_residual(u, b):
        Au = s.op.matvec({"u": u})["u"].reshape(R, C)[1:-1, 1:-1]
        bi = b.reshape(R, C)[1:-1, 1:-1]
        return jnp.linalg.norm(bi - Au) / jnp.linalg.norm(bi)

    u_ex = pf.interpolate(uex, pf.Space.lagrange(grid, 1)).data
    info = {
        "n": n,
        "ndofs": s.system.num_dofs,
        "setup_assemble_s": t_setup,
        "mg_setup_s": t_mg,
        "solve_cold_s": t_cold,
        "solve_warm_s": t_warm,
        "iterations": r.iterations,
        "cg_residual": r.residual,
        "mg_levels": len(mg.levels),
    }
    if not r.converged:
        raise AssertionError(f"BoxPoisson CG did not converge: {info}")
    # the true residual of the returned iterate, by another matvec
    check("true_residual", float(true_residual(u, s.b["u"])), cg_attainable(tol, n), info)
    # P1 nodal error on the uniform split is O(h^2): 2.49 h^2 measured at
    # n=32..256 on the CPU backend; the limit allows 2x
    h = 1.0 / n
    check("nodal_l2_error", rel_l2(u, u_ex), 2 * BOX_ERR_C * h * h, info)
    return info


BOX_ERR_C = 2.5


def phase_s1_scale(n: int = 3200) -> dict:
    """The S1 operator at 20M DoF: setup, warm reassemble, and the tap
    form (per-tap loop at this size) against the generic matvec."""
    import jax

    import phifem_tpu as pf
    from phifem_tpu.models import WeakDirichletPoisson

    D = demo_data("weak-dirichlet", "flower")
    grid = pf.Grid(n, n, ((-4.5, -4.5), (4.5, 4.5)), pf.CellType.triangle)
    s = WeakDirichletPoisson(
        grid, mode="bg", detection_degree=1, single_layer_cut=True
    )
    t0 = time.perf_counter()
    s.setup(D.levelset, D.source_term, detection_levelset=D.detection_levelset)
    s.assemble()
    jax.block_until_ready(s.b)
    t_setup = time.perf_counter() - t0

    def reasm():
        s.op.reassemble()
        return [b.matrices for b in s.op.batches if getattr(b, "rebuild", None)]

    _, t_cold = timed(reasm)
    _, t_warm = timed(reasm)
    info = {
        "n": n,
        "ndofs": s.system.num_dofs,
        "setup_assemble_s": t_setup,
        "reassemble_cold_s": t_cold,
        "reassemble_warm_s": t_warm,
    }
    info.update(operator_forms(s.op, seed=2))
    return info


def _rigid_projector(modes):
    """Orthogonal projector (flat, all fields) off the span of ``modes``."""
    import numpy as np

    names = sorted(modes[0])

    def flat(t):
        return np.concatenate([np.asarray(t[k], np.float64).ravel() for k in names])

    Q, _ = np.linalg.qr(np.stack([flat(m) for m in modes], axis=1))
    return lambda t: (lambda v: v - Q @ (Q.T @ v))(flat(t))


def phase_s5(n: int = 64, tol: float = 1e-10) -> dict:
    """S5 interface elasticity: rigid-mode-deflated BiCGStab with the flat
    lattice preconditioner (the fused solve loop) against the bordered
    sparse-direct solve with the same modes."""
    import jax
    import jax.numpy as jnp

    import phifem_tpu as pf
    from phifem_tpu.models import InterfaceElasticity
    from phifem_tpu.solvers import masked_operator

    D = demo_data("interface-elasticity")
    grid = pf.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), pf.CellType.triangle)
    s = InterfaceElasticity(
        grid, mode="bg", E_in=D.E_in, nu_in=D.nu_in, E_out=D.E_out,
        nu_out=D.nu_out,
    )
    t0 = time.perf_counter()
    s.setup(D.levelset, D.source_term, D.exact_solution)
    s.assemble()
    jax.block_until_ready(s.b)
    t_setup = time.perf_counter() - t0
    pc, t_pc = timed(s.lattice_preconditioner, coupled=False, dense_max=20000)
    modes = s.rigid_modes()
    kw = dict(method="bicgstab", tol=tol, maxiter=100, precond=pc, deflate=modes)
    _, t_cold = timed(lambda: s.solve(**kw).x)
    x_it, t_warm = timed(lambda: s.solve(**kw).x)
    r = s.result
    # The Krylov solve deflates in the diagonally equilibrated variables:
    # it returns x with A x = b - |D| V c and V' |D| x = 0 (D = diag A).
    # The bordered sparse solve [[A W], [W' 0]] with W = |D| V imposes the
    # same two conditions, so it solves the same system exactly.
    _, diag, _ = masked_operator(s.op, s.bcs)
    dabs = {k: jnp.where(jnp.abs(d) > 1e-30, jnp.abs(d), 1.0) for k, d in diag.items()}
    weighted = tuple({k: m[k] * dabs[k] for k in m} for m in modes)
    x_ref, t_ref = timed(lambda: s.solve(method="sparse", deflate=weighted).x)
    proj = _rigid_projector(modes)
    info = {
        "n": n,
        "ndofs": s.system.num_dofs,
        "setup_assemble_s": t_setup,
        "precond_setup_s": t_pc,
        "solve_cold_s": t_cold,
        "solve_warm_s": t_warm,
        "iterations": r.iterations,
        "cpu_iterations": S5_CPU_ITERATIONS,
        "residual": r.residual,
        "sparse_reference_s": t_ref,
    }
    if not r.converged:
        raise AssertionError(f"S5 solve did not converge: {info}")
    # deflated relres <= 1e-10; the CPU backend measures 1.7e-12
    check("x_vs_sparse_rel_l2", rel_l2(proj(x_it), proj(x_ref)), S5_X_TOL, info)
    if S5_CPU_ITERATIONS is not None:
        # summation order moves counts by a few; TF32 products by more
        slack = max(3, S5_CPU_ITERATIONS // 4)
        check("iterations_over_cpu", r.iterations - S5_CPU_ITERATIONS, slack, info)
    return info


S5_X_TOL = 1e-8


def _hex_matvec(u3, spacing):
    """Q1 stiffness matvec element by element: each cell's 8x8 matrix
    applied to its corner values and scattered back — independent of the
    aggregated 27-point stencil the lattice CG uses."""
    import jax.numpy as jnp

    from phifem_tpu.ops.lattice3 import _HEX_OFFS, hex_element_matrix

    K = jnp.asarray(hex_element_matrix(*spacing), u3.dtype)
    D, R, C = u3.shape
    corners = [
        u3[dz : dz + D - 1, dy : dy + R - 1, dx : dx + C - 1]
        for (dx, dy, dz) in _HEX_OFFS
    ]
    y = jnp.zeros_like(u3)
    for i, (dx, dy, dz) in enumerate(_HEX_OFFS):
        yi = sum(K[i, j] * corners[j] for j in range(8))
        y = y.at[dz : dz + D - 1, dy : dy + R - 1, dx : dx + C - 1].add(yi)
    return y


def phase_box3(n: int = 128, tol: float = 1e-10) -> dict:
    """BoxPoisson3: Q1-hex lattice MG-CG, checked by an element-by-element
    matvec and against the analytic solution."""
    import jax
    import jax.numpy as jnp

    from phifem_tpu.grid3 import Grid3
    from phifem_tpu.models import BoxPoisson3

    g = Grid3(n, n, n, ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)))
    uex = lambda x: (
        jnp.sin(jnp.pi * x[..., 0])
        * jnp.sin(jnp.pi * x[..., 1])
        * jnp.sin(jnp.pi * x[..., 2])
    )
    f = lambda x: 3.0 * jnp.pi**2 * uex(x)
    s = BoxPoisson3(g)
    t0 = time.perf_counter()
    s.setup(f)
    s.assemble()
    jax.block_until_ready(s.b_lat)
    t_setup = time.perf_counter() - t0
    mg, t_mg = timed(s.lattice_solver, min_n=8, dtype=jnp.float32)
    _, t_cold = timed(lambda: s.solve_lattice(tol=tol, maxiter=40, mg=mg).x)
    r, t_warm = timed(lambda: s.solve_lattice(tol=tol, maxiter=40, mg=mg))
    u3 = s.u_lat

    @jax.jit
    def true_residual(u3, b3):
        Au = _hex_matvec(u3, g.spacing)[1:-1, 1:-1, 1:-1]
        bi = b3[1:-1, 1:-1, 1:-1]
        return jnp.linalg.norm(bi - Au) / jnp.linalg.norm(bi)

    info = {
        "n": n,
        "ndofs": g.num_vertices,
        "setup_assemble_s": t_setup,
        "mg_setup_s": t_mg,
        "solve_cold_s": t_cold,
        "solve_warm_s": t_warm,
        "iterations": r.iterations,
        "cg_residual": r.residual,
        "mg_levels": len(mg.levels),
    }
    if not r.converged:
        raise AssertionError(f"BoxPoisson3 CG did not converge: {info}")
    check("true_residual", float(true_residual(u3, s.b_lat)), cg_attainable(tol, n), info)
    # Q1 nodal error is O(h^2): 0.822 h^2 measured at n=16..48 on the
    # CPU backend; the limit allows 2x
    h = 1.0 / n
    err = rel_l2(u3, g.eval_at_vertices(uex, u3.dtype))
    check("nodal_l2_error", err, 2 * BOX3_ERR_C * h * h, info)
    return info


BOX3_ERR_C = 0.85


def stencil_finding(n: int = 3200, reps: int = 100) -> dict:
    """Achieved bandwidth of ``ops.lattice._conv_interior`` (the 2D bulk
    stencil) against a device copy of the same bytes, f32 and f64, each
    ``reps`` applications in one jitted fori_loop.  ``*_net_gbps``
    subtracts the loop's own per-iteration cost, timed on an 8-element
    array."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from phifem_tpu.ops.lattice import _conv_interior, _terms, vertex_stencil_weights
    from phifem_tpu.ops.stencil import _TRI_OFFS

    import phifem_tpu as pf
    from phifem_tpu.models import BoxPoisson

    # the bulk P1 stiffness stencil of BoxPoisson and S1, scaled to a
    # contraction so repeated application stays finite
    grid = pf.Grid(n, n, ((0.0, 0.0), (1.0, 1.0)), pf.CellType.triangle)
    s = BoxPoisson(grid).setup(lambda x: x[..., 0])
    s.assemble(rhs=False)
    w = vertex_stencil_weights(np.asarray(s.op.batches[0].matrices), _TRI_OFFS)
    terms = [(a, b, wt / np.abs(w).sum()) for a, b, wt in _terms(w)]
    R = C = n + 1
    info = {"n": n, "reps": reps, "stencil_terms": len(terms)}
    for dt in (jnp.float32, jnp.float64):
        name = jnp.dtype(dt).name
        x0 = jnp.asarray(
            np.random.default_rng(0).standard_normal((R + 2, C + 2)), dt
        )

        @jax.jit
        def conv_loop(xp):
            body = lambda i, v: jnp.pad(_conv_interior(v, terms, R, C), 2)
            return jax.lax.fori_loop(0, reps, body, xp)

        @jax.jit
        def copy_loop(xp):
            return jax.lax.fori_loop(0, reps, lambda i, v: -v, xp)

        nbytes = 2 * x0.size * x0.dtype.itemsize  # one read + one write
        timed(copy_loop, x0[:8])
        _, t_null = timed(copy_loop, x0[:8])
        info[f"loop_{name}_s_per_iter"] = t_null / reps
        for label, fn in (("conv", conv_loop), ("copy", copy_loop)):
            _, t_cold = timed(fn, x0)
            _, t = timed(fn, x0)
            info[f"{label}_{name}_s_per_app"] = t / reps
            info[f"{label}_{name}_gbps"] = nbytes * reps / t / 1e9
            info[f"{label}_{name}_net_gbps"] = nbytes * reps / max(t - t_null, 1e-9) / 1e9
            info[f"{label}_{name}_cold_s"] = t_cold
        for kind in ("", "net_"):
            info[f"conv_over_copy_{kind}{name}"] = (
                info[f"conv_{name}_{kind}gbps"] / info[f"copy_{name}_{kind}gbps"]
            )
    return info


# ------------------------------------------------------- 4-device checks
def _device_count(arr) -> int:
    return len({sh.device for sh in arr.addressable_shards})


def multi_box(mesh, n: int = 3200, tol: float = 1e-10) -> dict:
    """(a) Sharded lattice MG-CG against the single-device lattice solve."""
    import jax.numpy as jnp
    import numpy as np

    import phifem_tpu as pf
    from phifem_tpu.models import BoxPoisson
    from phifem_tpu.ops.lattice import vertex_stencil_weights
    from phifem_tpu.ops.stencil import _TRI_OFFS
    from phifem_tpu.parallel import build_sharded_lattice_mg, sharded_lattice_solve

    grid = pf.Grid(n, n, ((0.0, 0.0), (1.0, 1.0)), pf.CellType.triangle)
    uex = lambda x: jnp.sin(jnp.pi * x[..., 0]) * jnp.sin(jnp.pi * x[..., 1])
    s = BoxPoisson(grid).setup(lambda x: 2.0 * jnp.pi**2 * uex(x))
    s.assemble()
    r1, t1 = timed(lambda: s.solve_lattice(tol=tol, maxiter=40).x)
    r1 = s.result
    w = vertex_stencil_weights(np.asarray(s.op.batches[0].matrices), _TRI_OFFS)
    mg = build_sharded_lattice_mg(n, n, w, mesh, min_n=16)
    b2d = s.b["u"].reshape(n + 1, n + 1)
    (_, _, _), t_cold = timed(sharded_lattice_solve, mg, mesh, b2d, tol=tol, maxiter=40)
    (u2d, rel, it), t_warm = timed(
        sharded_lattice_solve, mg, mesh, b2d, tol=tol, maxiter=40
    )
    info = {
        "n": n,
        "single_solve_s": t1,
        "single_iterations": r1.iterations,
        "sharded_cold_s": t_cold,
        "sharded_warm_s": t_warm,
        "sharded_iterations": it,
        "sharded_residual": rel,
        "devices": _device_count(u2d),
    }
    check("u_rel_max_diff", rel_max_tree({"u": u2d.reshape(-1)}, r1.x), 1e-8, info)
    check("iteration_diff", abs(it - r1.iterations), 1, info)
    if info["devices"] != len(mesh.devices.flat):
        raise AssertionError(f"result on {info['devices']} devices")
    return info


def multi_halo(mesh, n: int = 200, tol: float = 1e-8) -> dict:
    """(b) Halo-exchange S1 solve against the single-device solve (both
    Jacobi-equilibrated BiCGStab)."""
    import phifem_tpu as pf
    from phifem_tpu.models import WeakDirichletPoisson
    from phifem_tpu.parallel import halo_solve

    D = demo_data("weak-dirichlet", "flower")
    grid = pf.Grid(n, n, ((-4.5, -4.5), (4.5, 4.5)), pf.CellType.triangle)
    s = WeakDirichletPoisson(
        grid, mode="bg", detection_degree=1, single_layer_cut=True
    )
    s.setup(D.levelset, D.source_term, detection_levelset=D.detection_levelset)
    s.assemble()
    x1, t1 = timed(lambda: s.solve(method="bicgstab", tol=tol).x)
    (x, rel), t_cold = timed(halo_solve, s.op, grid, s.b, mesh, tol=tol)
    (x, rel), t_warm = timed(halo_solve, s.op, grid, s.b, mesh, tol=tol)
    info = {
        "n": n,
        "single_solve_s": t1,
        "single_iterations": s.result.iterations,
        "halo_cold_s": t_cold,
        "halo_warm_s": t_warm,
        "halo_residual": rel,
        "devices": _device_count(x["u"]),
    }
    check("halo_residual", rel, tol, info)
    check("u_rel_l2_diff", rel_l2(x["u"], x1["u"]), HALO_TOL, info)
    if info["devices"] != len(mesh.devices.flat):
        raise AssertionError(f"result on {info['devices']} devices")
    return info


HALO_TOL = 1e-5


def multi_partitioned(mesh, n: int = 96, tol: float = 1e-9) -> dict:
    """(c) Partitioned-DoF solve on an imported mesh against the
    element-sharded solve."""
    import jax.numpy as jnp

    import phifem_tpu as pf
    from phifem_tpu.models import WeakDirichletPoissonU
    from phifem_tpu.parallel import (
        PartitionedUOperator,
        element_sharded_solve,
        partitioned_solve,
    )
    from phifem_tpu.umesh import UMesh

    um, _ = UMesh.from_grid(
        pf.Grid(n, n, ((-1.0, -1.0), (1.0, 1.0)), pf.CellType.triangle)
    )
    su = WeakDirichletPoissonU(um, mode="bg")
    su.setup(
        lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49,
        lambda x: jnp.ones(x.shape[:-1]),
    )
    su.assemble()
    (xe, rel_e, it_e), t_e = timed(
        element_sharded_solve, su.op, su.b, mesh, tol=tol, maxiter=4000
    )
    (_, _, _), t_cold = timed(
        partitioned_solve, su.op, su.b, mesh, tol=tol, maxiter=4000
    )
    (xp, rel_p, it_p), t_warm = timed(
        partitioned_solve, su.op, su.b, mesh, tol=tol, maxiter=4000
    )
    # partitioned_solve gathers x on return; its Krylov vectors use the
    # owner-block layout of PartitionedUOperator.partition
    Ep = PartitionedUOperator(su.op, mesh)
    b_part = Ep.partition_field("u", su.b["u"])
    info = {
        "n": n,
        "ndofs": su.op.system.num_dofs,
        "u_block_per_device": int(b_part.addressable_shards[0].data.shape[1]),
        "element_sharded_s": t_e,
        "element_sharded_iterations": it_e,
        "partitioned_cold_s": t_cold,
        "partitioned_warm_s": t_warm,
        "partitioned_iterations": it_p,
        "partitioned_residual": rel_p,
        "devices": _device_count(b_part),
    }
    check("partitioned_residual", rel_p, tol, info)
    check("u_rel_l2_diff", rel_l2(xp["u"], xe["u"]), PART_TOL, info)
    if info["devices"] != len(mesh.devices.flat):
        raise AssertionError(f"result on {info['devices']} devices")
    return info


PART_TOL = 1e-6


# -------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    devs = require_gpu(args.devices)
    print(nvidia_smi_line(), flush=True)

    import jax

    import phifem_tpu  # noqa: F401  (enables x64, places the compile cache)

    print(
        f"jax {jax.__version__}  x64={jax.config.jax_enable_x64}  "
        f"devices={len(devs)} x {devs[0].device_kind}",
        flush=True,
    )
    if args.devices == 4:
        from phifem_tpu.parallel import make_mesh

        mesh = make_mesh(4)
        phases = [
            ("4dev_a_sharded_lattice", lambda: multi_box(mesh)),
            ("4dev_b_halo", lambda: multi_halo(mesh)),
            ("4dev_c_partitioned", lambda: multi_partitioned(mesh)),
        ]
    else:
        phases = [
            ("1_s1_n200", phase_s1),
            ("2_box_n3200", phase_box),
            ("3_s1_n3200", phase_s1_scale),
            ("4_s5_n64", phase_s5),
            ("5_box3_n128", phase_box3),
            ("stencil_finding", stencil_finding),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        info = fn()
        info["phase_s"] = time.perf_counter() - t0
        report(name, info)
    result = {
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
