"""Benchmarks: the north-star 10M-DoF Poisson multigrid solve + the S1
weak-Dirichlet phi-FEM pipeline, on one NVIDIA GPU.

Headline metric (BASELINE.json north star: "sub-second 10M-DoF Poisson CG
solve to 1e-10 rel-res"): BoxPoisson on an n x n triangle background
(default n=3200 -> 10.25M vertex DoFs), solved to 1e-10 relative residual
by float64 CG with a float32 lattice V-cycle preconditioner
(BoxPoisson.solve_lattice).  value = MDoF/s of the timed warm solve;
vs_baseline = 1/t_solve x (ndofs/10.25M), so 1.0 == exactly sub-second at
10M DoF.

The S1 phi-FEM pipeline (tag -> reassemble -> solve on the reference's
headline 200x200 flower config, demo/weak-dirichlet/flower/main.py:45-46)
is reported in extra.s1.  S1 solves run float64 (PHIFEM_X64=1): the
reference solves in f64 (PETSc/MUMPS) and f32 Krylov stalls near 1e-4 on
penalized phi-FEM systems; the V-cycle preconditioner runs float32.

Every section runs in this one process, in order, and a complete result
JSON line is printed after each one (the last line holds them all).
Timings stop at ``jax.block_until_ready``.  The run refuses to start
without a GPU: the numbers are the card's or none.

Env knobs: PHIFEM_POISSON_N (default 3200), PHIFEM_BENCH_N (S1 grid, 200),
PHIFEM_BENCH_S5_N (S5 grid, 128), PHIFEM_BENCH_S5I_N (S5 iterative
grid, 64), PHIFEM_BENCH_ASM_N (large reassemble, 3200),
PHIFEM_BENCH_3D_N (3D Poisson, 128 -> 2.15M DoF);
PHIFEM_BENCH_SKIP_{S1,POISSON,S5,S5I,ASM,3D}=1 to skip a section;
PHIFEM_BENCH_S53D=1 adds the S5-3D section.
"""

import json
import os
import subprocess
import time

os.environ.setdefault("PHIFEM_X64", "1")

import jax
import jax.numpy as jnp


def _demo_data(*rel):
    """Load a demo's data.py under a unique module name (the demo dirs all
    call it `data`, so plain `import data` collides across sections)."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "demo", *rel, "data.py")
    name = "phifem_bench_data_" + "_".join(rel).replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def bench_poisson_mg(n: int) -> dict:
    """North-star path: n x n box Poisson, f32 MG-CG + f64 refinement."""
    import phifem_tpu as pf
    from phifem_tpu.models import BoxPoisson

    grid = pf.Grid(n, n, ((0.0, 0.0), (1.0, 1.0)), pf.CellType.triangle)
    uex = lambda x: jnp.sin(jnp.pi * x[..., 0]) * jnp.sin(jnp.pi * x[..., 1])
    f = lambda x: 2.0 * jnp.pi**2 * uex(x)

    s = BoxPoisson(grid)
    t0 = time.perf_counter()
    s.setup(f)
    s.assemble()
    jax.block_until_ready(s.b["u"])
    t_setup = time.perf_counter() - t0

    t0 = time.perf_counter()
    mg = s.lattice_solver(min_n=16, dtype=jnp.float32)
    t_mg = time.perf_counter() - t0

    # lattice-resident solve (ops.lattice): float64 CG with the float32
    # 2D V-cycle preconditioner, whole Krylov loop in one on-chip
    # lax.while_loop.  MG-rate convergence (grid-independent ~8 iters)
    # down to the f64 rounding floor.  (Mixed-precision iterative
    # refinement [solvers.solve_ir] is NOT used: its per-round reduction
    # is capped at ~kappa * eps32, which at 10M DoFs [kappa ~ 1e7] is
    # ~0.6 — see the solve_ir docstring.)
    r0, t_cold = _t(s.solve_lattice, tol=1e-10, maxiter=40, mg=mg)
    r, t_solve = _t(s.solve_lattice, tol=1e-10, maxiter=40, mg=mg)

    ndofs = s.system.num_dofs
    return {
        "ndofs": ndofs,
        "n": n,
        "solve_s": round(t_solve, 4),
        "cold_solve_s": round(t_cold, 2),
        "setup_assemble_s": round(t_setup, 2),
        "mg_setup_s": round(t_mg, 2),
        "residual": f"{r.residual:.2e}",
        "converged": bool(r.converged),
        "iterations": int(r.iterations),
        "mg_levels": len(mg.levels),
        "mdofs_per_s": round(ndofs / t_solve / 1e6, 2),
    }


def bench_s1_pipeline(n: int) -> dict:
    """Round-1 metric: S1 flower pipeline tag -> reassemble -> solve."""
    import phifem_tpu as pf
    from phifem_tpu.models import WeakDirichletPoisson
    from phifem_tpu.solvers import masked_operator
    from phifem_tpu.utils import fetch_all

    tol = float(os.environ.get("PHIFEM_BENCH_TOL", "1e-8"))
    grid = pf.Grid(n, n, ((-4.5, -4.5), (4.5, 4.5)), pf.CellType.triangle)

    D = _demo_data("weak-dirichlet", "flower")
    detection_levelset, levelset, source_term = (
        D.detection_levelset, D.levelset, D.source_term
    )

    s = WeakDirichletPoisson(grid, mode="bg", detection_degree=1, single_layer_cut=True)

    t0 = time.perf_counter()
    s.setup(levelset, source_term, detection_levelset=detection_levelset)
    jax.block_until_ready(s.cell_tags)
    t_cold_tag = time.perf_counter() - t0
    t0 = time.perf_counter()
    s.assemble()
    jax.block_until_ready(s.b["u"])
    t_cold_asm = time.perf_counter() - t0

    # compile the reassembly cores once before timing
    s.op.reassemble()
    jax.block_until_ready(
        [b.matrices for b in s.op.batches if getattr(b, "rebuild", None) is not None]
    )

    # per-phase warm timings (each synced; the fused pipeline below avoids
    # the middle sync)
    t0 = time.perf_counter()
    res_tags = pf.compute_tags_measures(
        grid, detection_levelset, 1, box_mode=True, single_layer_cut=True
    )
    jax.block_until_ready(res_tags.cells_tags.values)
    t_tag = time.perf_counter() - t0

    t0 = time.perf_counter()
    s.op.reassemble()
    jax.block_until_ready(
        [b.matrices for b in s.op.batches if getattr(b, "rebuild", None) is not None]
    )
    t_reasm = time.perf_counter() - t0

    # full-box lattice V-cycle + cut-block Schwarz correction: no
    # per-level re-tagging/re-assembly (mg.LatticeBulkVCycle)
    t0 = time.perf_counter()
    vc = s.lattice_preconditioner(min_n=13)
    t_mg_setup = time.perf_counter() - t0

    r0 = s.solve(method="bicgstab", tol=tol, maxiter=60, precond=vc)
    t0 = time.perf_counter()
    r = s.solve(method="bicgstab", tol=tol, maxiter=60, precond=vc)
    t_solve = time.perf_counter() - t0

    # the PIPELINE metric: one warm convergence-loop iteration — re-tag
    # (tags fetched: the host entity lists are how a caller would detect a
    # topology change), rebuild the data-dependent element matrices
    # (device dispatch only), solve (its packed stats fetch synchronizes
    # the whole chain).  This is the production iteration; the reference's
    # equivalent is re-running tags + assembly + LU per refinement level.
    def pipeline_once():
        res = pf.compute_tags_measures(
            grid, detection_levelset, 1, box_mode=True, single_layer_cut=True
        )
        s.op.reassemble()
        # reassemble bumped data_version, which clears compiled solve
        # runners; rebuild the preconditioner handle (cached dense/band
        # inverses are value-stale but structurally identical, so reuse)
        r = s.solve(method="bicgstab", tol=tol, maxiter=60, precond=vc, sync=False)
        # ONE packed host round trip for the whole iteration: the fresh
        # tags (how a caller detects a topology change) + the solve's
        # (relres, iters) stats fetch together
        fetch_all(res, r)
        return r

    pipeline_once()
    t0 = time.perf_counter()
    r_pipe = pipeline_once()
    t_pipe = time.perf_counter() - t0

    # matvec throughput: lax.fori_loop repetition inside ONE jit, so the
    # dispatch and the sync amortize over all applications
    matvec, diag, active = masked_operator(s.op)
    iters = 100

    @jax.jit
    def _mv_loop(x):
        x = jax.lax.fori_loop(
            0,
            iters,
            lambda i, v: jax.tree.map(
                lambda a, d: a / jnp.maximum(d, 1e-30), matvec(v), diag
            ),
            x,
        )
        return sum(jnp.sum(jnp.abs(v)) for v in x.values())

    x = jax.tree.map(jnp.ones_like, s.b)
    jax.block_until_ready(_mv_loop(x))  # compile
    t0 = time.perf_counter()
    jax.block_until_ready(_mv_loop(x))
    t_mv = (time.perf_counter() - t0) / iters

    ndofs = s.system.num_dofs
    return {
        "ndofs": ndofs,
        "n": n,
        # fused warm iteration (tag + reassemble dispatch + solve, one
        # packed fetch of the fresh tags and the solve's stats)
        "pipeline_s": round(t_pipe, 4),
        "pipeline_mdofs_per_s": round(ndofs / t_pipe / 1e6, 4),
        "phase_sum_mdofs_per_s": round(
            ndofs / (t_tag + t_reasm + t_solve) / 1e6, 4
        ),
        "tag_warm_s": round(t_tag, 4),
        "reassemble_s": round(t_reasm, 4),
        "solve_s": round(t_solve, 4),
        "solve_iterations": int(r.iterations),
        "pipeline_residual": f"{r_pipe.residual:.2e}",
        "pipeline_converged": bool(r_pipe.converged),
        "solve_residual": f"{r.residual:.2e}",
        "solve_converged": bool(r.converged),
        "matvec_s": round(t_mv, 6),
        "matvec_mdofs": round(ndofs / t_mv / 1e6, 1),
        "cold_tag_s": round(t_cold_tag, 2),
        "cold_assemble_s": round(t_cold_asm, 2),
        "mg_setup_s": round(t_mg_setup, 2),
        "mg_levels": len(vc.levels),
    }


def bench_poisson3(n: int) -> dict:
    """3D Q1-hex lattice MG-CG (ops.lattice3) — the z-axis extension the
    2D-only reference lacks.  Default n=128 -> 2.15M vertex DoFs; raise
    PHIFEM_BENCH_3D_N for the 10M-DoF row (n=216)."""
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
    t0 = time.perf_counter()
    mg = s.lattice_solver(min_n=8, dtype=jnp.float32)
    t_mg = time.perf_counter() - t0
    r0, t_cold = _t(s.solve_lattice, tol=1e-10, maxiter=40, mg=mg)
    r, t_solve = _t(s.solve_lattice, tol=1e-10, maxiter=40, mg=mg)
    ndofs = (n + 1) ** 3
    return {
        "ndofs": ndofs,
        "n": n,
        "solve_s": round(t_solve, 4),
        "cold_solve_s": round(t_cold, 2),
        "setup_assemble_s": round(t_setup, 2),
        "mg_setup_s": round(t_mg, 2),
        "residual": f"{r.residual:.2e}",
        "converged": bool(r.converged),
        "iterations": int(r.iterations),
        "mg_levels": len(mg.levels),
        "mdofs_per_s": round(ndofs / t_solve / 1e6, 2),
    }


def bench_s5(n: int) -> dict:
    """S5 interface elasticity (reference param1 problem) on the DIRECT
    path: cached sparse SuperLU of the 9-field system — the exact analogue
    of the reference's only S5 solver (MUMPS LU,
    demo/interface-elasticity/main.py:237-288).  Reported: assembly,
    factorization (cold solve) and factor-reusing re-solve times.

    The ITERATIVE S5 path runs on device in its own section
    (:func:`bench_s5_iter`)."""
    import phifem_tpu as pf
    from phifem_tpu.models import InterfaceElasticity

    D = _demo_data("interface-elasticity")
    grid = pf.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), pf.CellType.triangle)
    s = InterfaceElasticity(
        grid, mode="bg", E_in=D.E_in, nu_in=D.nu_in, E_out=D.E_out,
        nu_out=D.nu_out,
    )
    t0 = time.perf_counter()
    s.setup(D.levelset, D.source_term, D.exact_solution)
    s.assemble()
    jax.block_until_ready(s.b["u_in"])
    t_setup = time.perf_counter() - t0

    r0, t_factor = _t(s.solve, method="sparse")  # build + factor + solve
    r, t_solve = _t(s.solve, method="sparse")    # cached factor, new solve
    ndofs = s.system.num_dofs
    return {
        "ndofs": ndofs,
        "n": n,
        "solve_s": round(t_solve, 4),
        "factor_solve_s": round(t_factor, 2),
        "setup_assemble_s": round(t_setup, 2),
        "residual": f"{r.residual:.2e}",
        "converged": bool(r.converged),
        "mdofs_per_s": round(ndofs / t_solve / 1e6, 3),
    }


def bench_s5_3d(n: int) -> dict:
    """S5-3D interface elasticity (beyond the 2D-only reference): warm
    rigid-mode-deflated BiCGStab with the per-side block-MG + exact
    cut-block preconditioner.  OPT-IN (PHIFEM_BENCH_S53D=1)."""
    import jax.numpy as jnp

    from phifem_tpu.grid3 import Grid3
    from phifem_tpu.models import InterfaceElasticity3
    from phifem_tpu.models.interface_elasticity import lame

    E_in, E_out = 1.0, 0.001
    box = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
    phi = lambda x: 1.0 - (
        x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2
    )

    def exact(x):
        r = jnp.sqrt(
            x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2 + 1e-30
        )
        v = (jnp.cos(r) - jnp.cos(1.0)) / E_in
        v = jnp.where(r < 1.0, v * (E_in / E_out), v)
        return jnp.stack([v, v, v], axis=-1)

    lmbda, mu = lame(E_in, 0.3)

    def _sigma(p):
        G = jax.jacfwd(
            lambda q: jnp.cos(
                jnp.sqrt(q[0] ** 2 + q[1] ** 2 + q[2] ** 2 + 1e-30)
            )
            * jnp.ones(3)
        )(p)
        eps = 0.5 * (G + G.T)
        return lmbda * jnp.trace(G) * jnp.eye(3) + 2 * mu * eps

    def source(x):
        sh = x.shape[:-1]
        p = x.reshape(-1, 3)
        Dg = jax.vmap(jax.jacfwd(_sigma))(p)
        return (-jnp.einsum("nijj->ni", Dg) / E_in).reshape(sh + (3,))

    t0 = time.perf_counter()
    s = InterfaceElasticity3(Grid3(n, n, n, box), E_in=E_in, E_out=E_out)
    s.setup(phi, source, exact)
    s.assemble()
    jax.block_until_ready(s.b["ui"])
    t_setup = time.perf_counter() - t0

    t0 = time.perf_counter()
    pc = s.lattice_preconditioner()
    t_mg = time.perf_counter() - t0

    tol = float(os.environ.get("PHIFEM_BENCH_TOL", "1e-8"))
    defl = s.rigid_modes()
    r0, t_cold = _t(
        s.solve, method="fgmres", tol=tol, maxiter=400, precond=pc,
        deflate=defl,
    )
    r, t_solve = _t(
        s.solve, method="fgmres", tol=tol, maxiter=400, precond=pc,
        deflate=defl,
    )
    ndofs = 27 * s._N
    return {
        "ndofs": ndofs,
        "n": n,
        "solve_s": round(t_solve, 4),
        "cold_solve_s": round(t_cold, 2),
        "setup_assemble_s": round(t_setup, 2),
        "mg_setup_s": round(t_mg, 2),
        "iterations": int(r.iterations),
        "residual": f"{r.residual:.2e}",
        "converged": bool(r.converged),
        "mdofs_per_s": round(ndofs / t_solve / 1e6, 3),
    }


def bench_s5_iter(n: int) -> dict:
    """S5 interface elasticity, ITERATIVE path ON DEVICE: rigid-mode
    deflated HOST-DRIVEN BiCGStab (solvers._host_bicgstab — three small
    jitted programs, async step dispatches, one convergence fetch per
    check window) with the flat preconditioner (per-side var-MG bulk +
    Fourier coarse space + dense band inverse).  Reported: cold
    (compile-inclusive) and warm solve, iterations, and MDoF/s —
    comparable to the sparse-direct section's warm re-solve.  The
    reference has no iterative S5 solver at all (MUMPS LU,
    demo/interface-elasticity/main.py:237-288)."""
    import phifem_tpu as pf
    from phifem_tpu.models import InterfaceElasticity

    D = _demo_data("interface-elasticity")
    grid = pf.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), pf.CellType.triangle)
    s = InterfaceElasticity(
        grid, mode="bg", E_in=D.E_in, nu_in=D.nu_in, E_out=D.E_out,
        nu_out=D.nu_out,
    )
    t0 = time.perf_counter()
    s.setup(D.levelset, D.source_term, D.exact_solution)
    s.assemble()
    jax.block_until_ready(s.b["u_in"])
    t_setup = time.perf_counter() - t0

    t0 = time.perf_counter()
    # dense band inverse: at bench sizes the cut block (m ~ 4.5k at n=64,
    # 9k at n=128) fits a dense m x m f32 inverse, and one matmul per
    # application replaces ~50 latency-bound inner Krylov sweeps
    pc = s.lattice_preconditioner(coupled=False, dense_max=20000)
    t_pc = time.perf_counter() - t0

    # host-driven loop with split half-iteration programs (the fused
    # while_loop is what solve() runs by default; which is faster on the
    # card is ROADMAP C2)
    os.environ.setdefault("PHIFEM_HOST_SPLIT", "1")
    tol = float(os.environ.get("PHIFEM_BENCH_S5I_TOL", "1e-10"))
    kw = dict(
        method="bicgstab", tol=tol, maxiter=100, precond=pc,
        host_loop=True, check_every=10,
    )
    r0, t_cold = _t(s.solve, **kw)
    r, t_solve = _t(s.solve, **kw)
    ndofs = s.system.num_dofs
    return {
        "ndofs": ndofs,
        "n": n,
        "solve_s": round(t_solve, 4),
        "cold_solve_s": round(t_cold, 2),
        "setup_assemble_s": round(t_setup, 2),
        "precond_setup_s": round(t_pc, 2),
        "iterations": int(r.iterations),
        "residual": f"{r.residual:.2e}",
        "converged": bool(r.converged),
        "mdofs_per_s": round(ndofs / t_solve / 1e6, 3),
    }


def bench_reassemble_large(n: int) -> dict:
    """Measured (not extrapolated) stabilized-assembly rate at the 10M-DoF
    scale: all data-dependent cut/ghost/boundary element-matrix rebuilds of
    the S1 flower operator at n x n as ONE jitted call."""
    import phifem_tpu as pf
    from phifem_tpu.models import WeakDirichletPoisson

    D = _demo_data("weak-dirichlet", "flower")
    detection_levelset, levelset, source_term = (
        D.detection_levelset, D.levelset, D.source_term
    )

    grid = pf.Grid(n, n, ((-4.5, -4.5), (4.5, 4.5)), pf.CellType.triangle)
    s = WeakDirichletPoisson(grid, mode="bg", detection_degree=1, single_layer_cut=True)
    t0 = time.perf_counter()
    s.setup(levelset, source_term, detection_levelset=detection_levelset)
    s.assemble()
    jax.block_until_ready(s.b["u"])
    t_cold = time.perf_counter() - t0

    def reasm():
        s.op.reassemble()
        jax.block_until_ready(
            [
                b.matrices
                for b in s.op.batches
                if getattr(b, "rebuild", None) is not None
            ]
        )

    reasm()  # compile
    t0 = time.perf_counter()
    reasm()
    t_reasm = time.perf_counter() - t0
    ndofs = s.system.num_dofs
    return {
        "ndofs": ndofs,
        "n": n,
        "reassemble_s": round(t_reasm, 4),
        "cold_setup_s": round(t_cold, 2),
        "mdofs_per_s": round(ndofs / t_reasm / 1e6, 2),
    }


# ---------------------------------------------------------------------------
# Orchestration.  Registry maps section key -> (fn, env var for size, default
# size, skip env var).
# ---------------------------------------------------------------------------

_SECTIONS = {
    "poisson_mg": (bench_poisson_mg, "PHIFEM_POISSON_N", 3200, "PHIFEM_BENCH_SKIP_POISSON"),
    "s1": (bench_s1_pipeline, "PHIFEM_BENCH_N", 200, "PHIFEM_BENCH_SKIP_S1"),
    "reassemble_large": (bench_reassemble_large, "PHIFEM_BENCH_ASM_N", 3200, "PHIFEM_BENCH_SKIP_ASM"),
    "poisson3d": (bench_poisson3, "PHIFEM_BENCH_3D_N", 128, "PHIFEM_BENCH_SKIP_3D"),
    "s5_iter": (bench_s5_iter, "PHIFEM_BENCH_S5I_N", 64, "PHIFEM_BENCH_SKIP_S5I"),
    "s5": (bench_s5, "PHIFEM_BENCH_S5_N", 128, "PHIFEM_BENCH_SKIP_S5"),
    "s5_3d": (bench_s5_3d, "PHIFEM_BENCH_S53D_N", 16, None),
}


def _result_line(extra) -> str:
    """One complete result from whatever has finished so far.  Headline =
    poisson_mg MDoF/s vs the 10.25 MDoF/s north-star rate (sub-second
    10M-DoF solve == vs_baseline 1.0); falls back to the S1 pipeline metric
    if the headline section is skipped."""
    poisson = extra.get("poisson_mg")
    s1 = extra.get("s1")
    if poisson is not None:
        value = poisson["mdofs_per_s"]
        result = {
            "metric": "poisson_mg_ir_solve_10m_dof",
            "value": value,
            "unit": "MDoF/s",
            "vs_baseline": round(value / 10.25, 4),
            "extra": extra,
        }
    else:
        value = s1["pipeline_mdofs_per_s"] if s1 else 0.0
        result = {
            "metric": "s1_flower_pipeline_tag_assemble_solve",
            "value": value,
            "unit": "MDoF/s",
            "vs_baseline": round(value / 100.0, 4),
            "extra": extra,
        }
    return json.dumps(result)


def _device_record() -> dict:
    """The device the numbers belong to; SystemExit without a GPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"bench.py: no GPU (JAX platform {devs[0].platform!r}); "
            "it measures the GPU only"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "nvidia_smi": smi,
    }


def main():
    extra = {
        "device": _device_record(),
        "dtype": "float64" if os.environ["PHIFEM_X64"] == "1" else "float32",
    }
    order = [
        "poisson_mg", "s1", "reassemble_large", "poisson3d", "s5_iter", "s5"
    ]
    if os.environ.get("PHIFEM_BENCH_S53D") == "1":
        order.append("s5_3d")
    for key in order:
        fn, size_env, size_default, skip_env = _SECTIONS[key]
        if skip_env and os.environ.get(skip_env) == "1":
            continue
        extra[key] = fn(int(os.environ.get(size_env, str(size_default))))
        print(_result_line(extra), flush=True)


if __name__ == "__main__":
    main()
