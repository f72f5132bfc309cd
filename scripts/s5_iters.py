"""S5 outer-iteration scaling study for the flat lattice preconditioner.

Measures BiCGStab outer iterations of the deflated S5 solve at a sequence
of grid sizes, for a given interface-Fourier coarse-space size
(``--k 0`` = the round-3 rank-3 rigid space; default 8).  Round-3 record
(rigid-only): 15/34/80 at n=32/64/128 — the growth this study exists to
kill.

Usage: python scripts/s5_iters.py [--k K] [--ns 32,64,128,256] [--tol 1e-8]
Run on CPU: JAX_PLATFORMS=cpu python ...
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import importlib.util


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--ns", default="32,64,128")
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--maxiter", type=int, default=400)
    ap.add_argument("--sweeps", type=int, default=None)
    args = ap.parse_args()

    import phifem_tpu as pf
    from phifem_tpu.models import InterfaceElasticity

    root = os.path.join(os.path.dirname(__file__), "..")
    spec = importlib.util.spec_from_file_location(
        "s5_data", os.path.join(root, "demo", "interface-elasticity", "data.py")
    )
    D = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(D)

    for n in (int(x) for x in args.ns.split(",")):
        grid = pf.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), pf.CellType.triangle)
        s = InterfaceElasticity(
            grid, mode="bg", E_in=D.E_in, nu_in=D.nu_in,
            E_out=D.E_out, nu_out=D.nu_out, coarse_fourier_k=args.k,
        )
        s.setup(D.levelset, D.source_term, D.exact_solution)
        s.assemble()
        t0 = time.perf_counter()
        kw = {} if args.sweeps is None else {"sweeps": args.sweeps}
        vc = s.lattice_preconditioner(coupled=False, **kw)
        t_pc = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = s.solve(
            method="bicgstab", tol=args.tol, maxiter=args.maxiter, precond=vc
        )
        t_solve = time.perf_counter() - t0
        print(
            f"n={n:4d} k={args.k:3d} iters={r.iterations:4d} "
            f"res={r.residual:.2e} conv={r.converged} "
            f"pc_setup={t_pc:.1f}s solve={t_solve:.1f}s",
            flush=True,
        )


if __name__ == "__main__":
    main()
