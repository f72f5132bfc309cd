"""Component timing of the on-device S5 iteration: taps matvec alone,
preconditioner alone, band-free preconditioner — REP applications in one
jitted fori_loop each, synced with ``jax.block_until_ready``.  Splits one
S5 iteration into its layers."""

import importlib.util
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
from phifem_tpu.models import InterfaceElasticity  # noqa: E402
from phifem_tpu.solvers import masked_operator  # noqa: E402

REP = 20


def log(m):
    print(f"[{time.strftime('%H:%M:%S')}] {m}", flush=True)


def timed(name, fn, x):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(x))
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(fn(x))
    dt = time.perf_counter() - t0
    log(f"{name}: compile+run {t_c:.1f}s, warm {dt/REP*1e3:.2f} ms/apply")


def main():
    n = int(os.environ.get("PHIFEM_PROBE_N", "64"))
    spec = importlib.util.spec_from_file_location(
        "s5data",
        os.path.join(
            os.path.dirname(__file__), "..", "demo", "interface-elasticity",
            "data.py",
        ),
    )
    D = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(D)
    g = pf.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), "triangle")
    s = InterfaceElasticity(
        g, mode="bg", E_in=D.E_in, nu_in=D.nu_in, E_out=D.E_out,
        nu_out=D.nu_out,
    )
    s.setup(D.levelset, D.source_term, D.exact_solution)
    s.assemble()
    jax.block_until_ready(s.b["u_in"])
    log("setup done")

    matvec, _, _ = masked_operator(s.op, s.bcs)
    b = s.b

    def loop_of(apply_fn):
        @jax.jit
        def loop(x):
            def body(i, x):
                y = apply_fn(x)
                return jax.tree.map(lambda v: v * 0.5, y)

            out = jax.lax.fori_loop(0, REP, body, x)
            return out["u_in"][0, 0]

        return loop

    timed("taps matvec f64", loop_of(matvec), b)

    vc_nb = s.lattice_preconditioner(coupled=False, interface=False)
    log("pc (no band) built")
    timed("precond bulk+coarse (NO band)", loop_of(lambda x: vc_nb(x)), b)

    vc = s.lattice_preconditioner(coupled=False)
    log("pc (full) built")
    timed("precond FULL (bulk+coarse+band)", loop_of(lambda x: vc(x)), b)
    log("done")


if __name__ == "__main__":
    main()
