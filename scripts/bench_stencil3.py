"""3D 27-point stencil-matvec microbenchmark + V-cycle stage timing: is
the 3D V-cycle bandwidth-bound or implementation-bound?

Run on the GPU: python scripts/bench_stencil3.py
Each timing is ``REP`` applications inside one jitted fori_loop, synced
with ``jax.block_until_ready``, minus an empty dispatch.

What it measures, per size:
  * raw 27-point conv (f32) and its achieved bytes/s;
  * the same conv in f64 (the outer CG matvec's cost);
  * one full V-cycle (f32) vs its theoretical stage sum.
"""
import os, time

os.environ.setdefault("PHIFEM_X64", "1")
import jax, jax.numpy as jnp

from phifem_tpu.grid3 import Grid3
from phifem_tpu.models import BoxPoisson3
from phifem_tpu.ops.lattice3 import _conv_interior3, _embed3

REP = 60


def fetch(v):
    jax.block_until_ready(v)


for n in (96, 128, 160):
    g = Grid3(n, n, n, ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)))
    s = BoxPoisson3(g).setup(lambda x: jnp.ones(x.shape[:-1]))
    s.assemble()
    mg = s.lattice_solver(min_n=8, dtype=jnp.float32)
    D = R = C = n + 1
    ndofs = D * R * C
    terms = mg.levels[0].terms

    @jax.jit
    def null(x):
        return x[0, 0, 0]

    xp32 = jnp.full((D + 2, R + 2, C + 2), 1e-3, jnp.float32)
    xp64 = xp32.astype(jnp.float64)

    def make_loop(terms, dt):
        @jax.jit
        def loop(x):
            def body(i, x):
                y = _embed3(_conv_interior3(x, terms, D, R, C), D, R, C)
                return y * jnp.asarray(0.05, dt)

            return jax.lax.fori_loop(0, REP, body, x)[5, 5, 5]

        return loop

    loop32 = make_loop(terms, jnp.float32)
    loop64 = make_loop(terms, jnp.float64)

    @jax.jit
    def loop_vcycle(x):
        def body(i, x):
            return mg(x) * jnp.asarray(0.05, jnp.float32)

        return jax.lax.fori_loop(0, REP, body, x)[5, 5, 5]

    fetch(null(xp32))
    t0 = time.perf_counter(); fetch(null(xp32)); t_null = time.perf_counter() - t0
    fetch(loop32(xp32))
    t0 = time.perf_counter(); fetch(loop32(xp32)); t32 = time.perf_counter() - t0
    fetch(loop64(xp64))
    t0 = time.perf_counter(); fetch(loop64(xp64)); t64 = time.perf_counter() - t0
    fetch(loop_vcycle(xp32))
    t0 = time.perf_counter(); fetch(loop_vcycle(xp32)); tv = time.perf_counter() - t0
    p32 = (t32 - t_null) / REP
    p64 = (t64 - t_null) / REP
    pv = (tv - t_null) / REP
    # bandwidth model: conv reads the padded cube once + writes once
    gb = ndofs * 2 * 4 / 1e9
    print(
        f"n={n} ({ndofs/1e6:.2f}M DoF): conv f32 {p32*1e3:.3f} ms "
        f"({ndofs/p32/1e9:.2f} GDoF/s, ~{gb/p32:.0f} GB/s) | "
        f"conv f64 {p64*1e3:.3f} ms ({ndofs/p64/1e9:.2f} GDoF/s) | "
        f"V-cycle {pv*1e3:.3f} ms ({ndofs/pv/1e6:.0f} MDoF/s/cycle, "
        f"{pv/p32:.1f}x conv)",
        flush=True,
    )
