"""Assembly throughput at scale: S1 warm re-tag + reassemble.

Run: N=800 python scripts/bench_assembly.py   (each timed phase ends in
one ``jax.block_until_ready`` over everything it produced).
"""
import os
import sys
import time

os.environ.setdefault("PHIFEM_X64", "1")
import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(
    0, os.path.join(os.path.dirname(__file__), "..", "demo", "weak-dirichlet", "flower")
)
import phifem_tpu as pf  # noqa: E402
from data import detection_levelset, levelset, source_term  # noqa: E402
from phifem_tpu.models import WeakDirichletPoisson  # noqa: E402

n = int(os.environ.get("N", "800"))
grid = pf.Grid(n, n, ((-4.5, -4.5), (4.5, 4.5)), pf.CellType.triangle)
s = WeakDirichletPoisson(grid, mode="bg", detection_degree=1, single_layer_cut=True)


def rebuilt():
    return [b.matrices for b in s.op.batches if getattr(b, "rebuild", None) is not None]


t0 = time.perf_counter()
s.setup(levelset, source_term, detection_levelset=detection_levelset)
jax.block_until_ready(s.cell_tags)
print("cold setup", time.perf_counter() - t0, flush=True)
t0 = time.perf_counter()
s.assemble()
jax.block_until_ready(rebuilt())
print("cold assemble", time.perf_counter() - t0, flush=True)


def warm_once():
    t0 = time.perf_counter()
    res = pf.compute_tags_measures(
        grid, detection_levelset, 1, box_mode=True, single_layer_cut=True
    )
    jax.block_until_ready(res.cells_tags.values)
    t_tag = time.perf_counter() - t0
    t0 = time.perf_counter()
    s.op.reassemble()
    jax.block_until_ready(rebuilt())
    t_re = time.perf_counter() - t0
    return t_tag, t_re


warm_once()
ts = [warm_once() for _ in range(3)]
t_tag = min(t[0] for t in ts)
t_re = min(t[1] for t in ts)
nd = s.system.num_dofs
print(f"n={n}: ndofs {nd}  warm tag {t_tag:.4f}s  reassemble {t_re:.4f}s", flush=True)
print(f"assembly MDoF/s (tag+reassemble): {nd/(t_tag+t_re)/1e6:.1f}", flush=True)
print(f"reassemble-only MDoF/s: {nd/t_re/1e6:.1f}", flush=True)
