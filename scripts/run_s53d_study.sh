#!/bin/sh
# S5-3D convergence study: 3 levels, contrast 1000 + contrast-1 control,
# preconditioned fgmres.  One process per level (a failure loses one
# level).  CPU: JAX_PLATFORMS=cpu sh scripts/run_s53d_study.sh
set -x
for lvl in 0 1 2; do
  python scripts/run_s53d_level.py "$lvl" --precond --contrast 1000 \
    --out docs/s53d_results.csv
done
for lvl in 0 1 2; do
  python scripts/run_s53d_level.py "$lvl" --precond --contrast 1 \
    --out docs/s53d_results.csv
done
