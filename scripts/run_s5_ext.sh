#!/bin/sh
# Extended S5 param1 study: levels 5-6 (465k / 1.86M DoF) on CPU float64 —
# errors are platform-independent.
# One level per process (a failure loses one level).  Appends to
# docs/s5_param1_ext.csv.
cd "$(dirname "$0")/.." || exit 1
OUT=docs/s5_param1_ext.csv
# sparse direct (SuperLU, the reference's MUMPS-LU path): at these sizes
# the flat-preconditioned BiCGStab breaks down before converging (level 5:
# stagnated at rel 9e-4 after 91 iterations / 2000 s), while LU solves in
# minutes and reproduces the recorded level-0/1 errors to 6 digits.
for L in 5 6; do
  env JAX_PLATFORMS=cpu \
    python scripts/run_s5_level.py "$L" --out "$OUT" --method sparse \
    >> /tmp/s5_ext.log 2>&1
  echo "level $L rc=$?" >> /tmp/s5_ext.log
done
