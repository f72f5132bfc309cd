"""Hot-path compute kernels (stencils, tap-form operators, lattice MG)."""

import jax

# Precision of every matrix product and dot in the float32 preconditioners.
# Left at the default, a GPU may run float32 products in TF32 (~3 decimal
# digits), and the preconditioner would then differ from the CPU's.
HIGHEST = jax.lax.Precision.HIGHEST

from .stencil import StencilCellBatch  # noqa: E402

__all__ = ["HIGHEST", "StencilCellBatch"]
