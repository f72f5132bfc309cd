"""Plain Poisson on the full background box — the pure-multigrid path.

Not a phi-FEM scheme: no level set, no cut cells — every cell is a bulk
cell, so the whole operator is ONE uniform P1 stencil batch and the
V-cycle needs no interface correction.  This
is the north-star benchmark path (BASELINE.json: sub-second 10M-DoF Poisson
CG to 1e-10 relative residual) and the scaling probe for the stencil /
transfer kernels; the phi-FEM machinery (tagging, penalty, ghost) is
benchmarked separately by the S1 pipeline metric.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..assembly import CellTerm, System, assemble_operator
from ..grid import Grid
from ..solvers import DirichletBC, SolveResult, solve
from ..spaces import Function, Space, boundary_dof_mask, interpolate


@dataclasses.dataclass
class BoxPoisson:
    """-Delta u = f on the box, u = u_D on the box boundary, P1."""

    grid: Grid
    primal_degree: int = 1

    def setup(
        self,
        f: Union[Callable, Function],
        u_D: Union[Callable, Function, None] = None,
    ):
        g = self.grid
        V = Space.lagrange(g, self.primal_degree)
        self.V = V
        self.system = System({"u": V})
        self.f = f
        if u_D is None:
            u_D = lambda x: jnp.zeros(x.shape[:-1])
        self.u_D = u_D if isinstance(u_D, Function) else interpolate(u_D, V)
        self.bcs = (DirichletBC("u", boundary_dof_mask(V), self.u_D.data),)
        self._setup_args = (f, u_D)
        return self

    def assemble(self, rhs: bool = True):
        g = self.grid

        def stiffness(u, v, d, x, ctx):
            return jnp.dot(u["u"].grad, v["u"].grad)

        self.op = assemble_operator(
            self.system,
            g,
            cell_terms=[
                (
                    CellTerm(
                        stiffness, None, degree=2 * self.primal_degree, uniform=True
                    ),
                    {},
                )
            ],
        )
        if not rhs:
            return self

        f_h = self.f if isinstance(self.f, Function) else interpolate(self.f, self.V)

        if self.primal_degree != 1:
            # the vertex-stencil load shortcut below is P1-only (the
            # aggregated stencil covers vertex DoFs exclusively)
            from ..assembly import assemble_vector

            self.b = assemble_vector(
                self.system,
                g,
                cell_terms=[
                    (
                        CellTerm(
                            lambda v, d, x, ctx: d["f"].val * v["u"].val,
                            None,
                            degree=2 * self.primal_degree,
                        ),
                        {"f": f_h},
                    )
                ],
            )
            return self

        # load vector b = M f_h as a 9-point vertex-stencil convolution
        # (ops.lattice): interior mass rows are uniform (every interior
        # vertex has a full cell ring), and boundary rows are don't-care —
        # they are overwritten by the Dirichlet lift in every solve path.
        # This avoids assembling a second operator and the cold compile of
        # a dedicated 10M-DoF kernel.
        def mass(u, v, d, x, ctx):
            return u["u"].val * v["u"].val

        from ..assembly import uniform_element_matrices
        from ..ops.lattice import _conv_interior, _terms, vertex_stencil_weights
        from ..ops.stencil import _QUAD_OFFS, _TRI_OFFS

        mats = uniform_element_matrices(self.system, g, mass, 2 * self.primal_degree)
        offs = _TRI_OFFS if g.is_simplex else (_QUAD_OFFS,)
        terms = _terms(vertex_stencil_weights(np.asarray(mats), offs))
        R, C = g.ny + 1, g.nx + 1

        @jax.jit
        def _load(fd):
            fp = jnp.zeros((R + 2, C + 2), fd.dtype).at[1 : 1 + R, 1 : 1 + C].set(
                fd.reshape(R, C)
            )
            b2 = jnp.zeros((R, C), fd.dtype).at[1:-1, 1:-1].set(
                _conv_interior(fp, terms, R, C)
            )
            return b2.reshape(-1)

        self.b = {"u": _load(f_h.data)}
        return self

    def mg_preconditioner(self, min_n: int = 8, dtype=None, **vcycle_kw):
        """Geometric V-cycle: re-discretized uniform stiffness per level
        (one tiny uniform-term compile each — no tagging, no data terms)."""
        from ..mg import build_hierarchy

        def make_level(grid: Grid):
            if grid is self.grid:
                return self.op, self.bcs
            s = BoxPoisson(grid, self.primal_degree)
            s.setup(*self._setup_args)
            s.assemble(rhs=False)
            return s.op, s.bcs

        return build_hierarchy(
            self.grid, make_level, min_n=min_n, dtype=dtype, **vcycle_kw
        )

    def solve(self, method: str = "cg", tol: float = 1e-10, **kw) -> SolveResult:
        res = solve(self.op, self.b, bcs=self.bcs, method=method, tol=tol, **kw)
        self.result = res
        self.u_h = Function(self.V, res.x["u"])
        return res

    # ---------------------------------------------------- lattice fast path
    def lattice_solver(self, min_n: int = 16, dtype=jnp.float32, **kw):
        """2D lattice-resident V-cycle (ops.lattice) — the north-star bench
        preconditioner.  Zero per-level assembly: the P1 stiffness vertex
        stencil is refinement-invariant in 2D."""
        from ..ops.lattice import build_lattice_mg, vertex_stencil_weights
        from ..ops.stencil import _QUAD_OFFS, _TRI_OFFS, StencilCellBatch

        batch = next(
            b for b in self.op.batches if isinstance(b, StencilCellBatch)
        )
        offs = _TRI_OFFS if self.grid.is_simplex else (_QUAD_OFFS,)
        w = vertex_stencil_weights(np.asarray(batch.matrices), offs)
        return build_lattice_mg(
            self.grid.nx, self.grid.ny, w, min_n=min_n, dtype=dtype, **kw
        )

    def solve_lattice(
        self, tol: float = 1e-10, maxiter: int = 60, mg=None
    ) -> SolveResult:
        """Solve on 2D padded lattices: f64 MG(f32)-preconditioned CG with
        the whole Krylov loop in one on-chip ``lax.while_loop``."""
        from ..ops.lattice import lattice_cg

        if mg is None:
            mg = self._lattice_mg = getattr(self, "_lattice_mg", None) or (
                self.lattice_solver()
            )
        g = self.grid
        R, C = g.ny + 1, g.nx + 1

        key = ("lattice", id(mg), float(tol), int(maxiter))
        cache = getattr(self, "_lat_cache", None)
        if cache is None:
            cache = self._lat_cache = {}
        runner = cache.get(key)
        if runner is None:

            @jax.jit
            def runner(b_flat, uD_flat):
                b2 = b_flat.reshape(R, C)
                uD2 = uD_flat.reshape(R, C)
                border = jnp.zeros((R, C), bool).at[0, :].set(True)
                border = border.at[-1, :].set(True).at[:, 0].set(True)
                border = border.at[:, -1].set(True)
                xD = jnp.where(border, uD2, 0.0)
                xDp = jnp.zeros((R + 2, C + 2), b2.dtype).at[
                    1 : 1 + R, 1 : 1 + C
                ].set(xD)
                from ..ops.lattice import _conv_interior, _embed

                lift = _conv_interior(xDp, mg.terms, R, C)
                bp = _embed(b2[1:-1, 1:-1] - lift, R, C)
                xp, rel, it = lattice_cg(mg, bp, tol=tol, maxiter=maxiter)
                u2 = xp[1 : 1 + R, 1 : 1 + C] + xD
                # pack the scalars: one device_get for both
                return u2.reshape(-1), jnp.stack(
                    [rel, it.astype(b2.dtype)]
                )

            cache[key] = runner

        u, stats = runner(self.b["u"], self.u_D.data)
        stats = np.asarray(stats)
        rel, it = float(stats[0]), int(stats[1])
        res = SolveResult(
            x={"u": u}, residual=rel, iterations=it, converged=rel <= tol
        )
        self.result = res
        self.u_h = Function(self.V, res.x["u"])
        return res

    def solve_ir(self, tol: float = 1e-10, **kw) -> SolveResult:
        """Mixed-precision solve: f32 MG-preconditioned CG corrections in a
        full-precision iterative-refinement loop (solvers.solve_ir) — the
        north-star bench path (sub-second 10M-DoF Poisson to 1e-10)."""
        from ..solvers import solve_ir as _solve_ir

        precond = kw.pop("precond", None)
        if precond is None:
            precond = self.mg_preconditioner(dtype=jnp.float32)
        res = _solve_ir(self.op, self.b, bcs=self.bcs, precond=precond, tol=tol, **kw)
        self.result = res
        self.u_h = Function(self.V, res.x["u"])
        return res
