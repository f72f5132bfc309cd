"""S1 — weak (dual-penalty) Dirichlet phi-FEM for the Poisson problem.

Scheme of reference ``demo/weak-dirichlet/flower/main.py:102-154``:
  -Delta u = f in Omega = {phi < 0},  u = u_D on Gamma = {phi = 0}
Mixed P1 x P1 fields (u, auxiliary p); bilinear form:

  a(u,p; v,q) = int_{dx(1,2)} grad u . grad v
              - int_{Gamma_h} (grad u . n) v                         (ds)
              + pen/h^2 int_{dx(2)} (u - phi p / h)(v - phi q / h)
              + stab h^2 int_{dx(2)} (Delta u)(Delta v)
              + stab int_{dS(2,3)} avg(h) [grad u . n][grad v . n]

  L(v,q)      = int_{dx(1,2)} f v
              + pen/h^2 int_{dx(2)} u_D (v - phi q / h)
              - stab h^2 int_{dx(2)} f (Delta v)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import jax.numpy as jnp

from ..assembly import (
    BoundaryTerm,
    CellTerm,
    FacetTerm,
    System,
    assemble_operator,
    assemble_vector,
)
from ..solvers import SolveResult, solve
from ..spaces import Function, Space, interpolate
from .base import LevelSetLike, SchemeBase


def s1_forms(pen, stab, primal_degree, levelset_degree, phi_h, f_h, u_D, ds):
    """The S1 weak-Dirichlet term lists (operator + RHS), shared verbatim
    by the structured scheme below and the unstructured one
    (:class:`phifem_tpu.models.unstructured.WeakDirichletPoissonU`) — one
    definition of the discrete form, two mesh backends.

    Returns ``(cell_terms, facet_terms, boundary_terms, rhs_cell_terms)``
    ready for either ``assembly.assemble_operator`` or
    ``uassembly.assemble_operator``."""
    qdeg = 2 * (primal_degree + levelset_degree)

    def stiffness(u, v, d, x, ctx):
        return jnp.dot(u["u"].grad, v["u"].grad)

    def boundary_flux(u, v, d, x, n, ctx):
        return -jnp.dot(u["u"].grad, n) * v["u"].val

    def penalty(u, v, d, x, ctx):
        h = ctx.h
        phi = d["phi"].val
        uu = u["u"].val - phi * u["p"].val / h
        vv = v["u"].val - phi * v["p"].val / h
        return pen / h**2 * uu * vv

    def cell_stab(u, v, d, x, ctx):
        return stab * ctx.h**2 * u["u"].lap * v["u"].lap

    def ghost(u0, u1, v0, v1, d0, d1, x, n, ctx):
        ju = jnp.dot(u0["u"].grad - u1["u"].grad, n)
        jv = jnp.dot(v0["u"].grad - v1["u"].grad, n)
        return stab * ctx.h * ju * jv

    def rhs_bulk(v, d, x, ctx):
        return d["f"].val * v["u"].val

    def rhs_penalty(v, d, x, ctx):
        h = ctx.h
        return (
            pen / h**2 * d["uD"].val * (v["u"].val - d["phi"].val * v["p"].val / h)
        )

    def rhs_stab(v, d, x, ctx):
        return -stab * ctx.h**2 * d["f"].val * v["u"].lap

    cell_terms = [
        (CellTerm(stiffness, (1, 2), degree=2 * primal_degree, uniform=True), {}),
        (CellTerm(penalty, (2,), degree=qdeg), {"phi": phi_h}),
        (CellTerm(cell_stab, (2,), degree=2 * primal_degree, uniform=True), {}),
    ]
    facet_terms = [
        (FacetTerm(ghost, region=(2, 3), npts=max(2, primal_degree)), {})
    ]
    boundary_terms = [
        (BoundaryTerm(boundary_flux, ds, npts=primal_degree + 1), {})
    ]
    rhs_cell_terms = [
        # uniform => eligible for the data-linear vertex-stencil RHS path
        # (assembly._try_stencil_rhs) — the (1,2) bulk region is the whole
        # domain and per-cell tables cost O(ncells) device memory
        (CellTerm(rhs_bulk, (1, 2), degree=qdeg, uniform=True), {"f": f_h}),
        (
            CellTerm(rhs_penalty, (2,), degree=qdeg),
            {"f": f_h, "uD": u_D, "phi": phi_h},
        ),
        (CellTerm(rhs_stab, (2,), degree=qdeg), {"f": f_h}),
    ]
    return cell_terms, facet_terms, boundary_terms, rhs_cell_terms


@dataclasses.dataclass
class WeakDirichletPoisson(SchemeBase):
    """phi-FEM weak-Dirichlet Poisson solver."""

    primal_degree: int = 1
    levelset_degree: int = 1

    def setup(
        self,
        levelset: LevelSetLike,
        f: Union[Callable, Function],
        u_D: Union[Callable, Function, None] = None,
        detection_levelset: Optional[LevelSetLike] = None,
    ):
        """``levelset``: smooth phi used in the formulation;
        ``detection_levelset``: optional non-smooth phi for tagging only
        (the flower demo's split, ``demo/weak-dirichlet/flower/data.py:26,56``)."""
        g = self.grid
        self.tag(detection_levelset if detection_levelset is not None else levelset)

        V = Space.lagrange(g, self.primal_degree)
        Vphi = Space.lagrange(g, self.levelset_degree)
        self.V, self.Vphi = V, Vphi
        self.system = System({"u": V, "p": V})

        self.phi_h = levelset if isinstance(levelset, Function) else interpolate(levelset, Vphi)
        self.f_h = f if isinstance(f, Function) else interpolate(f, V)
        if u_D is None:
            u_D = lambda x: jnp.zeros(x.shape[:-1])
        self.u_D = u_D if isinstance(u_D, Function) else interpolate(u_D, V)
        self._setup_args = (levelset, f, u_D, detection_levelset)
        return self

    def assemble(self, rhs: bool = True):
        g = self.grid
        cell_terms, facet_terms, boundary_terms, rhs_cell_terms = s1_forms(
            self.pen_coef,
            self.stab_coef,
            self.primal_degree,
            self.levelset_degree,
            self.phi_h,
            self.f_h,
            self.u_D,
            self.boundary_measure(),
        )
        self.op = assemble_operator(
            self.system,
            g,
            cell_terms=cell_terms,
            facet_terms=facet_terms,
            boundary_terms=boundary_terms,
            cell_tags=self.cell_tags,
            facet_tags=self.facet_tags,
        )
        if not rhs:
            # operator-only path (multigrid coarse levels skip the RHS)
            return self
        self.b = assemble_vector(
            self.system,
            g,
            cell_terms=rhs_cell_terms,
            cell_tags=self.cell_tags,
        )
        return self

    def solve(self, method: str = "bicgstab", tol: float = 1e-10, **kw) -> SolveResult:
        res = solve(self.op, self.b, method=method, tol=tol, **kw)
        self.result = res
        self.u_h = Function(self.V, res.x["u"])
        self.p_h = Function(self.V, res.x["p"])
        return res
