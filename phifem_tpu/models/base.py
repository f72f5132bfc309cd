"""Shared scheme machinery: setup of tags/measures, error norms, solve."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import jax.numpy as jnp
import numpy as np

from ..assembly import CellTerm, Operator, System, assemble_cellwise, assemble_scalar
from ..grid import Grid
from ..measures import FacetSideList
from ..solvers import SolveResult, solve
from ..spaces import Function, Space, interpolate
from ..tagging import TagsMeasures, compute_tags_measures

Array = jnp.ndarray
LevelSetLike = Union[Callable, Function]


@dataclasses.dataclass
class SchemeBase:
    """Common state for the five phi-FEM schemes.

    ``mode``: "bg" solves on the background grid with one-sided boundary
    measures (reference box_mode=True); "sub" uses the submesh exterior
    measure (box_mode=False).  Both reference demo CLI modes are supported
    (``demo/weak-dirichlet/flower/main.py:17-29``).
    """

    grid: Grid
    mode: str = "bg"
    detection_degree: int = 1
    single_layer_cut: bool = False
    pen_coef: float = 1.0
    stab_coef: float = 1.0

    def tag(self, detection_levelset: LevelSetLike) -> TagsMeasures:
        """Tag the grid; dense parent-grid tags drive term regions in both
        modes (the submesh is an active-cell view of the same grid)."""
        res = compute_tags_measures(
            self.grid,
            detection_levelset,
            self.detection_degree,
            box_mode=True,
            single_layer_cut=self.single_layer_cut,
        )
        self.tags = res
        self.cell_tags = res.cells_tags.values
        self.facet_tags = res.facets_tags.values
        if self.mode == "sub":
            from ..tagging import _build_submesh

            self.submesh = _build_submesh(self.grid, self.cell_tags, self.facet_tags)
        else:
            self.submesh = None
        return res

    def boundary_measure(self) -> FacetSideList:
        """The scheme's ds on Gamma_h: one-sided id 100 in bg mode, submesh
        exterior in sub mode (reference main.py `ds = ds_bdy(100)` vs
        `ufl.Measure("ds", domain=submesh)`)."""
        if self.mode == "bg":
            return self.tags.boundaries_measure(100)
        return self.submesh.exterior

    # ------------------------------------------------------ multigrid
    def mg_preconditioner(self, min_n: int = 8, refresh: bool = False, **vcycle_kw):
        """Geometric V-cycle preconditioner with re-discretized (re-tagged,
        re-assembled) coarse levels — the CutFEM multigrid design.  Requires
        ``setup``+``assemble`` to have run; each scheme's setup records its
        arguments so coarse levels rebuild the same problem.

        The built V-cycle is memoized per argument set (coarse-level
        re-discretization + interface-block factorization are the expensive
        parts); pass ``refresh=True`` after the problem data changed (e.g.
        ``op.reassemble()`` with a new level set) to rebuild."""
        import dataclasses as _dc

        from ..mg import attach_interface_solve, build_hierarchy
        from ..solvers import masked_operator

        key = (min_n, repr(sorted(vcycle_kw.items())), self.op.data_version)
        cache = getattr(self, "_mg_cache", None)
        if cache is None:
            cache = self._mg_cache = {}
        if not refresh and key in cache:
            return cache[key]

        interface = vcycle_kw.pop("interface", True)
        interface_kw = {
            k[len("interface_"):]: vcycle_kw.pop(k)
            for k in list(vcycle_kw)
            if k.startswith("interface_")
        }

        def make_level(grid: Grid):
            if grid is self.grid:
                s = self
            else:
                s = _dc.replace(self, grid=grid)
                s.setup(*self._setup_args)
                s.assemble(rhs=False)
            return s.op, getattr(s, "bcs", ())

        vc = build_hierarchy(self.grid, make_level, min_n=min_n, **vcycle_kw)
        if interface:
            _, _, active = masked_operator(self.op, getattr(self, "bcs", ()))
            vc = attach_interface_solve(vc, self.op, active, **interface_kw)
        cache[key] = vc
        return vc

    def lattice_preconditioner(
        self,
        min_n: int = 16,
        dtype=jnp.float32,
        interface: bool = True,
        refresh: bool = False,
        ritz_modes: int = 0,
        ritz_arnoldi: Optional[int] = None,
        **interface_kw,
    ):
        """Full-box lattice V-cycle + cut-block interface correction
        (:class:`phifem_tpu.mg.LatticeBulkVCycle`) — the fast phi-FEM
        preconditioner.  Unlike :meth:`mg_preconditioner` it re-discretizes
        NOTHING per level: the bulk stencil is refinement-invariant and the
        cut-cell couplings are handled by the interface solve, so setup is
        seconds instead of minutes and the cycle runs as fused 2D slice
        arithmetic."""
        from ..assembly import Batch
        from ..mg import (
            LatticeBulkVCycle,
            Level,
            _masked_matvec,
            attach_interface_solve,
        )
        from ..ops.lattice import (
            block_vertex_stencil_weights,
            build_lattice_block_mg,
            build_lattice_mg,
            build_lattice_var_mg,
            vertex_stencil_weights,
        )
        from ..ops.stencil import _QUAD_OFFS, _TRI_OFFS, StencilCellBatch
        from ..solvers import masked_operator

        # op.data_version ties the cache to the operator's element-matrix
        # data: after op.reassemble() (new level-set/coefficients) a stale
        # V-cycle would keep interface/band inverses of the old matrices
        key = (
            "lattice",
            min_n,
            str(dtype),
            interface,
            ritz_modes,
            ritz_arnoldi,
            repr(sorted(interface_kw.items())),
            self.op.data_version,
        )
        cache = getattr(self, "_mg_cache", None)
        if cache is None:
            cache = self._mg_cache = {}
        if not refresh and key in cache:
            return cache[key]

        bcs = getattr(self, "bcs", ())
        matvec, inv_diag, active = _masked_matvec(self.op, bcs, dtype)
        g = self.grid
        offs = _TRI_OFFS if g.is_simplex else (_QUAD_OFFS,)
        neum = set(self._bulk_neumann_fields())
        ws: Dict[str, np.ndarray] = {}  # scalar P1: (3, 3) vertex stencils
        wsb: Dict[str, np.ndarray] = {}  # vector/tensor P1: (3,3,v,v) blocks
        # fields needing a FREE-boundary bulk cycle: (mats, indicator) pairs
        wsv: Dict[str, list] = {}
        for b in self.op.batches:
            if isinstance(b, StencilCellBatch):
                if b.field in neum:
                    ind = (
                        np.asarray(b.masks)
                        if b.masks is not None
                        else np.ones(
                            (2 if g.is_simplex else 1, g.ny, g.nx)
                        )
                    )
                    wsv.setdefault(b.field, []).append(
                        (np.asarray(b.matrices), ind)
                    )
                    continue
                w = vertex_stencil_weights(np.asarray(b.matrices), offs)
                ws[b.field] = ws.get(b.field, 0.0) + w
                continue
            # geometry-uniform single-field vector/tensor P1 cell batch
            # (e.g. the S5 elasticity bulk): aggregate its (vsz x vsz)
            # block vertex stencil for a LatticeBlockMG bulk cycle
            if (
                isinstance(b, Batch)
                and b.orient is not None
                and getattr(b, "rebuild", None) is None
                and len(b.segments) == 1
            ):
                name, dofs, vs = b.segments[0]
                sp = self.op.system.fields[name]
                if (
                    vs
                    and sp.element.family == "Lagrange"
                    and sp.degree == 1
                    and dofs.shape[1] == (3 if g.is_simplex else 4)
                ):
                    if name in neum and b.cells is not None:
                        from ..ops.lattice import orientation_cell_masks

                        sel = np.zeros(g.num_cells, bool)
                        sel[np.asarray(b.cells)] = True
                        wsv.setdefault(name, []).append(
                            (
                                np.asarray(b.matrices),
                                orientation_cell_masks(g, sel),
                            )
                        )
                        continue
                    wb = block_vertex_stencil_weights(
                        np.asarray(b.matrices), offs, sp.value_size
                    )
                    wsb[name] = wsb.get(name, 0.0) + wb
        # interface (h^-3 penalty) DoFs are excluded from the Laplacian
        # bulk cycle — corrections there come from the block solve only
        from ..mg import data_dependent_selection

        _, _, active_full = masked_operator(self.op, bcs)
        sel = data_dependent_selection(self.op, active_full)
        R, C = g.ny + 1, g.nx + 1
        all_fields = list(ws) + list(wsb) + list(wsv)
        bulk_np = {}
        vertex_np = {}
        for f in all_fields:
            vsz = self.op.system.fields[f].value_size
            act = np.broadcast_to(
                np.asarray(active_full[f]),
                self.op.system.fields[f].dof_shape,
            ).reshape(-1, vsz)
            m = act & ~np.asarray(sel[f]).reshape(-1, vsz)
            bulk_np[f] = m.reshape(self.op.system.fields[f].dof_shape)
            # the MG's per-vertex mask: bulk iff ALL components are bulk
            vertex_np[f] = m.all(axis=1).reshape(R, C)
        mgs = {}
        for f, w in ws.items():
            mgs[f] = build_lattice_mg(
                g.nx, g.ny, w, min_n=min_n, dtype=dtype, mask=vertex_np[f]
            )
        for f, wb in wsb.items():
            if not vertex_np[f].any():
                continue  # no bulk DoFs (cut-only field): Jacobi fallback
            mgs[f] = build_lattice_block_mg(
                g.nx, g.ny, wb, min_n=min_n, dtype=dtype, mask=vertex_np[f]
            )
        for f, contribs in wsv.items():
            if not vertex_np[f].any():
                continue
            mgs[f] = build_lattice_var_mg(
                g,
                contribs,
                self.op.system.fields[f].value_size,
                min_n=min_n,
                dtype=dtype,
                mask=vertex_np[f],
            )
        shapes = {f: (R, C) for f in all_fields}
        lvl = Level(g, matvec, inv_diag, active)
        bulk_masks = {f: jnp.asarray(m) for f, m in bulk_np.items()}
        vc = LatticeBulkVCycle(
            [lvl],
            tuple(mgs),
            dtype=dtype,
            mgs=mgs,
            lattice_shapes=shapes,
            bulk_masks=bulk_masks,
        )
        if interface:
            interface_kw.setdefault(
                "sweeps_coef", getattr(self, "_iface_sweeps_coef", 0.2)
            )
            vc = attach_interface_solve(vc, self.op, active_full, **interface_kw)
        builder = self._coarse_matrix_builder()
        if builder is not None:
            # device-side basis construction: nothing of size O(k * n)
            # crosses between host and device (see
            # mg.attach_coarse_correction_device)
            from ..mg import attach_coarse_correction_device

            vc = attach_coarse_correction_device(
                vc, self.op, active_full, builder[0], bcs
            )
        else:
            modes = self._coarse_modes()
            if modes:
                from ..mg import attach_coarse_correction

                vc = attach_coarse_correction(
                    vc, self.op, active_full, modes, bcs
                )
        if ritz_modes > 0:
            # GenEO-lite: harvest whatever slow modes the assembled cycle
            # STILL leaves (closed-form coarse spaces degrade at fine
            # grids under high contrast — see mg.attach_ritz_modes)
            from ..mg import attach_ritz_modes

            defl = self.rigid_modes() if hasattr(self, "rigid_modes") else ()
            vc = attach_ritz_modes(
                vc, self.op, active_full, bcs, deflate=defl,
                n_arnoldi=ritz_arnoldi or max(24, 3 * ritz_modes),
                n_keep=ritz_modes,
            )
        cache[key] = vc
        return vc

    def coupled_preconditioner(
        self,
        min_n: int = 16,
        dtype=jnp.float32,
        refresh: bool = False,
        max_coarse_dofs: int = 9000,
        **interface_kw,
    ):
        """Multilevel coupled hierarchy
        (:class:`phifem_tpu.mg.CoupledVCycle`): the SCHEME re-discretized
        on halved grids, each level smoothed by its own flat lattice
        preconditioner, dense pseudo-inverse coupled coarsest solve.

        Needed when the bulk/band splitting alone is h-dependent — i.e.
        for interface-TRANSMISSION systems (S5), where the two material
        bulks communicate only through the O(h)-thin cut band and the
        2-block preconditioner contracts at 1-O(h) even with exact
        sub-solves (dense study, see CoupledVCycle docstring)."""
        import dataclasses as _dc

        from ..grid import Grid
        from ..mg import CoupledVCycle, Level, _coarse_pinv, _masked_matvec

        key = (
            "coupled",
            min_n,
            str(dtype),
            max_coarse_dofs,
            repr(sorted(interface_kw.items())),
            self.op.data_version,
        )
        cache = getattr(self, "_mg_cache", None)
        if cache is None:
            cache = self._mg_cache = {}
        if not refresh and key in cache:
            return cache[key]

        levels = []
        s = self
        vertex_fields = None
        while True:
            g = s.grid
            bcs = getattr(s, "bcs", ())
            matvec, _, active = _masked_matvec(s.op, bcs, dtype)
            if vertex_fields is None:
                vertex_fields = tuple(
                    n for n, v in active.items()
                    if v.shape[0] == g.num_vertices
                )
            can_halve = (
                g.nx % 2 == 0
                and g.ny % 2 == 0
                and g.nx // 2 >= min_n
                and g.ny // 2 >= min_n
            )
            if not can_halve or s.op.system.num_dofs <= max_coarse_dofs:
                ci = _coarse_pinv(s.op, active)
                coarse = Level(
                    g,
                    matvec,
                    None,
                    active,
                    coarse_inv=ci.astype(dtype),
                    field_shapes={
                        n: tuple(sp.dof_shape)
                        for n, sp in s.op.system.fields.items()
                    },
                )
                break
            M = SchemeBase.lattice_preconditioner(
                s, min_n=min_n, dtype=dtype, **interface_kw
            )
            levels.append(
                {"op": s.op, "grid": g, "matvec": matvec, "active": active,
                 "M": M}
            )
            s2 = _dc.replace(s, grid=Grid(g.nx // 2, g.ny // 2, g.bbox,
                                          g.cell_type))
            s2.setup(*self._setup_args)
            s2.assemble(rhs=False)
            s = s2
        vc = CoupledVCycle(levels, coarse, vertex_fields, dtype=dtype)
        cache[key] = vc
        return vc

    def _coarse_modes(self) -> tuple:
        """Near-null mode pytrees for the preconditioner's rank-k Galerkin
        coarse correction (:func:`phifem_tpu.mg.attach_coarse_correction`).
        Schemes with floating (ungrounded) subdomains override — see
        ``InterfaceElasticity._coarse_modes``."""
        return ()

    def _coarse_matrix_builder(self):
        """Optional device-side coarse-basis builder ``(z_builder, k)``
        (preferred over :meth:`_coarse_modes` — no host mode upload; see
        :func:`phifem_tpu.mg.attach_coarse_correction_device`)."""
        return None

    def _p1_twin(self):
        """The same scheme with every FE degree lowered to 1 (level-set /
        detection degrees untouched — they are data representation, not
        solution space) — the p-multigrid coarse problem."""
        import dataclasses as _dc

        degree_fields = {"primal_degree", "flux_degree", "auxiliary_degree"}
        repl = {
            fld.name: 1
            for fld in _dc.fields(self)
            if fld.name in degree_fields
        }
        return _dc.replace(self, **repl)

    def p_multigrid_preconditioner(
        self,
        min_n: int = 16,
        dtype=jnp.float32,
        low_iters: int = 10,
        refresh: bool = False,
        **interface_kw,
    ):
        """p-multigrid preconditioner for degree>=2 systems: damped-Jacobi
        smoothing on the high-degree operator + a degree-1 rediscretized
        correction (solved by the P1 twin's lattice-MG machinery) + the
        multiplicative cut-band solve on the high-degree penalty block.
        The on-device replacement for routing high-degree systems through
        host SuperLU (see :mod:`phifem_tpu.pmg`); pair with
        ``method="fgmres"`` — the inner Krylov iterations make it
        nonstationary."""
        from ..pmg import build_p_preconditioner

        key = (
            "pmg", min_n, str(dtype), low_iters,
            repr(sorted(interface_kw.items())), self.op.data_version,
        )
        cache = getattr(self, "_mg_cache", None)
        if cache is None:
            cache = self._mg_cache = {}
        if not refresh and key in cache:
            return cache[key]
        vc = build_p_preconditioner(
            self, min_n=min_n, dtype=dtype, low_iters=low_iters,
            **interface_kw,
        )
        cache[key] = vc
        return vc

    def _bulk_neumann_fields(self) -> tuple:
        """Fields whose bulk lattice MG must use the FREE-boundary
        variable stencil (:class:`phifem_tpu.ops.lattice.LatticeVarMG`)
        instead of the Dirichlet-masked constant stencil: any field whose
        physical boundary condition at the immersed boundary is natural
        (traction/flux) rather than penalty-pinned.  With the Dirichlet
        treatment, the O(n)-dimensional harmonic-extension space of the
        region boundary is mis-corrected and outer Krylov iterations grow
        ~1/h (measured on S5: 15/39/108 at n=32/64/128)."""
        return ()

    # ------------------------------------------------------------- errors
    def l2_h1_errors(
        self,
        uh: Function,
        exact: Callable,
        region: Tuple[int, ...] = (1, 2),
        ref_degree: Optional[int] = None,
        vector: bool = False,
    ) -> Dict[str, float]:
        """Relative L2 and H1/H10 errors vs an analytic solution, computed
        like the reference demos: interpolate both into a degree+2 reference
        space, assemble DG0-local error fields, reduce
        (``demo/neumann/square/main.py:206-249``)."""
        g = self.grid
        deg = ref_degree or (uh.space.degree + 2)
        vs = uh.space.value_shape
        ref_space = Space.lagrange(g, deg, vs)
        u_ref = interpolate(uh, ref_space)
        uex_ref = interpolate(exact, ref_space)
        err = Function(ref_space, uex_ref.data - u_ref.data)

        def sq(v):
            return jnp.sum(v * v)

        l2_num = assemble_scalar(
            g,
            cell_terms=[
                (CellTerm(lambda d, x, ctx: sq(d["e"].val), region, degree=2 * deg), {"e": err})
            ],
            cell_tags=self.cell_tags,
        )
        l2_den = assemble_scalar(
            g,
            cell_terms=[
                (CellTerm(lambda d, x, ctx: sq(d["u"].val), region, degree=2 * deg), {"u": uex_ref})
            ],
            cell_tags=self.cell_tags,
        )
        h1_num = assemble_scalar(
            g,
            cell_terms=[
                (CellTerm(lambda d, x, ctx: sq(d["e"].grad), region, degree=2 * deg), {"e": err})
            ],
            cell_tags=self.cell_tags,
        )
        h1_den = assemble_scalar(
            g,
            cell_terms=[
                (CellTerm(lambda d, x, ctx: sq(d["u"].grad), region, degree=2 * deg), {"u": uex_ref})
            ],
            cell_tags=self.cell_tags,
        )
        return {
            "l2": float(jnp.sqrt(l2_num / l2_den)),
            "h10": float(jnp.sqrt(h1_num / h1_den)),
            "h1": float(jnp.sqrt((l2_num + h1_num) / (l2_den + h1_den))),
        }
