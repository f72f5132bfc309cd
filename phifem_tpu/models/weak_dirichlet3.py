"""3D weak (dual-penalty) Dirichlet phi-FEM Poisson on the hex lattice.

The z-axis extension of S1 (:mod:`phifem_tpu.models.weak_dirichlet`; the
reference, `demo/weak-dirichlet/flower/main.py:102-154`, is 2D-only).
Same variational scheme on Q_degree tensor-Lagrange hexahedra (degree
1-3; the reference parametrizes S1 over degrees 1-3 too,
`tests/test_compute_meshtags.py`):

  a(u,p; v,q) = int_{dx(1,2)} grad u . grad v
              - int_{Gamma_h} (grad u . n) v            (one-sided faces)
              + pen/h^2 int_{dx(2)} (u - phi p / h)(v - phi q / h)
              + stab int_{ghost faces} h [grad u . n][grad v . n]

  L(v,q)      = int_{dx(1,2)} f v
              + pen/h^2 int_{dx(2)} u_D (v - phi q / h)

(The 2D cell-stabilization h^2 (Δu)(Δv) vanishes identically for Q1 —
trilinear functions have zero PURE second derivatives cellwise, exactly
as P1 does in 2D — so it is dropped at degree 1 and assembled from the
tabulated second derivatives for degree >= 2, with the matching
-stab h^2 (f, Δv) consistency RHS.)

Structure (no generic FEM assembly in 3D): the bulk stiffness
is a cell-masked uniform 8-node stencil (64 shifted multiply-adds); ghost
and Gamma_h face matrices are STATIC per axis orientation (axis-aligned
faces of a uniform lattice — one (16,16) resp. (8,8) host-side matrix per
orientation, applied as batched matmuls over face index lists); only the
penalty's u-p / p-p blocks and its RHS depend on data (phi), computed as
batched quadrature einsums over the cut-cell list.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..grid3 import Grid3
from ..solvers import SolveResult
from ..tagging3 import Tags3, compute_tags3
from .lattice_core import (
    cached_equilibrated_solve,
    cell_dofs_of,
    cell_nodes_of,
    face_quadrature as _face_tables,
    faced_quadrature,
    float_dtype as _float_dtype,
    gauss01 as _gauss01,
    hex_offsets,
    hex_quadrature as _hex_tables,
    hex_shape as _shape,
    hexd_quadrature,
    lattice_l2_h1_errors,
    lattice_l2_h1_errors_d,
)

Array = jnp.ndarray

@dataclasses.dataclass
class WeakDirichletPoisson3:
    """3D phi-FEM weak-Dirichlet Poisson: -Δu = f in {phi<0}, u = u_D on
    {phi=0}, immersed in a structured hex box grid."""

    grid: Grid3
    pen_coef: float = 1.0
    stab_coef: float = 1.0
    degree: int = 1  # Q_degree tensor-Lagrange hexes (1, 2 or 3)

    # ------------------------------------------------------------ setup
    def setup(
        self,
        levelset: Callable,
        f: Callable,
        u_D: Optional[Callable] = None,
    ):
        g = self.grid
        dt = _float_dtype()
        self.tags: Tags3 = compute_tags3(g, levelset)
        # DoF nodes of the Q_d space = vertex lattice of the d-refined
        # grid; phi/f/u_D are interpolated at the NODES (phi_h is the
        # degree-d levelset, the reference's degree-2 phi_h for S3 at
        # `demo/neumann/square/main.py:49-51`)
        ng = (
            g
            if self.degree == 1
            else Grid3(
                self.degree * g.nx, self.degree * g.ny, self.degree * g.nz,
                g.bbox,
            )
        )
        self._node_grid = ng
        self.phi_lat = ng.eval_at_vertices(levelset, dt)
        self.f_lat = ng.eval_at_vertices(f, dt)
        if u_D is None:
            u_D = lambda x: jnp.zeros(x.shape[:-1])
        self.uD_lat = ng.eval_at_vertices(u_D, dt)
        return self

    # ------------------------------------------------- assembly (host prep)
    def assemble(self):
        g = self.grid
        dt = _float_dtype()
        hx, hy, hz = g.spacing
        h = float(np.sqrt(hx * hx + hy * hy + hz * hz))  # CellDiameter
        self.h = h
        vol = hx * hy * hz
        pen, stab = self.pen_coef, self.stab_coef
        d = self.degree
        D, R, C = self._node_grid.lattice_shape  # NODE lattice (= vertex
        self._DRC = (D, R, C)                    # lattice at degree 1)
        hs = np.array([hx, hy, hz])

        from ..ops.lattice3 import hex_element_matrix

        # bulk stiffness stencil + region mask (cells 1, 2)
        if d == 1:
            Abulk = hex_element_matrix(hx, hy, hz)
        else:
            W1, V1, G1, _ = hexd_quadrature(d + 1, d)
            Gs = G1 / hs[None, None, :]
            Abulk = vol * np.einsum("q,qik,qjk->ij", W1, Gs, Gs)
        self.A8 = jnp.asarray(Abulk, dt)  # (nloc, nloc); name from Q1
        self.bulk_mask = jnp.asarray(
            self.tags.region_mask((1, 2)).astype(np.float64), dt
        )

        # ---- cut-cell penalty: data-dependent blocks
        cells = self.tags.cut_cells()  # (ne, 3) iz, iy, ix
        self.cut_dofs = jnp.asarray(self._cell_dofs(cells), jnp.int32)
        # phi^2 * N_i * N_j: degree 4d per dim -> (2d+1)-pt Gauss exact
        if d == 1:
            W, V, _ = _hex_tables(3)
            Lap = None
        else:
            W, V, _G, S = hexd_quadrature(2 * d + 1, d)
            Lap = S[:, :, 0] / hx**2 + S[:, :, 1] / hy**2 + S[:, :, 2] / hz**2
        Vt = jnp.asarray(V, dt)
        Wt = jnp.asarray(W, dt)
        phi_n = jnp.asarray(self.phi_lat).reshape(-1)[self.cut_dofs]  # (ne, nloc)
        phi_q = phi_n @ Vt.T  # (ne, nq)
        # E_uu is uniform: pen/h^2 * mass (+ the h^2 (Lap u)(Lap v) cell
        # stabilization for d >= 2 — identically zero for Q1/P1, see the
        # module docstring; 2D twin: s1_forms' cell_stab)
        self.E_uu = (pen / h**2) * vol * jnp.einsum("q,qi,qj->ij", Wt, Vt, Vt)
        if Lap is not None:
            Lt = jnp.asarray(Lap, dt)
            self.E_uu = self.E_uu + stab * h**2 * vol * jnp.einsum(
                "q,qi,qj->ij", Wt, Lt, Lt
            )
        self.E_up = (-pen / h**3) * vol * jnp.einsum(
            "nq,q,qi,qj->nij", phi_q, Wt, Vt, Vt
        )
        self.E_pp = (pen / h**4) * vol * jnp.einsum(
            "nq,q,qi,qj->nij", phi_q * phi_q, Wt, Vt, Vt
        )

        # ---- ghost faces: static (2*nloc, 2*nloc) per lattice axis
        self.ghost = []
        for ax in range(3):
            faces = self.tags.ghost_faces[ax]
            if faces.shape[0] == 0:
                continue
            if d == 1:
                Wf, V0, G0, k = _face_tables(ax, at_upper=True)
                _, V1f, G1f, _ = _face_tables(ax, at_upper=False)
            else:
                Wf, V0, G0, k = faced_quadrature(ax, True, d + 1, d)
                _, V1f, G1f, _ = faced_quadrature(ax, False, d + 1, d)
            G1 = G1f
            area = vol / hs[k]
            dn0 = G0[:, :, k] / hs[k]  # (nq, 8) d/dx_k from the lower cell
            dn1 = G1[:, :, k] / hs[k]
            J = np.concatenate([dn0, -dn1], axis=1)  # (nq, 16) jump basis
            Eg = stab * h * area * np.einsum("q,qi,qj->ij", Wf, J, J)
            upper = faces.copy()
            upper[:, ax] += 1
            dofs = np.concatenate(
                [self._cell_dofs(faces), self._cell_dofs(upper)], axis=1
            )
            self.ghost.append(
                (jnp.asarray(dofs, jnp.int32), jnp.asarray(Eg, dt))
            )

        # ---- Gamma_h one-sided boundary flux: static (nloc, nloc) per
        # (axis, sign)
        self.bdry = []
        self.bdry_meta = []  # (inside cells, axis, sign) for measures
        for ax in range(3):
            for sign, faces in zip((+1, -1), self.tags.boundary_faces[ax]):
                if faces.shape[0] == 0:
                    continue
                # the inside cell's face: upper face for outward +e_k
                if d == 1:
                    Wf, Vf, Gf, k = _face_tables(ax, at_upper=(sign > 0))
                else:
                    Wf, Vf, Gf, k = faced_quadrature(ax, sign > 0, d + 1, d)
                area = vol / hs[k]
                dn = sign * Gf[:, :, k] / hs[k]  # outward-normal derivative
                Eb = -area * np.einsum("q,qi,qj->ij", Wf, Vf, dn)
                self.bdry.append(
                    (
                        jnp.asarray(self._cell_dofs(faces), jnp.int32),
                        jnp.asarray(Eb, dt),
                    )
                )
                self.bdry_meta.append((faces, ax, sign, area))

        # ---- RHS: masked bulk mass conv + penalty terms on cut cells
        if d == 1:
            M8 = hex_element_matrix(hx, hy, hz, stiffness=0.0, mass=1.0)
        else:
            M8 = vol * np.einsum("q,qi,qj->ij", W1, V1, V1)
        b_u = self._masked_stencil_apply(
            jnp.asarray(self.f_lat), jnp.asarray(M8, dt), self.bulk_mask
        )
        uD_n = jnp.asarray(self.uD_lat).reshape(-1)[self.cut_dofs]
        uD_q = uD_n @ Vt.T  # (ne, nq)
        r_u = (pen / h**2) * vol * jnp.einsum("nq,q,qi->ni", uD_q, Wt, Vt)
        if Lap is not None:
            # -stab h^2 (f, Lap v) dx(2) — the cell-stab consistency term
            # (2D twin: s1_forms' rhs_stab)
            f_q = jnp.asarray(self.f_lat).reshape(-1)[self.cut_dofs] @ Vt.T
            r_u = r_u - stab * h**2 * vol * jnp.einsum(
                "nq,q,qi->ni", f_q, Wt, Lt
            )
        r_p = (-pen / h**3) * vol * jnp.einsum(
            "nq,q,qi->ni", uD_q * phi_q, Wt, Vt
        )
        N = D * R * C
        b_u = b_u.reshape(-1).at[self.cut_dofs.reshape(-1)].add(r_u.reshape(-1))
        b_p = jnp.zeros(N, dt).at[self.cut_dofs.reshape(-1)].add(r_p.reshape(-1))
        self.b = {"u": b_u, "p": b_p}

        # ---- diagonal / active masks
        diag_u = self._masked_stencil_diag(self.A8, self.bulk_mask).reshape(-1)
        diag_u = diag_u.at[self.cut_dofs.reshape(-1)].add(
            jnp.broadcast_to(
                jnp.diag(self.E_uu), self.cut_dofs.shape
            ).reshape(-1)
        )
        for dofs, Eg in self.ghost:
            diag_u = diag_u.at[dofs.reshape(-1)].add(
                jnp.broadcast_to(jnp.diag(Eg), dofs.shape).reshape(-1)
            )
        for dofs, Eb in self.bdry:
            diag_u = diag_u.at[dofs.reshape(-1)].add(
                jnp.broadcast_to(jnp.diag(Eb), dofs.shape).reshape(-1)
            )
        diag_p = jnp.zeros(N, dt).at[self.cut_dofs.reshape(-1)].add(
            jax.vmap(jnp.diag)(self.E_pp).reshape(-1)
        )
        active = {"u": diag_u != 0.0, "p": diag_p != 0.0}
        diag = {
            "u": jnp.where(active["u"], diag_u, 1.0),
            "p": jnp.where(active["p"], diag_p, 1.0),
        }
        self.diag, self.active = diag, active
        return self

    def _cell_dofs(self, cells: np.ndarray) -> np.ndarray:
        """(ne, nloc) int flat NODE indices of cells (ne, 3) = (iz, iy, ix)
        on the degree-refined node lattice."""
        if self.degree == 1:
            return cell_dofs_of(self.grid.lattice_shape, cells)
        return cell_nodes_of(
            self._node_grid.lattice_shape, cells, self.degree
        )

    # --------------------------------------------- lattice stencil pieces
    def _masked_stencil_apply(self, X: Array, A8: Array, mask: Array) -> Array:
        """y[n_i] += mask_cell * sum_j A8[i,j] x[n_j] over all cells —
        stride-``degree`` shifted slices on the node lattice (corner
        slices at degree 1)."""
        nz, ny, nx = mask.shape
        d = self.degree
        offs = hex_offsets(d)
        nloc = len(offs)
        Y = jnp.zeros_like(X)
        xl = [
            X[oz : oz + d * nz : d, oy : oy + d * ny : d, ox : ox + d * nx : d]
            for (ox, oy, oz) in offs
        ]
        for i, (oxi, oyi, ozi) in enumerate(offs):
            zi = sum(A8[i, j] * xl[j] for j in range(nloc))
            Y = Y.at[
                ozi : ozi + d * nz : d,
                oyi : oyi + d * ny : d,
                oxi : oxi + d * nx : d,
            ].add(mask * zi)
        return Y

    def _masked_stencil_diag(self, A8: Array, mask: Array) -> Array:
        nz, ny, nx = mask.shape
        D, R, C = self._DRC
        d = self.degree
        Dg = jnp.zeros((D, R, C), mask.dtype)
        for i, (oxi, oyi, ozi) in enumerate(hex_offsets(d)):
            Dg = Dg.at[
                ozi : ozi + d * nz : d,
                oyi : oyi + d * ny : d,
                oxi : oxi + d * nx : d,
            ].add(mask * A8[i, i])
        return Dg

    # ------------------------------------------------------------- matvec
    def matvec(self, x: Dict[str, Array]) -> Dict[str, Array]:
        D, R, C = self._DRC
        u3 = x["u"].reshape(D, R, C)
        y_u = self._masked_stencil_apply(u3, self.A8, self.bulk_mask).reshape(-1)
        y_p = jnp.zeros_like(x["p"])
        # penalty block (cut cells)
        ug = x["u"][self.cut_dofs]  # (ne, 8)
        pg = x["p"][self.cut_dofs]
        yu = ug @ self.E_uu.T + jnp.einsum("nij,nj->ni", self.E_up, pg)
        yp = jnp.einsum("nji,nj->ni", self.E_up, ug) + jnp.einsum(
            "nij,nj->ni", self.E_pp, pg
        )
        y_u = y_u.at[self.cut_dofs.reshape(-1)].add(yu.reshape(-1))
        y_p = y_p.at[self.cut_dofs.reshape(-1)].add(yp.reshape(-1))
        # ghost faces (static per-axis matrices)
        for dofs, Eg in self.ghost:
            y_u = y_u.at[dofs.reshape(-1)].add(
                (x["u"][dofs] @ Eg.T).reshape(-1)
            )
        # one-sided boundary flux
        for dofs, Eb in self.bdry:
            y_u = y_u.at[dofs.reshape(-1)].add(
                (x["u"][dofs] @ Eb.T).reshape(-1)
            )
        return {"u": y_u, "p": y_p}

    def _all_term_blocks(self):
        """Every operator term as (row_dofs, col_dofs, mats) entity
        batches in global flat ids (u in [0, N), p in [N, 2N)) — the FULL
        system, for the sparse direct path (`_interface_csr` builds only
        the data-dependent subset)."""
        D, R, C = self._DRC
        N = D * R * C
        cut = np.asarray(self.cut_dofs)
        nloc = cut.shape[1]
        ne = cut.shape[0]
        pen_dofs = np.concatenate([cut, N + cut], axis=1)
        blk = np.zeros((ne, 2 * nloc, 2 * nloc))
        blk[:, :nloc, :nloc] = np.asarray(self.E_uu)[None]
        Eup = np.asarray(self.E_up)
        blk[:, :nloc, nloc:] = Eup
        blk[:, nloc:, :nloc] = np.swapaxes(Eup, 1, 2)
        blk[:, nloc:, nloc:] = np.asarray(self.E_pp)
        blocks = [(pen_dofs, pen_dofs, blk)]
        for dofs, Eg in self.ghost:
            d = np.asarray(dofs)
            blocks.append((d, d, np.asarray(Eg)))
        for dofs, Eb in self.bdry:
            d = np.asarray(dofs)
            blocks.append((d, d, np.asarray(Eb)))
        cells = np.argwhere(self.tags.region_mask((1, 2))).astype(np.int32)
        cdofs = self._cell_dofs(cells)
        blocks.append((cdofs, cdofs, np.asarray(self.A8)))
        return blocks

    # -------------------------------------------------------------- solve
    def solve(
        self,
        method: str = "bicgstab",
        tol: float = 1e-10,
        maxiter: int = 4000,
        precond=None,
    ) -> SolveResult:
        """Equilibrated Krylov with identity on inactive DoFs — the 3D
        analogue of solvers.solve's jitted runner (lattice_core).
        ``method="sparse"`` runs a host SuperLU direct solve instead (the
        MUMPS-LU analogue — the robust path for degree >= 2 penalized
        systems, whose plain-Jacobi Krylov conditioning is poor)."""
        if method == "sparse":
            from .lattice_core import lattice_sparse_solve

            D, R, C = self._DRC
            N = D * R * C
            dt = _float_dtype()
            act = np.concatenate(
                [np.asarray(self.active["u"]), np.asarray(self.active["p"])]
            )
            bf = np.concatenate(
                [np.asarray(self.b["u"]), np.asarray(self.b["p"])]
            )
            xf = lattice_sparse_solve(self._all_term_blocks(), bf, act)
            x = {"u": jnp.asarray(xf[:N], dt), "p": jnp.asarray(xf[N:], dt)}
            Ax = self.matvec(x)
            r = np.concatenate(
                [np.asarray(Ax["u"]), np.asarray(Ax["p"])]
            ) - bf
            r[~act] = 0.0
            nb = float(np.linalg.norm(bf[act]))
            rel = float(np.linalg.norm(r)) / max(nb, 1e-300)
            self.u_lat = x["u"].reshape(self._DRC)
            self.result = SolveResult(
                x=x, residual=rel, iterations=0, converged=rel <= 1e-8
            )
            return self.result
        x, rel, it = cached_equilibrated_solve(
            self, method, tol, maxiter, precond
        )
        self.u_lat = x["u"].reshape(self._DRC)
        self.result = SolveResult(
            x=x, residual=rel, iterations=it, converged=rel <= 10 * tol
        )
        return self.result

    # ------------------------------------------------------ preconditioner
    def _interface_csr(self):
        """Host-side sparse interface matrix: global flat ids (u in [0, N),
        p in [N, 2N)) of the data-dependent DoF block, the CSR A_II
        restricted to it, and the per-entity overlapping blocks (RAS)."""
        import scipy.sparse as sp

        D, R, C = self._DRC
        N = D * R * C
        cut = np.asarray(self.cut_dofs)
        act_u = np.asarray(self.active["u"])
        act_p = np.asarray(self.active["p"])

        rows, cols, vals = [], [], []
        entity_dofs = []

        def add_block(dofs, mats):
            """dofs (ne, L) global; mats (ne, L, L) or (L, L) shared."""
            ne, L = dofs.shape
            m = np.broadcast_to(np.asarray(mats), (ne, L, L))
            rows.append(np.broadcast_to(dofs[:, :, None], m.shape))
            cols.append(np.broadcast_to(dofs[:, None, :], m.shape))
            vals.append(m)
            entity_dofs.extend(dofs)

        nloc = cut.shape[1]
        pen_dofs = np.concatenate([cut, N + cut], axis=1)  # (ne, 2*nloc)
        ne = cut.shape[0]
        Euu = np.asarray(self.E_uu)
        Eup = np.asarray(self.E_up)
        Epp = np.asarray(self.E_pp)
        blk = np.zeros((ne, 2 * nloc, 2 * nloc))
        blk[:, :nloc, :nloc] = Euu[None]
        blk[:, :nloc, nloc:] = Eup
        blk[:, nloc:, :nloc] = np.swapaxes(Eup, 1, 2)
        blk[:, nloc:, nloc:] = Epp
        add_block(pen_dofs, blk)
        for dofs, Eg in self.ghost:
            add_block(np.asarray(dofs), np.asarray(Eg))
        for dofs, Eb in self.bdry:
            add_block(np.asarray(dofs), np.asarray(Eb))

        sel = np.zeros(2 * N, bool)
        for d in (pen_dofs,):
            sel[d.reshape(-1)] = True
        for dofs, _ in self.ghost:
            sel[np.asarray(dofs).reshape(-1)] = True
        for dofs, _ in self.bdry:
            sel[np.asarray(dofs).reshape(-1)] = True
        sel[:N] &= act_u
        sel[N:] &= act_p

        # bulk stiffness entries among selected u DoFs
        in_h = self.tags.region_mask((1, 2))
        cells = np.argwhere(in_h).astype(np.int32)
        cdofs = self._cell_dofs(cells)
        touch = sel[cdofs].any(axis=1)
        A8 = np.asarray(self.A8)
        add_block(cdofs[touch], A8)

        ids = np.where(sel)[0]
        m = ids.shape[0]
        idx_of = -np.ones(2 * N, np.int64)
        idx_of[ids] = np.arange(m)
        r = np.concatenate([v.reshape(-1) for v in rows])
        c = np.concatenate([v.reshape(-1) for v in cols])
        v = np.concatenate([v.reshape(-1) for v in vals])
        rl, cl = idx_of[r], idx_of[c]
        keep = (rl >= 0) & (cl >= 0)
        A = sp.coo_matrix(
            (v[keep], (rl[keep], cl[keep])), shape=(m, m)
        ).tocsr()
        # per-entity overlapping blocks in compact index space (RAS)
        blocks = []
        for d in entity_dofs:
            bl = idx_of[d]
            bl = np.unique(bl[bl >= 0])
            if bl.size:
                blocks.append(bl)
        return ids, A, blocks

    def lattice_preconditioner(
        self,
        min_n: int = 4,
        dtype=jnp.float32,
        interface: bool = True,
        dense_max: int = 4000,
        sweeps: Optional[int] = None,
    ):
        """Masked 3D lattice V-cycle on the u-bulk (non-cut Omega_h
        vertices) + damped Jacobi elsewhere + a multiplicative solve on
        the cut/ghost/boundary DoF block — the 3D analogue of
        SchemeBase.lattice_preconditioner (cut-cell DoFs are excluded from
        the Laplacian cycle: their penalty-scaled rows diverge under
        Laplacian-sized corrections, see mg.LatticeBulkVCycle; the block
        solve is dense-inverse <= dense_max DoFs, else inner BiCGStab on
        the device-resident ELL band with RAS block preconditioning).

        For degree >= 2 the bulk cycle is LOW-ORDER-REFINED (LOR): the Q1
        lattice MG on the degree-refined NODE grid, which is spectrally
        equivalent to the Q_degree Laplacian (classic LOR/"FEM-SEM"
        equivalence) — no high-order smoother needed."""
        from ..ops.lattice3 import build_lattice3_mg

        ng = self._node_grid
        d = self.degree
        D, R, C = self._DRC
        N = D * R * C
        # u bulk nodes: touched by region-1 cells only (no cut cell)
        in1 = self.tags.cell_tags == 1
        cut = self.tags.cell_tags == 2
        touch1 = np.zeros((D, R, C), bool)
        touch_cut = np.zeros((D, R, C), bool)
        nz, ny, nx = in1.shape
        for (ox, oy, oz) in hex_offsets(d):
            touch1[
                oz : oz + d * nz : d, oy : oy + d * ny : d, ox : ox + d * nx : d
            ] |= in1
            touch_cut[
                oz : oz + d * nz : d, oy : oy + d * ny : d, ox : ox + d * nx : d
            ] |= cut
        bulk = touch1 & ~touch_cut
        mg = build_lattice3_mg(
            ng.nx, ng.ny, ng.nz, ng.spacing, min_n=min_n, dtype=dtype,
            mask=bulk,
        )
        bulk_j = jnp.asarray(bulk)
        inv_diag = jax.tree.map(lambda d: 1.0 / d, self.diag)
        active = self.active
        omega = 0.67

        iface = None
        if interface:
            ids, A_csr, blocks = self._interface_csr()
            m = ids.shape[0]
            if m <= dense_max:
                Ad = A_csr.todense()
                iface = ("dense", jnp.asarray(ids), jnp.asarray(np.linalg.inv(Ad)))
            else:
                K = max(bl.size for bl in blocks)
                nb = len(blocks)
                bids = np.full((nb, K), m, np.int64)
                for i, bl in enumerate(blocks):
                    bids[i, : bl.size] = bl
                owner = -np.ones(m, np.int64)
                own = np.zeros((nb, K), bool)
                for i, bl in enumerate(blocks):
                    new = bl[owner[bl] < 0]
                    owner[new] = i
                    own[i, : bl.size] = owner[blocks[i]] == i
                mats = np.zeros((nb, K, K))
                mats[:, np.arange(K), np.arange(K)] = 1.0
                for i, bl in enumerate(blocks):
                    Ab = np.asarray(A_csr[bl][:, bl].todense())
                    dz0 = np.abs(np.diag(Ab)) < 1e-300
                    Ab[dz0, dz0] = 1.0
                    mats[i, : bl.size, : bl.size] = Ab
                inv = np.linalg.inv(mats)
                nnz_row = np.diff(A_csr.indptr)
                nnzmax = max(1, int(nnz_row.max()))
                ecols = np.full((m, nnzmax), m, np.int64)
                evals = np.zeros((m, nnzmax))
                rows_rep = np.repeat(np.arange(m), nnz_row)
                offs2 = np.arange(A_csr.nnz) - np.repeat(
                    A_csr.indptr[:-1], nnz_row
                )
                ecols[rows_rep, offs2] = A_csr.indices
                evals[rows_rep, offs2] = A_csr.data
                zr = nnz_row == 0
                ecols[zr, 0] = np.where(zr)[0]
                evals[zr, 0] = 1.0
                n_sweeps = (
                    sweeps if sweeps is not None else max(10, int(0.3 * m**0.5))
                )
                iface = (
                    "schwarz",
                    jnp.asarray(ids),
                    jnp.asarray(bids),
                    jnp.asarray(inv),
                    jnp.asarray(own),
                    jnp.asarray(ecols, jnp.int32),
                    jnp.asarray(evals),
                    n_sweeps,
                )

        def precond(r):
            r3 = jnp.where(bulk_j, r["u"].reshape(D, R, C), 0.0)
            rp = jnp.zeros((D + 2, R + 2, C + 2), r3.dtype).at[
                1 : 1 + D, 1 : 1 + R, 1 : 1 + C
            ].set(r3)
            z3 = mg(rp)[1 : 1 + D, 1 : 1 + R, 1 : 1 + C]
            jac_u = omega * r["u"] * inv_diag["u"]
            z_u = jnp.where(
                bulk_j.reshape(-1),
                z3.reshape(-1),
                jnp.where(active["u"], jac_u, 0.0),
            )
            z_p = jnp.where(active["p"], omega * r["p"] * inv_diag["p"], 0.0)
            x = {"u": z_u, "p": z_p}
            if iface is None:
                return x
            # multiplicative block correction on the residual
            Ax = self.matvec(
                jax.tree.map(
                    lambda xi, mm: jnp.where(mm, xi, 0.0), x, active
                )
            )
            res = {
                "u": jnp.where(active["u"], r["u"] - Ax["u"], 0.0),
                "p": jnp.where(active["p"], r["p"] - Ax["p"], 0.0),
            }
            rf = jnp.concatenate([res["u"], res["p"]])
            if iface[0] == "dense":
                _, ids_j, inv_j = iface
                corr = inv_j.astype(rf.dtype) @ rf[ids_j]
            else:
                _, ids_j, bids, binv, own, ecols, evals, n_sweeps = iface
                rb = rf[ids_j]
                dt = rb.dtype
                mloc = rb.shape[0]

                def band_mv(v):
                    vpad = jnp.concatenate([v, jnp.zeros(1, dt)])
                    return (evals.astype(dt) * vpad[ecols]).sum(axis=1)

                def band_ras(v):
                    vpad = jnp.concatenate([v, jnp.zeros(1, dt)])
                    cb = jnp.einsum(
                        "bkl,bl->bk", binv.astype(dt), vpad[bids]
                    )
                    upd = jnp.where(own, cb, 0.0)
                    out = jnp.zeros(mloc + 1, dt).at[bids].add(upd)
                    return out[:mloc]

                # fixed-sweep fori_loop (see mg._band_bicgstab): bounded
                # work and a far smaller compiled graph than the
                # scipy-style nested while_loop
                from ..mg import _band_bicgstab

                corr = _band_bicgstab(band_mv, band_ras, rb, n_sweeps)
            xf = jnp.concatenate([x["u"], x["p"]]).at[ids_j].add(corr)
            return {"u": xf[:N], "p": xf[N:]}

        return precond

    # ------------------------------------------------------------- errors
    def l2_h1_errors(self, exact: Callable, region=(1, 2)) -> Dict[str, float]:
        """Relative L2/H10 errors of u_h vs a callable, by cellwise Gauss
        quadrature over the region cells (lattice_core)."""
        if self.degree == 1:
            return lattice_l2_h1_errors(
                self.grid, self.tags.region_mask(region), self.u_lat, exact
            )
        return lattice_l2_h1_errors_d(
            self.grid, self.tags.region_mask(region), self.u_lat, exact,
            self.degree,
        )
