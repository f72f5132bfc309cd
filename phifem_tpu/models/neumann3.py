"""S3 in 3D — Neumann phi-FEM (mixed flux formulation) on the hex lattice.

The z-axis extension of :mod:`phifem_tpu.models.neumann` (the reference,
``demo/neumann/square/main.py:112-158``, is 2D-only):

  -Delta u + u = f in Omega,  du/dn = u_N on Gamma

Fields: u (Q1), y ~ -grad u (Q1 3-vector), p (DG0 auxiliary):

  a = int_{dx(1,2)} (grad u . grad v + u v)
    + int_{Gamma_h} (y . n) v                               (one-sided faces)
    + pen int_{dx(2)} [ (y + grad u).(z + grad v)
                      + (div y + u)(div z + v)
                      + h^-2 (y.grad phi + h^-1 p phi)(z.grad phi + h^-1 q phi) ]
    + stab int_{ghost faces} h [grad u . n][grad v . n]

  L = int_{dx(1,2)} f v
    + pen int_{dx(2)} [ -h^-2 u_N |grad phi| (z.grad phi + h^-1 q phi)
                      + f (div z + v) ]

Structure (mirrors :mod:`weak_dirichlet3`): the bulk
(grad-grad + mass) is a cell-masked uniform 8-node stencil; the one-sided
Gamma_h flux couples u-rows to one y channel through a STATIC (8, 8) face
mass matrix per (axis, side); ghost faces are the static (16, 16) jump
matrices; only the cut-cell penalty block depends on phi — its local
(33, 33) matrices over [u(8) | y_x(8) | y_y(8) | y_z(8) | p(1)] split into
a shared static part and a per-cell phi part, both batched einsums.
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
    HEX_OFFS,
    cached_equilibrated_solve,
    cell_dofs_of,
    face_quadrature,
    float_dtype,
    hex_quadrature,
    hex_quadrature_points,
    lattice_l2_h1_errors,
)

Array = jnp.ndarray

# local dof layout inside a cut cell: u vertices, then each y channel's
# vertices, then the cell's single DG0 p value
_NLOC = 8 + 24 + 1


@dataclasses.dataclass
class NeumannPoisson3:
    """3D phi-FEM Neumann Poisson (mixed flux scheme) on a hex box grid."""

    grid: Grid3
    pen_coef: float = 1.0
    stab_coef: float = 1.0

    # ------------------------------------------------------------ setup
    def setup(self, levelset: Callable, f: Callable, u_N: Callable):
        g = self.grid
        dt = float_dtype()
        self.tags: Tags3 = compute_tags3(g, levelset)
        # phi, grad phi, u_N and f are evaluated ANALYTICALLY at the
        # cut-cell quadrature points during assembly: the reference's S3
        # needs a degree-2 discrete levelset (demo/neumann/square/main.py:49-51
        # — a P1 phi_h's piecewise-constant gradient costs one order of L2
        # convergence in the flux-enforcement term); with callables we can
        # skip interpolation entirely.
        self._levelset, self._f, self._uN = levelset, f, u_N
        self.f_lat = g.eval_at_vertices(f, dt)
        return self

    # ------------------------------------------------- assembly (host prep)
    def assemble(self):
        g = self.grid
        dt = float_dtype()
        hx, hy, hz = g.spacing
        h = float(np.sqrt(hx * hx + hy * hy + hz * hz))  # CellDiameter
        self.h = h
        vol = hx * hy * hz
        pen, stab = self.pen_coef, self.stab_coef
        D, R, C = g.lattice_shape
        self._DRC = (D, R, C)
        N = D * R * C
        nc = g.num_cells
        hs = np.array([hx, hy, hz])

        from ..ops.lattice3 import hex_element_matrix

        # bulk grad-grad + mass stencil, masked to Omega_h cells {1, 2}
        self.A8 = jnp.asarray(hex_element_matrix(hx, hy, hz, 1.0, 1.0), dt)
        self.bulk_mask = jnp.asarray(
            self.tags.region_mask((1, 2)).astype(np.float64), dt
        )

        # ---- cut-cell penalty block over [u | y_x | y_y | y_z | p]
        cells = self.tags.cut_cells()  # (ne, 3) iz, iy, ix
        cut_np = cell_dofs_of((D, R, C), cells)
        self.cut_dofs = jnp.asarray(cut_np, jnp.int32)
        self.cut_cells_flat = jnp.asarray(
            (cells[:, 0] * g.ny + cells[:, 1]) * g.nx + cells[:, 2],
            jnp.int32,
        )
        W, V, G = hex_quadrature(3)
        nq = W.shape[0]
        Gp = G / hs[None, None, :]  # physical gradients (nq, 8, 3)

        # static factor tables (nq, 33)
        F1 = np.zeros((3, nq, _NLOC))  # (y + grad u)_c
        for c in range(3):
            F1[c, :, :8] = Gp[:, :, c]
            F1[c, :, 8 + 8 * c : 16 + 8 * c] = V
        F2 = np.zeros((nq, _NLOC))  # div y + u
        F2[:, :8] = V
        for c in range(3):
            F2[:, 8 + 8 * c : 16 + 8 * c] = Gp[:, :, c]
        E_stat = vol * np.einsum("q,cqi,cqj->ij", W, F1, F1)
        E_stat += vol * np.einsum("q,qi,qj->ij", W, F2, F2)
        self.E_stat = pen * jnp.asarray(E_stat, dt)

        # phi-dependent factor F3 = y.grad phi + p phi / h  (ne, nq, 33),
        # with phi/grad phi ANALYTIC at the quadrature points (see setup)
        Vt = jnp.asarray(V, dt)
        Wt = jnp.asarray(W, dt)
        Pq = hex_quadrature_points(3)  # (nq, 3) ref coords (x, y, z)
        (x0, y0, z0), _ = g.bbox
        orig = np.stack(
            [
                x0 + hx * cells[:, 2],
                y0 + hy * cells[:, 1],
                z0 + hz * cells[:, 0],
            ],
            axis=-1,
        )  # (ne, 3) physical cell origin
        pts = jnp.asarray(
            orig[:, None, :] + (Pq * hs[None, :])[None, :, :], dt
        )  # (ne, nq, 3)
        ls = self._levelset
        phi_q = ls(pts)  # (ne, nq)
        gphi = jax.vmap(jax.vmap(jax.grad(lambda p: ls(p[None])[0])))(pts)
        ne = cut_np.shape[0]
        F3 = self._build_flux_factor(Vt, phi_q, gphi, h, ne, nq, dt)
        self.E_phi = (pen / h**2) * vol * jnp.einsum(
            "nqi,q,nqj->nij", F3, Wt, F3
        )

        # ---- ghost faces: static (16, 16) jump matrices per lattice axis
        self.ghost = []
        ghost_lists = self._ghost_face_lists()
        for ax in range(3):
            faces = ghost_lists[ax]
            if faces.shape[0] == 0:
                continue
            Wf, V0, G0, k = face_quadrature(ax, at_upper=True)
            _, V1, G1, _ = face_quadrature(ax, at_upper=False)
            area = vol / hs[k]
            dn0 = G0[:, :, k] / hs[k]
            dn1 = G1[:, :, k] / hs[k]
            J = np.concatenate([dn0, -dn1], axis=1)  # (nqf, 16)
            Eg = stab * h * area * np.einsum("q,qi,qj->ij", Wf, J, J)
            upper = faces.copy()
            upper[:, ax] += 1
            dofs = np.concatenate(
                [cell_dofs_of((D, R, C), faces), cell_dofs_of((D, R, C), upper)],
                axis=1,
            )
            self.ghost.append((jnp.asarray(dofs, jnp.int32), jnp.asarray(Eg, dt)))

        # ---- Gamma_h one-sided flux (y . n) v: static (8, 8) face mass
        # per (axis, sign); couples u rows to the y channel normal to the
        # face (no y-row contribution — the term is genuinely one-sided,
        # like the 2D BoundaryTerm at models/neumann.py:85-87)
        self.flux = []  # (dofs (nf, 8), Eb (8, 8), channel k)
        for ax in range(3):
            for sign, faces in zip((+1, -1), self.tags.boundary_faces[ax]):
                if faces.shape[0] == 0:
                    continue
                Wf, Vf, _, k = face_quadrature(ax, at_upper=(sign > 0))
                area = vol / hs[k]
                Eb = sign * area * np.einsum("q,qi,qj->ij", Wf, Vf, Vf)
                self.flux.append(
                    (
                        jnp.asarray(cell_dofs_of((D, R, C), faces), jnp.int32),
                        jnp.asarray(Eb, dt),
                        k,
                    )
                )

        # ---- RHS
        M8 = hex_element_matrix(hx, hy, hz, stiffness=0.0, mass=1.0)
        b_u = _masked_stencil_apply(
            jnp.asarray(self.f_lat), jnp.asarray(M8, dt), self.bulk_mask
        ).reshape(-1)
        f_q = self._f(pts)  # analytic at the cut-cell quadrature points
        uN_q = self._uN(pts)
        ngphi = jnp.sqrt(jnp.sum(gphi * gphi, axis=-1))  # (ne, nq)
        F2t = jnp.asarray(F2, dt)
        r_loc = pen * vol * (
            jnp.einsum("nq,q,qi->ni", f_q, Wt, F2t)
            - jnp.einsum("nq,q,nqi->ni", uN_q * ngphi, Wt, F3) / h**2
        )
        b_u = b_u.at[self.cut_dofs.reshape(-1)].add(r_loc[:, :8].reshape(-1))
        b_y = jnp.zeros((3, N), dt)
        for c in range(3):
            b_y = b_y.at[c].add(
                jnp.zeros(N, dt).at[self.cut_dofs.reshape(-1)].add(
                    r_loc[:, 8 + 8 * c : 16 + 8 * c].reshape(-1)
                )
            )
        b_p = jnp.zeros(nc, dt).at[self.cut_cells_flat].add(r_loc[:, 32])
        self.b = {"u": b_u, "y": b_y, "p": b_p}

        # ---- diagonal / active masks
        E_diag = jnp.diag(self.E_stat)[None, :] + jax.vmap(jnp.diag)(self.E_phi)
        diag_u = _masked_stencil_diag(self.A8, self.bulk_mask, (D, R, C)).reshape(-1)
        diag_u = diag_u.at[self.cut_dofs.reshape(-1)].add(
            E_diag[:, :8].reshape(-1)
        )
        for dofs, Eg in self.ghost:
            diag_u = diag_u.at[dofs.reshape(-1)].add(
                jnp.broadcast_to(jnp.diag(Eg), dofs.shape).reshape(-1)
            )
        diag_y = jnp.zeros((3, N), dt)
        for c in range(3):
            diag_y = diag_y.at[c].add(
                jnp.zeros(N, dt).at[self.cut_dofs.reshape(-1)].add(
                    E_diag[:, 8 + 8 * c : 16 + 8 * c].reshape(-1)
                )
            )
        diag_p = jnp.zeros(nc, dt).at[self.cut_cells_flat].add(E_diag[:, 32])
        active = {"u": diag_u != 0.0, "y": diag_y != 0.0, "p": diag_p != 0.0}
        self.diag = {
            k: jnp.where(active[k], d, 1.0)
            for k, d in (("u", diag_u), ("y", diag_y), ("p", diag_p))
        }
        self.active = active
        return self

    # --------------------------------------------------------- overridables
    def _build_flux_factor(self, Vt, phi_q, gphi, h, ne, nq, dt) -> Array:
        """(ne, nq, 33) coefficient table of the penalized flux factor
        ``y . grad phi + h^-1 p phi`` (S4 overrides to add the Robin
        ``-|grad phi| alpha u`` slot, models/robin.py:60-68)."""
        F3 = jnp.zeros((ne, nq, _NLOC), dt)
        for c in range(3):
            F3 = F3.at[:, :, 8 + 8 * c : 16 + 8 * c].set(
                gphi[:, :, c : c + 1] * Vt[None, :, :]
            )
        return F3.at[:, :, 32].set(phi_q / h)

    def _ghost_face_lists(self):
        """Per-lattice-axis ghost-face index lists; S3 stabilizes every
        Omega_h face touching a cut cell (the 2D dS(3) analogue)."""
        return self.tags.ghost_faces

    # ------------------------------------------------------------- matvec
    def matvec(self, x: Dict[str, Array]) -> Dict[str, Array]:
        D, R, C = self._DRC
        u3 = x["u"].reshape(D, R, C)
        y_u = _masked_stencil_apply(u3, self.A8, self.bulk_mask).reshape(-1)
        y_y = jnp.zeros_like(x["y"])
        y_p = jnp.zeros_like(x["p"])

        # cut-cell penalty block (static + phi parts)
        loc = jnp.concatenate(
            [x["u"][self.cut_dofs]]
            + [x["y"][c][self.cut_dofs] for c in range(3)]
            + [x["p"][self.cut_cells_flat][:, None]],
            axis=1,
        )  # (ne, 33)
        out = loc @ self.E_stat.T + jnp.einsum("nij,nj->ni", self.E_phi, loc)
        y_u = y_u.at[self.cut_dofs.reshape(-1)].add(out[:, :8].reshape(-1))
        for c in range(3):
            y_y = y_y.at[c, self.cut_dofs.reshape(-1)].add(
                out[:, 8 + 8 * c : 16 + 8 * c].reshape(-1)
            )
        y_p = y_p.at[self.cut_cells_flat].add(out[:, 32])

        # ghost stabilization (u only)
        for dofs, Eg in self.ghost:
            y_u = y_u.at[dofs.reshape(-1)].add((x["u"][dofs] @ Eg.T).reshape(-1))

        # one-sided Gamma_h flux: u rows <- y_k columns
        for dofs, Eb, k in self.flux:
            y_u = y_u.at[dofs.reshape(-1)].add(
                (x["y"][k][dofs] @ Eb.T).reshape(-1)
            )
        return {"u": y_u, "y": y_y, "p": y_p}

    # -------------------------------------------------------------- solve
    def solve(
        self,
        method: str = "bicgstab",
        tol: float = 1e-10,
        maxiter: int = 8000,
        precond=None,
    ) -> SolveResult:
        x, rel, it = cached_equilibrated_solve(
            self, method, tol, maxiter, precond
        )
        self.u_lat = x["u"].reshape(self._DRC)
        self.result = SolveResult(
            x=x, residual=rel, iterations=it, converged=rel <= 10 * tol
        )
        return self.result

    # ------------------------------------------------------ preconditioner
    def lattice_preconditioner(
        self,
        min_n: int = 4,
        dtype=jnp.float32,
        dense_max: int = 4000,
        sweeps: Optional[int] = None,
    ):
        """Masked 3D lattice V-cycle on the u-bulk (non-cut Omega_h
        vertices, the grad-grad + mass operator) + damped Jacobi on the
        remaining active DoFs + a multiplicative solve on the
        cut/ghost/flux DoF block — the S3 analogue of
        WeakDirichletPoisson3.lattice_preconditioner (bulk MG alone is
        WORSE than Jacobi without the cut-block correction; see
        CLAUDE.md 3D notes)."""
        from ..ops.lattice3 import build_lattice3_mg
        from .lattice_core import build_interface_block, make_interface_apply

        g = self.grid
        D, R, C = self._DRC
        N = D * R * C
        nc = g.num_cells
        in1 = self.tags.cell_tags == 1
        cut = self.tags.cell_tags == 2
        touch1 = np.zeros((D, R, C), bool)
        touch_cut = np.zeros((D, R, C), bool)
        nz, ny, nx = in1.shape
        for (dx, dy, dz) in HEX_OFFS:
            touch1[dz : dz + nz, dy : dy + ny, dx : dx + nx] |= in1
            touch_cut[dz : dz + nz, dy : dy + ny, dx : dx + nx] |= cut
        bulk = touch1 & ~touch_cut
        mg = build_lattice3_mg(
            g.nx, g.ny, g.nz, g.spacing, stiffness=1.0, mass=1.0,
            min_n=min_n, dtype=dtype, mask=bulk,
        )
        bulk_j = jnp.asarray(bulk)
        inv_diag = jax.tree.map(lambda d: 1.0 / d, self.diag)
        active = self.active
        omega = 0.67

        # global flat layout: u [0, N), y_c [(1+c)N, (2+c)N), p [4N, 4N+nc)
        total = 4 * N + nc
        cut_np = np.asarray(self.cut_dofs)
        cells_flat = np.asarray(self.cut_cells_flat)
        pen_dofs = np.concatenate(
            [cut_np]
            + [(1 + c) * N + cut_np for c in range(3)]
            + [4 * N + cells_flat[:, None]],
            axis=1,
        )  # (ne, 33)
        pen_mats = np.asarray(self.E_stat)[None] + np.asarray(self.E_phi)
        blocks = [(pen_dofs, pen_dofs, pen_mats)]
        for dofs, Eg in self.ghost:
            blocks.append((np.asarray(dofs), np.asarray(dofs), np.asarray(Eg)))
        for dofs, Eb, k in self.flux:
            d = np.asarray(dofs)
            blocks.append((d, (1 + k) * N + d, np.asarray(Eb)))
        # bulk rows among selected u DoFs (grad-grad + mass stencil)
        sel_u = np.zeros(N, bool)
        sel_u[pen_dofs[:, :8].reshape(-1)] = True
        for dofs, _ in self.ghost:
            sel_u[np.asarray(dofs).reshape(-1)] = True
        for dofs, _, _ in self.flux:
            sel_u[np.asarray(dofs).reshape(-1)] = True
        in_h = self.tags.region_mask((1, 2))
        cells_h = np.argwhere(in_h).astype(np.int32)
        cdofs = cell_dofs_of((D, R, C), cells_h)
        touch = sel_u[cdofs].any(axis=1)
        blocks.append((cdofs[touch], cdofs[touch], np.asarray(self.A8)))

        selectable = np.concatenate(
            [np.asarray(active["u"])]
            + [np.asarray(active["y"][c]) for c in range(3)]
            + [np.asarray(active["p"])]
        )
        ids, A_csr, ras = build_interface_block(blocks, total, selectable)
        # the mixed 33-local-dof block needs more inner band-solve sweeps
        # than S1's scalar one (default 0.3 sqrt(m) diverges; 0.8 sqrt(m)
        # measured convergent at n=16..32)
        if sweeps is None:
            sweeps = max(40, int(0.8 * len(ids) ** 0.5))
        iface = make_interface_apply(
            ids, A_csr, ras, dense_max=dense_max, sweeps=sweeps
        )

        def split(xf):
            return {
                "u": xf[:N],
                "y": xf[N : 4 * N].reshape(3, N),
                "p": xf[4 * N :],
            }

        def flat(x):
            return jnp.concatenate([x["u"], x["y"].reshape(-1), x["p"]])

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
            z_y = jnp.where(active["y"], omega * r["y"] * inv_diag["y"], 0.0)
            z_p = jnp.where(active["p"], omega * r["p"] * inv_diag["p"], 0.0)
            x = {"u": z_u, "y": z_y, "p": z_p}
            # multiplicative interface-block correction on the residual
            Ax = self.matvec(
                jax.tree.map(lambda xi, mm: jnp.where(mm, xi, 0.0), x, active)
            )
            res = jax.tree.map(
                lambda ri, ai, mm: jnp.where(mm, ri - ai, 0.0), r, Ax, active
            )
            ids_j, corr = iface(flat(res))
            return split(flat(x).at[ids_j].add(corr))

        return precond

    # ------------------------------------------------------------- errors
    def l2_h1_errors(self, exact: Callable, region=(1, 2)) -> Dict[str, float]:
        return lattice_l2_h1_errors(
            self.grid, self.tags.region_mask(region), self.u_lat, exact
        )


def _masked_stencil_apply(X: Array, A8: Array, mask: Array) -> Array:
    """y[v_i] += mask_cell * sum_j A8[i,j] x[v_j] over all cells."""
    nz, ny, nx = mask.shape
    Y = jnp.zeros_like(X)
    xl = [
        X[dz : dz + nz, dy : dy + ny, dx : dx + nx] for (dx, dy, dz) in HEX_OFFS
    ]
    for i, (dxi, dyi, dzi) in enumerate(HEX_OFFS):
        zi = sum(A8[i, j] * xl[j] for j in range(8))
        Y = Y.at[dzi : dzi + nz, dyi : dyi + ny, dxi : dxi + nx].add(mask * zi)
    return Y


def _masked_stencil_diag(A8: Array, mask: Array, DRC) -> Array:
    nz, ny, nx = mask.shape
    D, R, C = DRC
    Dg = jnp.zeros((D, R, C), mask.dtype)
    for i, (dxi, dyi, dzi) in enumerate(HEX_OFFS):
        Dg = Dg.at[dzi : dzi + nz, dyi : dyi + ny, dxi : dxi + nx].add(
            mask * A8[i, i]
        )
    return Dg
