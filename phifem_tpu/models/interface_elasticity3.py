"""S5 in 3D — two-material interface elasticity on the hex lattice.

The z-axis extension of :mod:`phifem_tpu.models.interface_elasticity`
(the reference, ``demo/interface-elasticity/main.py:145-277``, is
2D-only): div sigma_i(u_i) = f on each side of the immersed interface
{phi = 0} with E_in/E_out contrast, continuity of displacement and
traction imposed by phi-weighted penalties on cut cells, exact Dirichlet
BC on the outer box faces.

Fields (all Q1 vertex lattices, stored channels-flat ``c*N + vertex``):

  ui, uo : displacement per side, 3 channels
  yi, yo : tensor flux ~ -sigma per side, 9 channels (row-major (a, b))
  p      : vector auxiliary, 3 channels

Bilinear form (the 2D scheme's terms, reference line refs in
:mod:`interface_elasticity`):

  a = int_{dx(1,2)} sigma_in(ui) : eps(vi)
    + int_{dx(2,3)} sigma_out(uo) : eps(vo)
    + pen int_{dx(2)} [ coef_out |yi + sigma_in(grad ui)|^2-form
                      + coef_in  |yo + sigma_out(grad uo)|^2-form
                      + h^-2 |(yi - yo) . grad phi|^2-form
                      + h^-2 |ui - uo + h^-1 p phi|^2-form ]
    + stab int_{dx(2)} h^2 (div yi . div zi + div yo . div zo)
    + stab int_{dS(1|2)} h [sigma_in(grad ui) n][...]   (in-side ghost)
    + stab int_{dS(2|3)} h [sigma_out(grad uo) n][...]  (out-side ghost)
    + int_{ds(100)} (yi . n) . vi   (Gamma_h one-sided from {1,2})
    + int_{ds(101)} (yo . n) . vo   (one-sided from {2,3} toward {1})

Structure (mirrors :mod:`neumann3`): per-side bulk stiffness
is a cell-masked uniform (24, 24) block vertex stencil; ghost faces are
static (48, 48) per-axis jump matrices; one-sided flux terms are static
(8, 8) face-mass couplings between a u channel and its normal flux
channel; only the cut-cell penalty block depends on phi — its local
(216, 216) matrices over [ui(24) | uo(24) | yi(72) | yo(72) | p(24)]
split into a shared static part and a per-cell phi part.
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
from .interface_elasticity import lame
from .lattice_core import (
    HEX_OFFS,
    cached_equilibrated_solve,
    cell_dofs_of,
    face_quadrature,
    float_dtype,
    hex_quadrature,
    hex_quadrature_points,
    lattice_l2_h1_errors_vec,
)
from .neumann3 import _masked_stencil_apply

Array = jnp.ndarray

# local dof layout inside a cut cell: 3 ui channels, 3 uo, 9 yi, 9 yo,
# 3 p — each channel contributes its 8 vertex values, channel-major
_OFF_UI, _OFF_UO, _OFF_YI, _OFF_YO, _OFF_P = 0, 24, 48, 120, 192
_NLOC = 216


def _sigma_factor(Gp: np.ndarray, lmbda: float, mu: float) -> np.ndarray:
    """(nq, 3, 3, 24) coefficient table: sigma(grad u)[a, b] as a linear
    functional of the 24 local displacement dofs (channel c, node i ->
    column 8c + i), given physical basis gradients ``Gp`` (nq, 8, 3)."""
    nq = Gp.shape[0]
    S = np.zeros((nq, 3, 3, 24))
    for a in range(3):
        for b in range(3):
            for c in range(3):
                sl = slice(8 * c, 8 * c + 8)
                if a == b:
                    S[:, a, b, sl] += lmbda * Gp[:, :, c]
                if c == a:
                    S[:, a, b, sl] += mu * Gp[:, :, b]
                if c == b:
                    S[:, a, b, sl] += mu * Gp[:, :, a]
    return S


def _eps_factor(Gp: np.ndarray) -> np.ndarray:
    """(nq, 3, 3, 24) strain table eps(grad u)[a, b] over the 24 dofs."""
    return _sigma_factor(Gp, 0.0, 0.5)


def _div_factor(Gp: np.ndarray) -> np.ndarray:
    """(nq, 3, 72) table: div y[a] = sum_b d_b y[a, b] over the 72 local
    tensor dofs (channel (a, b) = 3a + b, node i -> column 8(3a+b)+i)."""
    nq = Gp.shape[0]
    D = np.zeros((nq, 3, 72))
    for a in range(3):
        for b in range(3):
            D[:, a, 8 * (3 * a + b) : 8 * (3 * a + b) + 8] = Gp[:, :, b]
    return D


def _elastic_element_matrix(
    hx: float, hy: float, hz: float, lmbda: float, mu: float
) -> np.ndarray:
    """(24, 24) Q1-hex linear-elasticity element matrix
    int sigma(u) : eps(v) (the vector analogue of
    ``ops.lattice3.hex_element_matrix``)."""
    W, _, G = hex_quadrature(2)
    Gp = G / np.array([hx, hy, hz])[None, None, :]
    S = _sigma_factor(Gp, lmbda, mu)
    E = _eps_factor(Gp)
    vol = hx * hy * hz
    return vol * np.einsum("q,qabi,qabj->ij", W, S, E)


def _masked_block_stencil_apply(X: Array, K: Array, mask: Array) -> Array:
    """y[c, v_i] += mask_cell * sum_{c', j} K[8c+i, 8c'+j] x[c', v_j] over
    all cells — the (3x3)-block vector form of
    :func:`neumann3._masked_stencil_apply`."""
    nz, ny, nx = mask.shape
    Y = jnp.zeros_like(X)
    xl = [
        [
            X[c, dz : dz + nz, dy : dy + ny, dx : dx + nx]
            for (dx, dy, dz) in HEX_OFFS
        ]
        for c in range(3)
    ]
    for ci in range(3):
        for i, (dxi, dyi, dzi) in enumerate(HEX_OFFS):
            zi = sum(
                K[8 * ci + i, 8 * cj + j] * xl[cj][j]
                for cj in range(3)
                for j in range(8)
            )
            Y = Y.at[ci, dzi : dzi + nz, dyi : dyi + ny, dxi : dxi + nx].add(
                mask * zi
            )
    return Y


def _masked_block_stencil_diag(K: Array, mask: Array, DRC) -> Array:
    nz, ny, nx = mask.shape
    D, R, C = DRC
    Dg = jnp.zeros((3, D, R, C), mask.dtype)
    for c in range(3):
        for i, (dxi, dyi, dzi) in enumerate(HEX_OFFS):
            Dg = Dg.at[c, dzi : dzi + nz, dyi : dyi + ny, dxi : dxi + nx].add(
                mask * K[8 * c + i, 8 * c + i]
            )
    return Dg


@dataclasses.dataclass
class InterfaceElasticity3:
    """3D phi-FEM two-material interface elasticity on a hex box grid."""

    grid: Grid3
    pen_coef: float = 1.0
    stab_coef: float = 1.0
    E_in: float = 1.0
    nu_in: float = 0.3
    E_out: float = 0.001
    nu_out: float = 0.3

    # ------------------------------------------------------------ setup
    def setup(self, levelset: Callable, f: Callable, u_dbc: Callable):
        g = self.grid
        self.tags: Tags3 = compute_tags3(g, levelset)
        self._levelset, self._f, self._u_dbc = levelset, f, u_dbc
        self.lmbda_in, self.mu_in = lame(self.E_in, self.nu_in)
        self.lmbda_out, self.mu_out = lame(self.E_out, self.nu_out)
        return self

    # ------------------------------------------------- assembly (host prep)
    def assemble(self):
        g = self.grid
        dt = float_dtype()
        hx, hy, hz = g.spacing
        h = float(np.sqrt(hx * hx + hy * hy + hz * hz))
        self.h = h
        vol = hx * hy * hz
        pen, stab = self.pen_coef, self.stab_coef
        D, R, C = g.lattice_shape
        self._DRC = (D, R, C)
        N = D * R * C
        self._N = N
        hs = np.array([hx, hy, hz])
        li, mi = self.lmbda_in, self.mu_in
        lo, mo = self.lmbda_out, self.mu_out
        coef_in = (self.E_in / (self.E_in + self.E_out)) ** 2
        coef_out = (self.E_out / (self.E_in + self.E_out)) ** 2

        # ---- per-side bulk stiffness: uniform (24, 24) block stencils
        self.K_in = jnp.asarray(_elastic_element_matrix(hx, hy, hz, li, mi), dt)
        self.K_out = jnp.asarray(_elastic_element_matrix(hx, hy, hz, lo, mo), dt)
        self.mask_in = jnp.asarray(
            self.tags.region_mask((1, 2)).astype(np.float64), dt
        )
        self.mask_out = jnp.asarray(
            self.tags.region_mask((2, 3)).astype(np.float64), dt
        )

        # ---- cut-cell penalty block over [ui | uo | yi | yo | p]
        cells = self.tags.cut_cells()
        cut_np = cell_dofs_of((D, R, C), cells)  # (ne, 8)
        ne = cut_np.shape[0]
        idxU = np.concatenate([c * N + cut_np for c in range(3)], axis=1)
        idxY = np.concatenate([c * N + cut_np for c in range(9)], axis=1)
        self.idxU = jnp.asarray(idxU, jnp.int32)  # (ne, 24)
        self.idxY = jnp.asarray(idxY, jnp.int32)  # (ne, 72)

        W, V, G = hex_quadrature(3)
        nq = W.shape[0]
        Gp = G / hs[None, None, :]
        Si = _sigma_factor(Gp, li, mi)  # (nq, 3, 3, 24)
        So = _sigma_factor(Gp, lo, mo)
        Dv = _div_factor(Gp)  # (nq, 3, 72)

        # static penalty factors: t1 = yi + sigma_in(grad ui) (9 comps),
        # t2 = yo + sigma_out(grad uo); cell stab divs (3 comps per side)
        F1 = np.zeros((nq, 3, 3, _NLOC))
        F2 = np.zeros((nq, 3, 3, _NLOC))
        for a in range(3):
            for b in range(3):
                ch = 3 * a + b
                F1[:, a, b, _OFF_YI + 8 * ch : _OFF_YI + 8 * ch + 8] = V
                F2[:, a, b, _OFF_YO + 8 * ch : _OFF_YO + 8 * ch + 8] = V
        F1[:, :, :, _OFF_UI : _OFF_UI + 24] += Si
        F2[:, :, :, _OFF_UO : _OFF_UO + 24] += So
        D1 = np.zeros((nq, 3, _NLOC))
        D2 = np.zeros((nq, 3, _NLOC))
        D1[:, :, _OFF_YI : _OFF_YI + 72] = Dv
        D2[:, :, _OFF_YO : _OFF_YO + 72] = Dv
        E_stat = pen * vol * (
            coef_out * np.einsum("q,qabi,qabj->ij", W, F1, F1)
            + coef_in * np.einsum("q,qabi,qabj->ij", W, F2, F2)
        )
        E_stat += stab * h**2 * vol * (
            np.einsum("q,qai,qaj->ij", W, D1, D1)
            + np.einsum("q,qai,qaj->ij", W, D2, D2)
        )
        self.E_stat = jnp.asarray(E_stat, dt)
        self._D12 = (D1, D2)  # reused by the RHS stab term

        # phi-dependent factors (phi ANALYTIC at the quadrature points —
        # see neumann3.setup's rationale): t3[a] = (yi - yo)[a, :].grad phi,
        # t4[a] = ui_a - uo_a + h^-1 p_a phi, both weighted pen/h^2
        Pq = hex_quadrature_points(3)
        (x0, y0, z0), _ = g.bbox
        orig = np.stack(
            [
                x0 + hx * cells[:, 2],
                y0 + hy * cells[:, 1],
                z0 + hz * cells[:, 0],
            ],
            axis=-1,
        )
        pts = jnp.asarray(
            orig[:, None, :] + (Pq * hs[None, :])[None, :, :], dt
        )  # (ne, nq, 3)
        self._cut_pts = pts
        ls = self._levelset
        phi_q = ls(pts)  # (ne, nq)
        gphi = jax.vmap(jax.vmap(jax.grad(lambda p: ls(p[None])[0])))(pts)
        Vt = jnp.asarray(V, dt)
        Wt = jnp.asarray(W, dt)
        F34 = jnp.zeros((ne, nq, 6, _NLOC), dt)
        for a in range(3):
            for b in range(3):
                ch = 3 * a + b
                blk = gphi[:, :, b, None] * Vt[None, :, :]
                F34 = F34.at[
                    :, :, a, _OFF_YI + 8 * ch : _OFF_YI + 8 * ch + 8
                ].set(blk)
                F34 = F34.at[
                    :, :, a, _OFF_YO + 8 * ch : _OFF_YO + 8 * ch + 8
                ].set(-blk)
            F34 = F34.at[:, :, 3 + a, _OFF_UI + 8 * a : _OFF_UI + 8 * a + 8].set(
                jnp.broadcast_to(Vt[None], (ne, nq, 8))
            )
            F34 = F34.at[:, :, 3 + a, _OFF_UO + 8 * a : _OFF_UO + 8 * a + 8].set(
                jnp.broadcast_to(-Vt[None], (ne, nq, 8))
            )
            F34 = F34.at[:, :, 3 + a, _OFF_P + 8 * a : _OFF_P + 8 * a + 8].set(
                (phi_q / h)[:, :, None] * Vt[None, :, :]
            )
        self.E_phi = (pen / h**2) * vol * jnp.einsum(
            "nqki,q,nqkj->nij", F34, Wt, F34
        )

        # ---- per-side ghost faces: static (48, 48) jump matrices
        # in-side dS(1|2), out-side dS(2|3) — the 2D S5 regions (3,)/(4,)
        self.ghost = []  # (dofs48 (nf, 48), Eg (48, 48), field)
        fam_in = self.tags.jump_faces_between((1,), (2,))
        fam_out = self.tags.jump_faces_between((2,), (3,))
        for field, fam, (lm, mm) in (
            ("ui", fam_in, (li, mi)),
            ("uo", fam_out, (lo, mo)),
        ):
            for ax in range(3):
                faces = fam[ax]
                if faces.shape[0] == 0:
                    continue
                Wf, V0, G0, k = face_quadrature(ax, at_upper=True)
                _, V1, G1, _ = face_quadrature(ax, at_upper=False)
                area = vol / hs[k]
                S0 = _sigma_factor(G0 / hs[None, None, :], lm, mm)
                S1 = _sigma_factor(G1 / hs[None, None, :], lm, mm)
                # jump of (sigma n)[a] with n = +e_k across the face
                J = np.concatenate([S0[:, :, k, :], -S1[:, :, k, :]], axis=2)
                Eg = stab * h * area * np.einsum("q,qai,qaj->ij", Wf, J, J)
                upper = faces.copy()
                upper[:, ax] += 1
                lo8 = cell_dofs_of((D, R, C), faces)
                hi8 = cell_dofs_of((D, R, C), upper)
                dofs = np.concatenate(
                    [c * N + lo8 for c in range(3)]
                    + [c * N + hi8 for c in range(3)],
                    axis=1,
                )
                self.ghost.append(
                    (jnp.asarray(dofs, jnp.int32), jnp.asarray(Eg, dt), field)
                )

        # ---- one-sided interface flux terms (ds(100) + ds(101)):
        # u[a] rows <- y[3a+k] columns through a signed face mass matrix
        self.flux = []  # (cell_dofs8, Eb (8, 8), k, ufield)
        b100 = self.tags.faces_between((1, 2), (3,))
        b101 = self.tags.faces_between((2, 3), (1,))
        for ufield, fam in (("ui", b100), ("uo", b101)):
            for ax in range(3):
                for sign, faces in zip((+1, -1), fam[ax]):
                    if faces.shape[0] == 0:
                        continue
                    Wf, Vf, _, k = face_quadrature(ax, at_upper=(sign > 0))
                    area = vol / hs[k]
                    Eb = sign * area * np.einsum("q,qi,qj->ij", Wf, Vf, Vf)
                    self.flux.append(
                        (
                            jnp.asarray(
                                cell_dofs_of((D, R, C), faces), jnp.int32
                            ),
                            jnp.asarray(Eb, dt),
                            k,
                            ufield,
                        )
                    )

        # ---- RHS: f.v per side + stab h^2 f.(div z) on cut cells
        from ..ops.lattice3 import hex_element_matrix

        M8 = jnp.asarray(
            hex_element_matrix(hx, hy, hz, stiffness=0.0, mass=1.0), dt
        )
        f_lat = g.eval_at_vertices(self._f, dt)  # (D, R, C, 3)
        b_ui = jnp.stack(
            [
                _masked_stencil_apply(f_lat[..., c], M8, self.mask_in)
                for c in range(3)
            ]
        ).reshape(-1)
        b_uo = jnp.stack(
            [
                _masked_stencil_apply(f_lat[..., c], M8, self.mask_out)
                for c in range(3)
            ]
        ).reshape(-1)
        f_q = self._f(pts)  # (ne, nq, 3) analytic at cut quadrature points
        D12 = jnp.asarray(D1 + D2, dt)  # both sides' div slots
        r_loc = stab * h**2 * vol * jnp.einsum(
            "nqa,q,qai->ni", f_q, Wt, D12
        )
        b_yi = jnp.zeros(9 * N, dt).at[self.idxY.reshape(-1)].add(
            r_loc[:, _OFF_YI : _OFF_YI + 72].reshape(-1)
        )
        b_yo = jnp.zeros(9 * N, dt).at[self.idxY.reshape(-1)].add(
            r_loc[:, _OFF_YO : _OFF_YO + 72].reshape(-1)
        )
        b = {
            "ui": b_ui,
            "uo": b_uo,
            "yi": b_yi,
            "yo": b_yo,
            "p": jnp.zeros(3 * N, dt),
        }

        # ---- diagonal / active masks
        E_diag = jnp.diag(self.E_stat)[None, :] + jax.vmap(jnp.diag)(self.E_phi)

        def scatter_diag(size, idx, vals):
            return jnp.zeros(size, dt).at[idx.reshape(-1)].add(vals.reshape(-1))

        diag_ui = _masked_block_stencil_diag(
            self.K_in, self.mask_in, (D, R, C)
        ).reshape(-1)
        diag_uo = _masked_block_stencil_diag(
            self.K_out, self.mask_out, (D, R, C)
        ).reshape(-1)
        diag_ui += scatter_diag(3 * N, self.idxU, E_diag[:, _OFF_UI : _OFF_UI + 24])
        diag_uo += scatter_diag(3 * N, self.idxU, E_diag[:, _OFF_UO : _OFF_UO + 24])
        diag_yi = scatter_diag(9 * N, self.idxY, E_diag[:, _OFF_YI : _OFF_YI + 72])
        diag_yo = scatter_diag(9 * N, self.idxY, E_diag[:, _OFF_YO : _OFF_YO + 72])
        diag_p = scatter_diag(3 * N, self.idxU, E_diag[:, _OFF_P : _OFF_P + 24])
        for dofs, Eg, field in self.ghost:
            add = jnp.broadcast_to(jnp.diag(Eg), dofs.shape).reshape(-1)
            if field == "ui":
                diag_ui = diag_ui.at[dofs.reshape(-1)].add(add)
            else:
                diag_uo = diag_uo.at[dofs.reshape(-1)].add(add)

        # Dirichlet BC on the ui block over the outer box faces with
        # lifting (reference main.py:158-177): identity rows via the
        # active mask, b <- b - A x_bc, x <- w + x_bc after the solve
        bshell = jnp.asarray(
            np.broadcast_to(
                g.boundary_mask_lattice().reshape(-1), (3, N)
            ).reshape(-1)
        )
        ubc_lat = g.eval_at_vertices(self._u_dbc, dt)  # (D, R, C, 3)
        x_bc = jnp.where(
            bshell,
            jnp.stack([ubc_lat[..., c].reshape(-1) for c in range(3)]).reshape(-1),
            0.0,
        )
        self.x_bc = {
            "ui": x_bc,
            "uo": jnp.zeros(3 * N, dt),
            "yi": jnp.zeros(9 * N, dt),
            "yo": jnp.zeros(9 * N, dt),
            "p": jnp.zeros(3 * N, dt),
        }
        active = {
            "ui": (diag_ui != 0.0) & ~bshell,
            "uo": diag_uo != 0.0,
            "yi": diag_yi != 0.0,
            "yo": diag_yo != 0.0,
            "p": diag_p != 0.0,
        }
        self.active = active
        self.diag = {
            "ui": jnp.where(active["ui"], diag_ui, 1.0),
            "uo": jnp.where(active["uo"], diag_uo, 1.0),
            "yi": jnp.where(active["yi"], diag_yi, 1.0),
            "yo": jnp.where(active["yo"], diag_yo, 1.0),
            "p": jnp.where(active["p"], diag_p, 1.0),
        }
        Axbc = self.matvec(self.x_bc)
        self.b = jax.tree.map(lambda bi, ai: bi - ai, b, Axbc)
        return self

    # ------------------------------------------------------------- matvec
    def matvec(self, x: Dict[str, Array]) -> Dict[str, Array]:
        D, R, C = self._DRC
        N = self._N
        y_ui = _masked_block_stencil_apply(
            x["ui"].reshape(3, D, R, C), self.K_in, self.mask_in
        ).reshape(-1)
        y_uo = _masked_block_stencil_apply(
            x["uo"].reshape(3, D, R, C), self.K_out, self.mask_out
        ).reshape(-1)
        y_yi = jnp.zeros_like(x["yi"])
        y_yo = jnp.zeros_like(x["yo"])
        y_p = jnp.zeros_like(x["p"])

        # cut-cell penalty block (static + phi parts)
        loc = jnp.concatenate(
            [
                x["ui"][self.idxU],
                x["uo"][self.idxU],
                x["yi"][self.idxY],
                x["yo"][self.idxY],
                x["p"][self.idxU],
            ],
            axis=1,
        )  # (ne, 216)
        out = loc @ self.E_stat.T + jnp.einsum("nij,nj->ni", self.E_phi, loc)
        y_ui = y_ui.at[self.idxU.reshape(-1)].add(
            out[:, _OFF_UI : _OFF_UI + 24].reshape(-1)
        )
        y_uo = y_uo.at[self.idxU.reshape(-1)].add(
            out[:, _OFF_UO : _OFF_UO + 24].reshape(-1)
        )
        y_yi = y_yi.at[self.idxY.reshape(-1)].add(
            out[:, _OFF_YI : _OFF_YI + 72].reshape(-1)
        )
        y_yo = y_yo.at[self.idxY.reshape(-1)].add(
            out[:, _OFF_YO : _OFF_YO + 72].reshape(-1)
        )
        y_p = y_p.at[self.idxU.reshape(-1)].add(
            out[:, _OFF_P : _OFF_P + 24].reshape(-1)
        )

        # per-side ghost stabilization
        for dofs, Eg, field in self.ghost:
            if field == "ui":
                y_ui = y_ui.at[dofs.reshape(-1)].add(
                    (x["ui"][dofs] @ Eg.T).reshape(-1)
                )
            else:
                y_uo = y_uo.at[dofs.reshape(-1)].add(
                    (x["uo"][dofs] @ Eg.T).reshape(-1)
                )

        # one-sided interface flux: u[a] rows <- y[3a+k] columns
        for cd8, Eb, k, ufield in self.flux:
            for a in range(3):
                add = (
                    (x["yi" if ufield == "ui" else "yo"][(3 * a + k) * N + cd8])
                    @ Eb.T
                ).reshape(-1)
                rows = (a * N + cd8).reshape(-1)
                if ufield == "ui":
                    y_ui = y_ui.at[rows].add(add)
                else:
                    y_uo = y_uo.at[rows].add(add)
        return {"ui": y_ui, "uo": y_uo, "yi": y_yi, "yo": y_yo, "p": y_p}

    # ------------------------------------------------------------ helpers
    def rigid_modes(self) -> tuple:
        """Collective rigid-body motions of (ui, uo): 3 translations + 3
        rotations — near-null directions of the penalized system (the 2D
        scheme's `rigid_modes`; the reference hands the singularity to
        MUMPS icntl 24/25)."""
        g = self.grid
        dt = float_dtype()
        N = self._N
        x, y, z = g.vertex_coords_lattice(dt)
        D, R, C = g.lattice_shape
        xs = jnp.broadcast_to(x, (D, R, C)).reshape(-1)
        ys = jnp.broadcast_to(y, (D, R, C)).reshape(-1)
        zs = jnp.broadcast_to(z, (D, R, C)).reshape(-1)
        one = jnp.ones(N, dt)
        zero = jnp.zeros(N, dt)
        fields = [
            (one, zero, zero),
            (zero, one, zero),
            (zero, zero, one),
            (-ys, xs, zero),
            (-zs, zero, xs),
            (zero, -zs, ys),
        ]
        modes = []
        for fx, fy, fz in fields:
            w = jnp.concatenate([fx, fy, fz])
            modes.append(
                {
                    "ui": w,
                    "uo": w,
                    "yi": jnp.zeros(9 * N, dt),
                    "yo": jnp.zeros(9 * N, dt),
                    "p": jnp.zeros(3 * N, dt),
                }
            )
        return tuple(modes)

    # ------------------------------------------------------ preconditioner
    def lattice_preconditioner(
        self,
        min_n: int = 4,
        dtype=jnp.float32,
        dense_max: int = 4000,
        sweeps: Optional[int] = None,
        use_mg: bool = True,
        use_iface: bool = True,
        use_coarse: bool = True,
        coarse_poly_degree: int = 0,
        coarse_harmonic_degree: Optional[int] = None,
        inner: str = "krylov",
        inner_omega: float = 1.0,
    ):
        """Per-side masked block V-cycles on the non-cut elasticity bulks
        (ui: Dirichlet box shell; uo: floating sphere interior) + damped
        Jacobi on the remaining active DoFs + a multiplicative exact-
        submatrix correction on the cut/ghost/flux DoF block (dense
        inverse when small, else inner RAS-band Krylov) — the S5-3D
        analogue of ``NeumannPoisson3.lattice_preconditioner``.

        Collective rigid modes stay near-null under any bulk cycle; pass
        ``deflate=self.rigid_modes()`` to ``solve`` alongside this.
        ``use_mg``/``use_iface`` switch off the bulk cycles / the cut-block
        correction (Jacobi fallback) for experiments and cheap setups."""
        from ..ops.lattice3 import build_lattice3_block_mg

        g = self.grid
        D, R, C = self._DRC
        N = self._N
        ct = self.tags.cell_tags
        nz, ny, nx = ct.shape
        touch = {}
        for t in (1, 2, 3):
            m = np.zeros((D, R, C), bool)
            sel = ct == t
            for (dx, dy, dz) in HEX_OFFS:
                m[dz : dz + nz, dy : dy + ny, dx : dx + nx] |= sel
            touch[t] = m
        bulk_in = touch[1] & ~touch[2]
        bulk_out = touch[3] & ~touch[2]
        li, mi = self.lmbda_in, self.mu_in
        lo, mo = self.lmbda_out, self.mu_out
        mg_in = build_lattice3_block_mg(
            g.nx, g.ny, g.nz, g.spacing,
            lambda hx, hy, hz: _elastic_element_matrix(hx, hy, hz, li, mi),
            vsz=3, min_n=min_n, dtype=dtype, mask=bulk_in,
        )
        mg_out = build_lattice3_block_mg(
            g.nx, g.ny, g.nz, g.spacing,
            lambda hx, hy, hz: _elastic_element_matrix(hx, hy, hz, lo, mo),
            vsz=3, min_n=min_n, dtype=dtype, mask=bulk_out,
        )
        bulk_in_j = jnp.asarray(bulk_in.reshape(-1))
        bulk_out_j = jnp.asarray(bulk_out.reshape(-1))
        inv_diag = jax.tree.map(lambda d: 1.0 / d, self.diag)
        active = self.active
        omega = 0.67

        # global flat layout: ui [0,3N) uo [3N,6N) yi [6N,15N) yo [15N,24N)
        # p [24N,27N)
        from .lattice_core import build_interface_block, make_interface_apply

        idxU = np.asarray(self.idxU)
        idxY = np.asarray(self.idxY)
        pen_dofs = np.concatenate(
            [idxU, 3 * N + idxU, 6 * N + idxY, 15 * N + idxY, 24 * N + idxU],
            axis=1,
        )  # (ne, 216)
        pen_mats = np.asarray(self.E_stat, np.float64)[None] + np.asarray(
            self.E_phi, np.float64
        )
        # the EXACT sparse interface submatrix (penalty + ghost + flux +
        # both sides' bulk stencils on touched cells) solved by an inner
        # RAS-preconditioned band Krylov — the S3-3D recipe.  A single
        # one-cell-block RAS application (the first attempt here) is NOT a
        # usable approximate solve of this block: outer BiCGStab diverges
        # (measured n=8/16), matching the 2D finding that one-level RAS
        # alone stalls (CLAUDE.md round-2 notes).
        blocks = [(pen_dofs, pen_dofs, pen_mats)]
        for dofs, Eg, field in self.ghost:
            d = np.asarray(dofs) + (0 if field == "ui" else 3 * N)
            blocks.append((d, d, np.asarray(Eg)))
        for cd8, Eb, k, ufield in self.flux:
            d8 = np.asarray(cd8)
            urow = 0 if ufield == "ui" else 3 * N
            ycol = 6 * N if ufield == "ui" else 15 * N
            for a in range(3):
                blocks.append(
                    (
                        urow + a * N + d8,
                        ycol + (3 * a + k) * N + d8,
                        np.asarray(Eb),
                    )
                )
        # bulk elasticity rows among selected u DoFs (S3's A8 analogue)
        sel_u = np.zeros(3 * N, bool)
        sel_u[pen_dofs[:, _OFF_UI : _OFF_UI + 24].reshape(-1)] = True
        sel_uo = np.zeros(3 * N, bool)
        sel_uo[(pen_dofs[:, _OFF_UO : _OFF_UO + 24] - 3 * N).reshape(-1)] = True
        for dofs, _, field in self.ghost:
            (sel_u if field == "ui" else sel_uo)[
                np.asarray(dofs).reshape(-1)
            ] = True
        for side, sel_s, K, off in (
            ((1, 2), sel_u, self.K_in, 0),
            ((2, 3), sel_uo, self.K_out, 3 * N),
        ):
            cells_s = np.argwhere(self.tags.region_mask(side)).astype(np.int32)
            cd = cell_dofs_of((D, R, C), cells_s)
            cd24 = np.concatenate([c * N + cd for c in range(3)], axis=1)
            touch_c = sel_s[cd24].any(axis=1)
            if touch_c.any():
                blocks.append(
                    (off + cd24[touch_c], off + cd24[touch_c], np.asarray(K))
                )
        selectable = np.concatenate(
            [np.asarray(active[k]) for k in ("ui", "uo", "yi", "yo", "p")]
        )
        ids, A_csr, ras = build_interface_block(blocks, 27 * N, selectable)
        # regroup the RAS blocks per lattice VERTEX (the 27 dofs of all 5
        # fields at one vertex): same-vertex cross-field couplings are the
        # penalty's strong ones, and 27^2 block applies are ~30x cheaper
        # than the 216^2 per-cell ones (inner cost is RAS-dominated)
        by_vertex = {}
        for compact, gid in enumerate(ids):
            by_vertex.setdefault(int(gid) % N, []).append(compact)
        ras = [np.asarray(v, np.int64) for v in by_vertex.values()]
        if sweeps is None:
            # the S5 cut block (contrast-weighted 5-field penalty) needs
            # more inner sweeps than S1's scalar one, like 2D S5's 0.6
            # coefficient (CLAUDE.md)
            sweeps = max(40, int(0.8 * len(ids) ** 0.5))
        iface_apply = make_interface_apply(
            ids, A_csr, ras, dense_max=dense_max, sweeps=sweeps,
            inner=inner, inner_omega=inner_omega,
        )

        def iface(rf):
            ids_j, corr = iface_apply(rf)
            return jnp.zeros_like(rf).at[ids_j].add(corr)

        def split(xf):
            return {
                "ui": xf[: 3 * N],
                "uo": xf[3 * N : 6 * N],
                "yi": xf[6 * N : 15 * N],
                "yo": xf[15 * N : 24 * N],
                "p": xf[24 * N :],
            }

        def flat(x):
            return jnp.concatenate(
                [x["ui"], x["uo"], x["yi"], x["yo"], x["p"]]
            )

        # rank-6 Galerkin coarse correction over the FLOATING side's rigid
        # modes (uo has no Dirichlet row; a relative rigid motion's energy
        # sits entirely in the O(h)-thin penalty band, so bulk MG + band
        # solve reduce it at 1 - O(h) and outer iterations grow like 1/h —
        # measured here: contraction 0.6/iter at n=8 but 0.91/iter at
        # n=16 without this; the 2D S5 measured 15/39/108 -> grid-
        # independent with it, mg.attach_coarse_correction's rationale).
        # Collective motions are the EXACT null space, handled by
        # deflation.
        base_modes = []
        for m in self.rigid_modes():
            mm = dict(m)
            mm["ui"] = jnp.zeros_like(m["ui"])
            base_modes.append(mm)
        # per-side SOLID-HARMONIC enrichment — the exact 3D analogue of
        # the 2D interface-harmonic Fourier coarse space
        # (s5_fourier_modes, docs/s5_preconditioner.md).  For a spherical
        # interface of mean radius a about the cut-band centroid, the
        # harmonic field matching Y_lm on the interface is (r/a)^l Y_lm on
        # the INTERIOR side and (a/r)^(l+1) Y_lm on the EXTERIOR side —
        # closed forms, so no eigen-solves.  Both radial families are
        # needed: an error mode varying like Y_lm along the interface
        # couples the sides only through the O(h)-thin penalty band, is
        # contracted at 1 - O(l h) per application, and DECAYS away from
        # the interface on the outer side — growing Cartesian monomials
        # (the round-4 enrichment, kept under ``coarse_poly_degree``)
        # cannot represent that decay, which is why they did not tame the
        # contrast-1000 growth (20 -> 100 outer iterations at n=8 -> 16
        # with the rigid space; docs/s53d_convergence.md).  Sides are
        # auto-detected from mean radii (the 2D lesson: the param1-style
        # levelset 1 - r^2 puts the "in" material OUTSIDE).  L auto-scales
        # like the 2D K = n/4 (poorly-contracted frequencies reach
        # l h = O(1)).
        if coarse_harmonic_degree is None:
            coarse_harmonic_degree = int(np.clip(g.nx // 4, 2, 10))
        if coarse_harmonic_degree > 0:
            from scipy.special import lpmv

            x3, y3, z3 = g.vertex_coords_lattice(float_dtype())
            pos = np.stack(
                [
                    np.asarray(jnp.broadcast_to(v, (D, R, C))).reshape(-1)
                    for v in (x3, y3, z3)
                ],
                axis=1,
            )  # (N, 3) host vertex coordinates
            cut_v = touch[2].reshape(-1)
            c3 = pos[cut_v].mean(axis=0)
            dp = pos - c3
            r3n = np.sqrt((dp * dp).sum(axis=1))
            a3 = max(float(r3n[cut_v].mean()), 1e-12)
            # which displacement field is the interface's interior?
            rin_mean = (
                float(r3n[bulk_in.reshape(-1)].mean())
                if bulk_in.any()
                else np.inf
            )
            f_int, f_ext = ("ui", "uo") if rin_mean < a3 else ("uo", "ui")
            rho3 = r3n / a3
            ct3 = dp[:, 2] / np.maximum(r3n, 1e-30)  # cos(theta)
            ph3 = np.arctan2(dp[:, 1], dp[:, 0])
            w_int_l = lambda l: np.minimum(rho3, 1.5) ** l
            w_ext_l = lambda l: np.clip(rho3, 0.2, None) ** (-(l + 1))
            zero27 = {
                "ui": jnp.zeros(3 * N, float_dtype()),
                "uo": jnp.zeros(3 * N, float_dtype()),
                "yi": jnp.zeros(9 * N, float_dtype()),
                "yo": jnp.zeros(9 * N, float_dtype()),
                "p": jnp.zeros(3 * N, float_dtype()),
            }
            for l in range(coarse_harmonic_degree + 1):
                wi, we = w_int_l(l), w_ext_l(l)
                for m in range(l + 1):
                    P = lpmv(m, l, ct3)
                    angs = [P * np.cos(m * ph3)]
                    if m > 0:
                        angs.append(P * np.sin(m * ph3))
                    for ang in angs:
                        for comp in range(3):
                            for fname, w in ((f_int, wi), (f_ext, we)):
                                vals = np.zeros(3 * N)
                                vals[comp * N : (comp + 1) * N] = w * ang
                                mm = dict(zero27)
                                mm[fname] = jnp.asarray(vals, float_dtype())
                                base_modes.append(mm)
        if coarse_poly_degree > 0:
            x3, y3, z3 = g.vertex_coords_lattice(float_dtype())
            xs3 = jnp.broadcast_to(x3, (D, R, C)).reshape(-1)
            ys3 = jnp.broadcast_to(y3, (D, R, C)).reshape(-1)
            zs3 = jnp.broadcast_to(z3, (D, R, C)).reshape(-1)
            zero27 = {
                "ui": jnp.zeros(3 * N, float_dtype()),
                "uo": jnp.zeros(3 * N, float_dtype()),
                "yi": jnp.zeros(9 * N, float_dtype()),
                "yo": jnp.zeros(9 * N, float_dtype()),
                "p": jnp.zeros(3 * N, float_dtype()),
            }
            polys = []
            Ldeg = coarse_poly_degree
            for a in range(Ldeg + 1):
                for b in range(Ldeg + 1 - a):
                    for c in range(Ldeg + 1 - a - b):
                        polys.append(xs3**a * ys3**b * zs3**c)
            for side in ("ui", "uo"):
                for comp in range(3):
                    for p3 in polys:
                        mm = dict(zero27)
                        mm[side] = (
                            jnp.zeros(3 * N, float_dtype())
                            .at[comp * N : (comp + 1) * N]
                            .set(p3)
                        )
                        base_modes.append(mm)
        Zs, AZs = [], []
        for mm in base_modes:
            mm = {
                k: jnp.where(active[k], mm[k], 0.0) for k in mm
            }
            zf = np.asarray(flat(mm), np.float64)
            nrm = max(np.linalg.norm(zf), 1e-300)
            Zs.append(zf / nrm)
            AZs.append(np.asarray(flat(self.matvec(mm)), np.float64) / nrm)
        Z_np = np.stack(Zs)
        G = Z_np @ np.stack(AZs).T
        Z = jnp.asarray(Z_np)
        Ginv = jnp.asarray(np.linalg.pinv(G, rcond=1e-10))

        def bulk_cycle(r_u, mg, bulk_flat):
            r3 = jnp.where(bulk_flat, r_u, 0.0).reshape(3, D, R, C)
            rp = jnp.zeros((3, D + 2, R + 2, C + 2), r3.dtype).at[
                :, 1 : 1 + D, 1 : 1 + R, 1 : 1 + C
            ].set(r3)
            z3 = mg(rp)[:, 1 : 1 + D, 1 : 1 + R, 1 : 1 + C]
            return z3.reshape(3, -1)

        def precond(r):
            jac = {
                k: jnp.where(active[k], omega * r[k] * inv_diag[k], 0.0)
                for k in r
            }
            if use_mg:
                z_in = bulk_cycle(
                    r["ui"].reshape(3, -1), mg_in, bulk_in_j[None]
                )
                z_out = bulk_cycle(
                    r["uo"].reshape(3, -1), mg_out, bulk_out_j[None]
                )
                z_ui = jnp.where(
                    bulk_in_j[None], z_in, jac["ui"].reshape(3, -1)
                ).reshape(-1)
                z_uo = jnp.where(
                    bulk_out_j[None], z_out, jac["uo"].reshape(3, -1)
                ).reshape(-1)
            else:
                z_ui = jac["ui"]
                z_uo = jac["uo"]
            x = {
                "ui": jnp.where(active["ui"], z_ui, 0.0),
                "uo": jnp.where(active["uo"], z_uo, 0.0),
                "yi": jac["yi"],
                "yo": jac["yo"],
                "p": jac["p"],
            }
            if use_iface:
                Ax = self.matvec(
                    jax.tree.map(
                        lambda xi, mm: jnp.where(mm, xi, 0.0), x, active
                    )
                )
                res = jax.tree.map(
                    lambda ri, ai, mm: jnp.where(mm, ri - ai, 0.0),
                    r, Ax, active,
                )
                corr = iface(flat(res))
                x = split(flat(x) + corr)
            if not use_coarse:
                return x
            # multiplicative rank-6 rigid coarse step (one extra matvec)
            Ax2 = self.matvec(
                jax.tree.map(lambda xi, mm: jnp.where(mm, xi, 0.0), x, active)
            )
            rf2 = flat(
                jax.tree.map(
                    lambda ri, ai, mm: jnp.where(mm, ri - ai, 0.0),
                    r, Ax2, active,
                )
            )
            alpha = Ginv.astype(rf2.dtype) @ (Z.astype(rf2.dtype) @ rf2)
            return split(flat(x) + Z.astype(rf2.dtype).T @ alpha)

        return precond

    # -------------------------------------------------------------- solve
    def solve(
        self,
        method: str = "bicgstab",
        tol: float = 1e-10,
        maxiter: int = 20000,
        precond=None,
        deflate=None,
    ) -> SolveResult:
        x, rel, it = cached_equilibrated_solve(
            self, method, tol, maxiter, precond, deflate=deflate
        )
        x = dict(x)
        x["ui"] = x["ui"] + self.x_bc["ui"]  # undo the Dirichlet lifting
        D, R, C = self._DRC
        self.result = SolveResult(
            x=x, residual=rel, iterations=it, converged=rel <= 10 * tol
        )
        # recombination (reference main.py:296-323): halve on cut-touched
        # vertices, zero strictly-opposite-side vertices, add
        ct = self.tags.cell_tags
        nz, ny, nx = ct.shape
        touch = {}
        for t in (1, 2, 3):
            m = np.zeros((D, R, C), bool)
            sel = ct == t
            for (dx, dy, dz) in HEX_OFFS:
                m[dz : dz + nz, dy : dy + ny, dx : dx + nx] |= sel
            touch[t] = m.reshape(-1)
        m_cut = jnp.asarray(touch[2])
        rm_in = jnp.asarray(touch[3] & ~touch[2])
        rm_out = jnp.asarray(touch[1] & ~touch[2])
        u_in = x["ui"].reshape(3, -1)
        u_out = x["uo"].reshape(3, -1)
        u_in = jnp.where(m_cut[None], u_in / 2.0, u_in)
        u_out = jnp.where(m_cut[None], u_out / 2.0, u_out)
        u_in = jnp.where(rm_in[None], 0.0, u_in)
        u_out = jnp.where(rm_out[None], 0.0, u_out)
        self.u_lat = (u_in + u_out).reshape(3, D, R, C)
        return self.result

    # ------------------------------------------------------------- errors
    def l2_h1_errors(self, exact: Callable, region=(1, 2, 3)) -> Dict[str, float]:
        return lattice_l2_h1_errors_vec(
            self.grid, self.tags.region_mask(region), self.u_lat, exact
        )
