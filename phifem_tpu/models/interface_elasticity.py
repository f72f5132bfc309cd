"""S5 — two-material linear elasticity with an immersed interface.

Scheme of reference ``demo/interface-elasticity/main.py:145-277``:
  div sigma_i(u_i) = f on each side of the interface {phi = 0}, with
  E_in/E_out contrast, continuity of displacement and traction imposed by
  phi-weighted penalties on cut cells; exact Dirichlet BC on the outer box
  edges.  5-field mixed space: u_in, u_out (vector P1), y_in, y_out
  (tensor P1 fluxes), p (vector P1 auxiliary).

Distinctive pieces (reference line refs in methods below):
  * contrast-weighted flux penalties with coef_in/out = (E_i/(E_in+E_out))^2
  * two one-sided boundary terms d_bdry(100) + d_bdry(101)
  * real Dirichlet BC on the mixed u_in block with lifting
  * solution recombination on cut cells (average of in/out halves)
  * convergence loop with uniform refinement + slope fit
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..assembly import (
    BoundaryTerm,
    CellTerm,
    FacetTerm,
    System,
    assemble_operator,
    assemble_vector,
)
from ..solvers import DirichletBC, SolveResult, solve
from ..spaces import Function, Space, boundary_dof_mask, interpolate
from .base import LevelSetLike, SchemeBase


def lame(E: float, nu: float):
    """(lambda, mu) from Young modulus / Poisson ratio (reference
    ``demo/interface-elasticity/data.py:4-10``)."""
    lmbda = E * nu / (1.0 + nu) / (1.0 - 2.0 * nu)
    mu = E / 2.0 / (1.0 + nu)
    return lmbda, mu


def _eps(G):
    return 0.5 * (G + G.T)


def _sigma(G, lmbda, mu):
    """Stress from a displacement gradient G (2,2)."""
    return lmbda * jnp.trace(G) * jnp.eye(2) + 2.0 * mu * _eps(G)


def _div_tensor(t):
    """div of a tensor FieldEval: (div y)_i = d_j y_ij."""
    return jnp.einsum("ijj->i", t.grad)


def dof_mask_from_cells(space: Space, cells: np.ndarray) -> jnp.ndarray:
    """Boolean mask of scalar DoFs touched by ``cells`` (replaces
    ``locate_dofs_topological`` over tagged cells, reference
    ``demo/interface-elasticity/main.py:300-315``).  Generic over the
    structured :class:`~phifem_tpu.spaces.Space` and the unstructured
    :class:`~phifem_tpu.uassembly.USpace` (both expose ``cell_dofs`` /
    ``num_scalar_dofs``)."""
    mask = jnp.zeros(space.num_scalar_dofs, bool)
    dofs = space.cell_dofs[jnp.asarray(cells, jnp.int32)]
    return mask.at[dofs.reshape(-1)].set(True)


def s5_forms(
    pen,
    stab,
    E_in,
    nu_in,
    E_out,
    nu_out,
    primal_degree,
    flux_degree,
    levelset_degree,
    phi_h,
    f,
    ds_in,
    ds_out,
):
    """The S5 interface-elasticity term lists (operator + RHS, reference
    ``demo/interface-elasticity/main.py:145-277``), shared verbatim by the
    structured scheme below and the unstructured one
    (:class:`phifem_tpu.models.unstructured.InterfaceElasticityU`) — one
    definition of the discrete form, two mesh backends.

    ``ds_in`` / ``ds_out`` are the two one-sided boundary measures (ids
    100 / 101 of the tagging contract).  Returns ``(cell_terms,
    facet_terms, boundary_terms, rhs_cell_terms)`` ready for either
    ``assembly.assemble_operator`` or ``uassembly.assemble_operator``."""
    li, mi = lame(E_in, nu_in)
    lo, mo = lame(E_out, nu_out)
    coef_in = (E_in / (E_in + E_out)) ** 2
    coef_out = (E_out / (E_in + E_out)) ** 2
    qdeg = 2 * (flux_degree + levelset_degree) + 2

    def stiff_in(u, v, d, x, ctx):
        return jnp.sum(_sigma(u["u_in"].grad, li, mi) * _eps(v["u_in"].grad))

    def stiff_out(u, v, d, x, ctx):
        return jnp.sum(_sigma(u["u_out"].grad, lo, mo) * _eps(v["u_out"].grad))

    def penalty(u, v, d, x, ctx):
        h = ctx.h
        gphi = d["phi"].grad
        t1 = coef_out * jnp.sum(
            (u["y_in"].val + _sigma(u["u_in"].grad, li, mi))
            * (v["y_in"].val + _sigma(v["u_in"].grad, li, mi))
        )
        t2 = coef_in * jnp.sum(
            (u["y_out"].val + _sigma(u["u_out"].grad, lo, mo))
            * (v["y_out"].val + _sigma(v["u_out"].grad, lo, mo))
        )
        ju = (u["y_in"].val - u["y_out"].val) @ gphi
        jv = (v["y_in"].val - v["y_out"].val) @ gphi
        t3 = jnp.dot(ju, jv) / h**2
        su = u["u_in"].val - u["u_out"].val + u["p"].val * d["phi"].val / h
        sv = v["u_in"].val - v["u_out"].val + v["p"].val * d["phi"].val / h
        t4 = jnp.dot(su, sv) / h**2
        return pen * (t1 + t2 + t3 + t4)

    def cell_stab(u, v, d, x, ctx):
        return (
            stab
            * ctx.h**2
            * (
                jnp.dot(_div_tensor(u["y_in"]), _div_tensor(v["y_in"]))
                + jnp.dot(_div_tensor(u["y_out"]), _div_tensor(v["y_out"]))
            )
        )

    def ghost_in(u0, u1, v0, v1, d0, d1, x, n, ctx):
        ju = (_sigma(u0["u_in"].grad, li, mi) - _sigma(u1["u_in"].grad, li, mi)) @ n
        jv = (_sigma(v0["u_in"].grad, li, mi) - _sigma(v1["u_in"].grad, li, mi)) @ n
        return stab * ctx.h * jnp.dot(ju, jv)

    def ghost_out(u0, u1, v0, v1, d0, d1, x, n, ctx):
        ju = (_sigma(u0["u_out"].grad, lo, mo) - _sigma(u1["u_out"].grad, lo, mo)) @ n
        jv = (_sigma(v0["u_out"].grad, lo, mo) - _sigma(v1["u_out"].grad, lo, mo)) @ n
        return stab * ctx.h * jnp.dot(ju, jv)

    def bdry_in(u, v, d, x, n, ctx):
        return jnp.dot(u["y_in"].val @ n, v["u_in"].val)

    def bdry_out(u, v, d, x, n, ctx):
        return jnp.dot(u["y_out"].val @ n, v["u_out"].val)

    def rhs_in(v, d, x, ctx):
        return jnp.dot(d["f"].val, v["u_in"].val)

    def rhs_out(v, d, x, ctx):
        return jnp.dot(d["f"].val, v["u_out"].val)

    def rhs_stab(v, d, x, ctx):
        return (
            stab
            * ctx.h**2
            * (
                jnp.dot(d["f"].val, _div_tensor(v["y_in"]))
                + jnp.dot(d["f"].val, _div_tensor(v["y_out"]))
            )
        )

    data = {"phi": phi_h}
    fdata = {"f": f}
    cell_terms = [
        (CellTerm(stiff_in, (1, 2), degree=2 * primal_degree, uniform=True), {}),
        (CellTerm(stiff_out, (2, 3), degree=2 * primal_degree, uniform=True), {}),
        (CellTerm(penalty, (2,), degree=qdeg), data),
        (CellTerm(cell_stab, (2,), degree=2 * flux_degree, uniform=True), {}),
    ]
    facet_terms = [
        (FacetTerm(ghost_in, region=(3,), npts=2), {}),
        (FacetTerm(ghost_out, region=(4,), npts=2), {}),
    ]
    boundary_terms = [
        (BoundaryTerm(bdry_in, ds_in, npts=2), {}),
        (BoundaryTerm(bdry_out, ds_out, npts=2), {}),
    ]
    rhs_cell_terms = [
        (CellTerm(rhs_in, (1, 2), degree=qdeg), fdata),
        (CellTerm(rhs_out, (2, 3), degree=qdeg), fdata),
        (CellTerm(rhs_stab, (2,), degree=qdeg), fdata),
    ]
    return cell_terms, facet_terms, boundary_terms, rhs_cell_terms


def s5_rigid_modes(system: System, U, interp) -> tuple:
    """COLLECTIVE rigid-body motions of (u_in, u_out) — the S5 system's
    exact null space (see :meth:`InterfaceElasticity.rigid_modes`).
    ``interp`` is the backend's interpolate (structured or unstructured)."""
    modes = []
    for fn in (
        lambda x: jnp.stack(
            [jnp.ones(x.shape[:-1]), jnp.zeros(x.shape[:-1])], axis=-1
        ),
        lambda x: jnp.stack(
            [jnp.zeros(x.shape[:-1]), jnp.ones(x.shape[:-1])], axis=-1
        ),
        lambda x: jnp.stack([-x[..., 1], x[..., 0]], axis=-1),
    ):
        w = interp(fn, U).data
        m = {
            n: jnp.zeros(sp.dof_shape, w.dtype)
            for n, sp in system.fields.items()
        }
        m["u_in"] = w
        m["u_out"] = w
        modes.append(m)
    return tuple(modes)


def s5_fourier_modes(
    system: System,
    coords: np.ndarray,
    cut_mask: np.ndarray,
    in_mask: np.ndarray,
    K: int,
    fields=("u_in", "u_out"),
) -> tuple:
    """Interface-harmonic Fourier coarse modes for the S5 transmission
    system (used by :meth:`InterfaceElasticity._coarse_modes`).

    The flat bulk/band preconditioner contracts SMOOTH transmission modes
    at only 1 - O(k h): an error field varying like ``e^{i k theta}``
    along the interface couples the two bulks solely through the O(h)-thin
    penalty band, so each application transfers an O(k h) fraction of it
    (this is why outer iterations grew 15/34/80 at n=32/64/128 with the
    rank-3 rigid coarse space).  The fix is the classical substructuring
    one: put the low interface-frequency modes in the coarse space.  Here
    they have CLOSED FORMS — for a star-shaped interface of mean radius R
    about the cut-band centroid, the harmonic field matching ``cos(k
    theta)`` on the interface is ``(r/R)^k cos(k theta)`` inside and
    ``(R/r)^k cos(k theta)`` outside (exact for Laplace on a circle, a
    uniformly good approximation for smooth star-shaped interfaces and for
    the elasticity operator's angular modes) — so no eigen-solves or
    harmonic extensions are needed, and the correction stays a rank-k
    dense Galerkin solve (compile-bounded, unlike the coupled
    re-discretized hierarchy, CLAUDE.md round 3).

    ``coords``: (num_scalar_dofs, 2) host DoF coordinates of the vector
    space; ``cut_mask``: host bool mask of scalar DoFs touched by cut
    cells (locates the interface: centroid = mean cut point, R = mean cut
    radius); ``in_mask``: DoFs of u_in's region, used only to decide
    which side is the interior of the interface (the reference's param1
    levelset ``1 - r^2`` puts the "in" material OUTSIDE the circle —
    sides cannot be assumed).  Returns ``4*(2K+1)`` mode pytrees:
    {1, cos k.theta, sin k.theta} x {x,y component} x {interior-harmonic
    ``(r/R)^k`` on the interior-side field, exterior-harmonic ``(R/r)^k``
    on the other}.  The span contains each side's rigid translations and
    (approximately) the rotation, and pairs of in/out modes sum to
    collective motions the outer solve deflates — the Galerkin matrix is
    therefore solved with a pseudo-inverse
    (see :func:`phifem_tpu.mg.attach_coarse_correction`)."""
    pts = coords[np.asarray(cut_mask)]
    c = pts.mean(axis=0)
    R = float(np.hypot(pts[:, 0] - c[0], pts[:, 1] - c[1]).mean())
    R = max(R, 1e-12)
    d = coords - c
    r = np.hypot(d[:, 0], d[:, 1])
    theta = np.arctan2(d[:, 1], d[:, 0])
    # clip the radial profiles: rho**-k is singular at the centroid (an
    # inactive exterior-side DoF anyway — attach_coarse_correction masks
    # it — but keep the raw columns bounded for Galerkin conditioning)
    rho = np.clip(r / R, 0.2, None)

    f_in, f_out = fields
    rin = float(r[np.asarray(in_mask)].mean()) if in_mask.any() else 0.0
    f_int, f_ext = (f_in, f_out) if rin < R else (f_out, f_in)
    w_int_of = lambda k: np.minimum(rho, 1.5) ** k
    w_ext_of = lambda k: rho ** (-k)
    modes = []
    n = coords.shape[0]
    for k in range(K + 1):
        angs = [np.cos(k * theta)] if k == 0 else [
            np.cos(k * theta), np.sin(k * theta)
        ]
        for a in angs:
            for comp in (0, 1):
                for fname, w in (
                    (f_int, w_int_of(k)), (f_ext, w_ext_of(k))
                ):
                    vals = np.zeros((n, 2))
                    vals[:, comp] = w * a
                    m = {
                        name: jnp.zeros(sp.dof_shape)
                        for name, sp in system.fields.items()
                    }
                    m[fname] = jnp.asarray(vals)
                    modes.append(m)
    return tuple(modes)


def s5_fourier_builder(system, grid, cut_pts: np.ndarray, rin: float, K: int):
    """DEVICE-side construction of the S5 Fourier coarse basis.

    Returns ``(z_builder, nmodes)`` for
    :func:`phifem_tpu.mg.attach_coarse_correction_device`: the same
    closed-form interface-harmonic modes as :func:`s5_fourier_modes`, but
    built inside jit from the grid's device coordinate lattice — only
    three SCALARS (centroid, radius, side flag) come from the host.  The
    host-built pytree path uploads O(k * ndofs) mode data (~600 MB at
    bench sizes); this builds the identical span on the device.

    Only P1 vector displacement fields are populated (the flux/auxiliary
    fields live on the cut band, which the band solve owns)."""
    c = cut_pts.mean(axis=0)
    R = max(float(np.hypot(cut_pts[:, 0] - c[0], cut_pts[:, 1] - c[1]).mean()), 1e-12)
    in_is_interior = rin < R
    names = list(system.fields)
    sizes = [int(np.prod(system.fields[n].dof_shape)) for n in names]
    N = system.fields["u_in"].dof_shape[0]
    nmodes = 4 * (2 * K + 1)

    def z_builder():
        xy = grid.vertex_coords.astype(jnp.float64)  # (N, 2) device
        d = xy - jnp.asarray(c)
        r = jnp.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2)
        theta = jnp.arctan2(d[:, 1], d[:, 0])
        rho = jnp.clip(r / R, 0.2, None)
        ks = jnp.arange(K + 1, dtype=xy.dtype)
        ang = jnp.concatenate(
            [
                jnp.cos(ks[:, None] * theta[None, :]),
                jnp.sin(ks[1:, None] * theta[None, :]),
            ]
        )  # (A, N), A = 2K+1
        k_of = jnp.concatenate([ks, ks[1:]])  # (A,)
        w_int = jnp.minimum(rho, 1.5)[None, :] ** k_of[:, None]
        w_ext = rho[None, :] ** (-k_of[:, None])
        base_int = ang * w_int  # (A, N)
        base_ext = ang * w_ext
        A = base_int.shape[0]
        # mode axis order: (angular a, side in {int, ext}, component)
        eye = jnp.eye(2, dtype=xy.dtype)
        blk = jnp.stack([base_int, base_ext], axis=1)  # (A, side, N)
        vec5 = (
            blk[:, :, None, :, None] * eye[None, None, :, None, :]
        )  # (A, side, comp, N, 2)
        int_field = "u_in" if in_is_interior else "u_out"
        rows = []
        for n, sz in zip(names, sizes):
            if n in ("u_in", "u_out"):
                side = 0 if n == int_field else 1
                full = jnp.zeros((A, 2, 2, N * 2), xy.dtype)
                full = full.at[:, side].set(
                    vec5[:, side].reshape(A, 2, N * 2)
                )
                rows.append(full.reshape(nmodes, N * 2))
            else:
                rows.append(jnp.zeros((nmodes, sz), xy.dtype))
        return jnp.concatenate(rows, axis=1)

    return z_builder, nmodes


def s5_recombine(U, cell_tags: np.ndarray, u_in, u_out):
    """Reference recombination (``demo/interface-elasticity/main.py:296-323``):
    halve both halves on cut cells, zero each half's strictly-opposite-side
    DoFs, and add — one displacement field over the whole box."""
    ct = np.asarray(cell_tags)
    m_cut = dof_mask_from_cells(U, np.where(ct == 2)[0])
    m_int = dof_mask_from_cells(U, np.where(ct == 1)[0])
    m_ext = dof_mask_from_cells(U, np.where(ct == 3)[0])
    rm_in = jnp.logical_and(m_ext, jnp.logical_not(m_cut))
    rm_out = jnp.logical_and(m_int, jnp.logical_not(m_cut))
    u_in = jnp.where(m_cut[:, None], u_in / 2.0, u_in)
    u_out = jnp.where(m_cut[:, None], u_out / 2.0, u_out)
    u_in = jnp.where(rm_in[:, None], 0.0, u_in)
    u_out = jnp.where(rm_out[:, None], 0.0, u_out)
    return u_in + u_out


@dataclasses.dataclass
class InterfaceElasticity(SchemeBase):
    # the 5-field contrast-weighted cut block needs more inner band-solve
    # iterations than S1's scalar one (see mg.attach_interface_solve)
    _iface_sweeps_coef = 0.6

    primal_degree: int = 1
    flux_degree: int = 1
    auxiliary_degree: int = 1
    levelset_degree: int = 1
    E_in: float = 1.0
    nu_in: float = 0.3
    E_out: float = 0.001
    nu_out: float = 0.3
    # interface Fourier frequencies in the preconditioner's coarse space
    # (see s5_fourier_modes); None = auto-scale clip(n/4, 8, 64) — the
    # poorly-contracted transmission frequencies reach ~kh = O(1), so K
    # must grow with n (measured outer iters 13/16/25/45 at n=32..256
    # with K=n/4, vs 15/34/80/~190 with the rank-3 rigid space);
    # 0 falls back to the rank-3 rigid space
    coarse_fourier_k: Optional[int] = None

    def setup(
        self,
        levelset: LevelSetLike,
        f: Union[Callable, Function],
        u_dbc: Union[Callable, Function],
    ):
        g = self.grid
        self.tag(levelset)
        U = Space.lagrange(g, self.primal_degree, (2,))
        T = Space.lagrange(g, self.flux_degree, (2, 2))
        P = Space.lagrange(g, self.auxiliary_degree, (2,))
        Vphi = Space.lagrange(g, self.levelset_degree)
        self.U, self.T, self.P = U, T, P
        self.system = System(
            {"u_in": U, "u_out": U, "y_in": T, "y_out": T, "p": P}
        )
        self.phi_h = levelset if isinstance(levelset, Function) else interpolate(levelset, Vphi)
        self.f = f
        self.lmbda_in, self.mu_in = lame(self.E_in, self.nu_in)
        self.lmbda_out, self.mu_out = lame(self.E_out, self.nu_out)
        # Dirichlet BC on the u_in block over the outer box edges
        # (reference main.py:158-177)
        self.u_dbc = u_dbc if isinstance(u_dbc, Function) else interpolate(u_dbc, U)
        bmask = boundary_dof_mask(U)
        self.bcs = (
            DirichletBC("u_in", bmask[:, None], self.u_dbc.data),
        )
        self._setup_args = (levelset, f, u_dbc)
        return self

    def assemble(self, rhs: bool = True):
        g = self.grid
        cell_terms, facet_terms, boundary_terms, rhs_cell_terms = s5_forms(
            self.pen_coef,
            self.stab_coef,
            self.E_in,
            self.nu_in,
            self.E_out,
            self.nu_out,
            self.primal_degree,
            self.flux_degree,
            self.levelset_degree,
            self.phi_h,
            self.f,
            self.tags.boundaries_measure(100),
            self.tags.boundaries_measure(101),
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

    def rigid_modes(self) -> tuple:
        """The system's exact null space: COLLECTIVE rigid-body motions of
        (u_in, u_out).  Neither displacement block carries a grounding BC
        (the Dirichlet rows on u_in sit on outer-box DoFs outside every
        active term's support — same in the reference, which is why it
        configures MUMPS null-pivot handling, main.py:251-254), and an
        equal rigid motion of both blocks has zero strain, zero penalty
        jump (su = u_in - u_out + p phi/h with p = 0) and zero flux."""
        return s5_rigid_modes(self.system, self.U, interpolate)

    def lattice_preconditioner(
        self,
        min_n: int = 16,
        dtype=jnp.float32,
        interface: bool = True,
        refresh: bool = False,
        coupled: bool = True,
        **interface_kw,
    ):
        """S5 default: the multilevel COUPLED hierarchy — the flat
        bulk/band splitting is h-dependent for interface transmission
        (outer iters 15/39/108 at n=32/64/128; grid-independent with the
        coupled coarse levels).  ``coupled=False`` falls back to the flat
        single-level preconditioner."""
        if coupled and interface:
            return self.coupled_preconditioner(
                min_n=min_n, dtype=dtype, refresh=refresh, **interface_kw
            )
        return super().lattice_preconditioner(
            min_n=min_n, dtype=dtype, interface=interface, refresh=refresh,
            **interface_kw,
        )

    def _bulk_neumann_fields(self) -> tuple:
        """Both displacement bulks end at the immersed interface with a
        natural (traction-transfer) condition — their bulk MG needs the
        free-boundary variable stencil (see SchemeBase)."""
        return ("u_in", "u_out")

    def _resolved_fourier_k(self) -> int:
        K = self.coarse_fourier_k
        if K is None:
            K = int(np.clip(max(self.grid.nx, self.grid.ny) // 4, 8, 64))
        return K

    def _coarse_matrix_builder(self):
        """Device-side coarse-basis builder (preferred by
        ``SchemeBase.lattice_preconditioner`` over the host pytree path:
        no O(k * ndofs) host->device upload — see
        :func:`s5_fourier_builder`)."""
        K = self._resolved_fourier_k()
        if K <= 0:
            return None
        ct = np.asarray(self.cell_tags)
        coords = self.U.dof_coords_np
        cut_pts = coords[
            np.asarray(dof_mask_from_cells(self.U, np.where(ct == 2)[0]))
        ]
        if cut_pts.shape[0] == 0:
            return None
        in_pts = coords[
            np.asarray(dof_mask_from_cells(self.U, np.where(ct == 1)[0]))
        ]
        c = cut_pts.mean(axis=0)
        rin = (
            float(np.hypot(in_pts[:, 0] - c[0], in_pts[:, 1] - c[1]).mean())
            if len(in_pts)
            else 0.0
        )
        return s5_fourier_builder(self.system, self.grid, cut_pts, rin, K)

    def _coarse_modes(self) -> tuple:
        """Coarse space for the transmission system.

        ``coarse_fourier_k > 0`` (default): interface-harmonic Fourier
        modes up to that frequency on BOTH sides (see
        :func:`s5_fourier_modes`) — the substructuring coarse space that
        makes the flat preconditioner grid-independent.  Its span contains
        the rigid translations/rotation of each side.

        ``coarse_fourier_k == 0``: rigid motions of u_in ALONE — the
        minimal floating-subdomain space.  u_in has no Dirichlet row of
        its own (see rigid_modes), so a relative rigid motion's energy
        sits entirely in the cut-band penalty block: the bulk MG sees zero
        residual for it and the band solve cannot update bulk DoFs.
        (Collective (u_in, u_out) motions are the exact null space and are
        handled by deflation instead.)"""
        K = self._resolved_fourier_k()
        if K > 0:
            ct = np.asarray(self.cell_tags)
            return s5_fourier_modes(
                self.system,
                self.U.dof_coords_np,
                np.asarray(
                    dof_mask_from_cells(self.U, np.where(ct == 2)[0])
                ),
                np.asarray(
                    dof_mask_from_cells(self.U, np.where(ct == 1)[0])
                ),
                K,
            )
        modes = []
        for m in self.rigid_modes():
            mm = dict(m)
            mm["u_out"] = jnp.zeros_like(m["u_out"])
            modes.append(mm)
        return tuple(modes)

    def solve(self, method: str = "bicgstab", tol: float = 1e-10, **kw) -> SolveResult:
        # Auto-deflate the collective rigid modes for ITERATIVE methods
        # only: they are near-null directions (smallest singular values
        # ~3e-5 at level 0 — ill-conditioned, not exactly singular) that
        # stall Krylov, but direct LU handles them fine and the bordered
        # constraint Q'x = 0 would DISTORT the solution (measured: L2
        # 0.887 vs 0.165 at level 0).  The reference's MUMPS null-pivot
        # flags are likewise a safety net, not an active constraint here.
        if method not in ("dense", "sparse") and "deflate" not in kw:
            kw["deflate"] = self.rigid_modes()
        res = solve(self.op, self.b, bcs=self.bcs, method=method, tol=tol, **kw)
        self.result = res
        self.u_in_h = Function(self.U, res.x["u_in"])
        self.u_out_h = Function(self.U, res.x["u_out"])
        self.u_h = Function(
            self.U,
            s5_recombine(self.U, self.cell_tags, res.x["u_in"], res.x["u_out"]),
        )
        return res
