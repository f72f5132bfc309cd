"""p-multigrid: on-device preconditioning of degree>=2 phi-FEM systems.

Plain Jacobi-preconditioned Krylov floors on penalized high-degree systems
(measured: ~1e-6 relative residual at degree 3, ~5.6e-10 on P2 tets), which
round 3 papered over with a cached HOST SuperLU factorization
(``solve(method="sparse")``) — a host detour on the solve path.  The
on-device replacement is the classical p-multigrid / low-order-refined
(LOR) design, already used for the 3D Q2/Q3 bulk in
``models/weak_dirichlet3.py`` and generalized here to every backend:

* smoother: damped Jacobi on the high-degree system (the high-frequency,
  intra-cell error modes);
* coarse space: the SAME scheme re-discretized at degree 1 on the SAME
  mesh, corrected by its existing degree-1 machinery (lattice MG + cut-band
  solve on structured grids, Jacobi elsewhere) — spectral equivalence of
  the P1/Q1 rediscretization with the Pk/Qk operator is the standard
  LOR/"FEM-SEM" result;
* transfers: the degree-1 -> degree-k nodal interpolation P (exact, local:
  high-degree nodes have closed-form barycentric positions inside their
  cell) and its transpose as restriction.  Both are ELL gather/scatter
  forms that XLA fuses; construction is pure host preprocessing.
* cut band: the h^-3 penalty block of the HIGH-degree operator gets the
  same multiplicative interface solve every phi-FEM preconditioner here
  uses (:func:`phifem_tpu.mg.attach_interface_solve` — degree-agnostic).

Reference parity note: the reference LU-solves every degree (PETSc/MUMPS,
``demo/weak-dirichlet/flower/main.py:45``, degrees 1-3 parametrized in
``tests/test_compute_meshtags.py``); this module iterates those systems
on the device instead.

Use :meth:`phifem_tpu.models.base.SchemeBase.p_multigrid_preconditioner`,
with an ``fgmres`` outer solve (the low-level correction may carry a few
inner Krylov iterations, making M nonstationary).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .mg import VCycle

Array = jnp.ndarray

__all__ = ["p_transfer", "PMGVCycle"]


def p_transfer(space_high, space_low) -> Tuple[np.ndarray, np.ndarray]:
    """ELL form (idx, wts) of the nodal prolongation P: low -> high.

    ``P v`` interpolates a low-degree FE function at the high-degree nodal
    points: row i of P holds the low-degree basis values at high node i,
    supported on that node's cell.  Exact and backend-generic — both
    structured :class:`~phifem_tpu.spaces.Space` and unstructured
    :class:`~phifem_tpu.uassembly.USpace` expose ``element`` (with
    reference ``nodes``) and ``cell_dofs_np``; the per-cell map is the
    same reference-element tabulation for every cell, so no geometry is
    touched.  Nodes shared by several cells receive identical values from
    each (FE continuity), so a plain per-cell overwrite is well-defined.

    Returns ``idx (Nh, nloc_low) int32`` and ``wts (Nh, nloc_low)``.
    """
    el_h, el_l = space_high.element, space_low.element
    if el_h.cell != el_l.cell:
        raise ValueError("p_transfer requires matching cell types")
    T = el_l.tabulate(el_h.nodes)  # (nloc_h, nloc_l)
    cd_h = np.asarray(space_high.cell_dofs_np)
    cd_l = np.asarray(space_low.cell_dofs_np)
    Nh = space_high.num_scalar_dofs
    idx = np.zeros((Nh, cd_l.shape[1]), np.int32)
    wts = np.zeros((Nh, cd_l.shape[1]))
    for l in range(cd_h.shape[1]):
        g = cd_h[:, l]
        idx[g] = cd_l
        wts[g] = T[l]
    return idx, wts


def _apply_P(idx: Array, wts: Array, v: Array) -> Array:
    """(Nl, *vs) -> (Nh, *vs): vh[i] = sum_k wts[i,k] v[idx[i,k]]."""
    g = v[idx]  # (Nh, K, *vs)
    w = wts.astype(v.dtype).reshape(wts.shape + (1,) * (v.ndim - 1))
    return (w * g).sum(axis=1)


def _apply_PT(idx: Array, wts: Array, nl: int, r: Array) -> Array:
    """(Nh, *vs) -> (Nl, *vs): transpose scatter-add of :func:`_apply_P`."""
    w = wts.astype(r.dtype).reshape(wts.shape + (1,) * (r.ndim - 1))
    upd = w * r[:, None]  # (Nh, K, *vs)
    out = jnp.zeros((nl,) + r.shape[1:], r.dtype)
    return out.at[idx].add(upd)


@dataclasses.dataclass
class PMGVCycle(VCycle):
    """Two-level p-multigrid cycle usable anywhere a V-cycle is.

    ``levels[0]`` is the high-degree system (masked matvec / inv_diag /
    active from :func:`phifem_tpu.mg._masked_matvec`); the degree-1
    correction is delegated to ``low_apply`` (typically the degree-1
    twin's own lattice preconditioner, optionally wrapped in a few inner
    Krylov iterations).  The inherited machinery provides the
    identity-on-inactive-rows projection and the multiplicative cut-band
    solve (:func:`phifem_tpu.mg.attach_interface_solve` attaches to this
    class unchanged)."""

    transfers: Optional[Dict[str, Tuple[Array, Array]]] = None
    low_sizes: Optional[Dict[str, int]] = None  # field -> num low scalar dofs
    low_active: Optional[Dict[str, Array]] = None
    low_apply: Optional[Callable] = None

    def _cycle(self, k: int, b):
        lvl = self.levels[0]
        zero = jax.tree.map(jnp.zeros_like, b)
        x = self._smooth(lvl, zero, b, self.pre_smooth)
        r = jax.tree.map(lambda bi, ai: bi - ai, b, lvl.matvec(x))
        r = jax.tree.map(
            lambda ri, m: jnp.where(m, ri, jnp.zeros_like(ri)), r, lvl.active
        )
        rc = {
            f: _apply_PT(*self.transfers[f], self.low_sizes[f], r[f])
            for f in r
        }
        rc = jax.tree.map(
            lambda ri, m: jnp.where(m, ri, jnp.zeros_like(ri)),
            rc,
            self.low_active,
        )
        ec = self.low_apply(rc)
        for f in b:
            corr = _apply_P(*self.transfers[f], ec[f])
            x[f] = jnp.where(lvl.active[f], x[f] + corr, x[f])
        return self._smooth(lvl, x, b, self.post_smooth)


def build_p_preconditioner(
    scheme,
    min_n: int = 16,
    dtype=jnp.float32,
    low_iters: int = 10,
    low_tol: float = 1e-2,
    **interface_kw,
):
    """Assemble the p-multigrid preconditioner for a degree>=2 scheme.

    Works for any scheme object exposing ``op``, ``system``,
    ``_setup_args`` and ``_p1_twin()`` (both the structured
    :class:`~phifem_tpu.models.base.SchemeBase` and the unstructured
    ``USchemeBase`` families).  The degree-1 twin is re-set-up and
    assembled on the same mesh; its correction is an equilibrated inner
    BiCGStab (``low_iters`` iterations, making the outer preconditioner
    NONSTATIONARY — use ``method="fgmres"``), preconditioned by the twin's
    own ``lattice_preconditioner`` where one exists (structured grids) and
    by the equilibration alone (Jacobi) elsewhere.
    """
    from .mg import Level, _masked_matvec, attach_interface_solve
    from .solvers import _pbicgstab, masked_operator

    low = scheme._p1_twin()
    low.setup(*scheme._setup_args)
    low.assemble(rhs=False)

    bcs = getattr(scheme, "bcs", ())
    low_bcs = getattr(low, "bcs", ())
    matvec, inv_diag, active = _masked_matvec(scheme.op, bcs, None)
    low_mv, low_inv_diag, low_active = _masked_matvec(low.op, low_bcs, None)

    M_low = None
    if hasattr(low, "lattice_preconditioner"):
        M_low = low.lattice_preconditioner(min_n=min_n, dtype=dtype)

    # symmetric equilibration of the low system (its penalty rows scale
    # h^-3 too); dsqrt from the masked inverse diagonal (1 on inactive)
    dsqrt = jax.tree.map(
        lambda di: 1.0 / jnp.sqrt(jnp.abs(di)), low_inv_diag
    )
    dinv = jax.tree.map(lambda d: 1.0 / d, dsqrt)

    def mv_eq(y):
        xs = jax.tree.map(jnp.multiply, y, dinv)
        return jax.tree.map(jnp.multiply, low_mv(xs), dinv)

    if M_low is not None:
        M = lambda r: jax.tree.map(
            jnp.multiply,
            M_low(jax.tree.map(jnp.multiply, r, dsqrt)),
            dsqrt,
        )
    else:
        M = lambda r: r  # equilibrated system has unit diagonal

    def low_apply(rc):
        if low_iters == 0:
            return M_low(rc) if M_low is not None else jax.tree.map(
                jnp.multiply, rc, low_inv_diag
            )
        beq = jax.tree.map(jnp.multiply, rc, dinv)
        x0 = jax.tree.map(jnp.zeros_like, beq)
        x, _ = _pbicgstab(
            mv_eq, beq, x0, tol=low_tol, atol=0.0, maxiter=low_iters, M=M
        )
        return jax.tree.map(jnp.multiply, x, dinv)

    transfers, low_sizes = {}, {}
    for f, sp in scheme.system.fields.items():
        idx, wts = p_transfer(sp, low.system.fields[f])
        transfers[f] = (jnp.asarray(idx), jnp.asarray(wts))
        low_sizes[f] = low.system.fields[f].num_scalar_dofs

    lvl = Level(
        getattr(scheme, "grid", getattr(scheme, "mesh", None)),
        matvec,
        inv_diag,
        active,
    )
    vc = PMGVCycle(
        [lvl],
        vertex_fields=(),
        transfers=transfers,
        low_sizes=low_sizes,
        low_active=low_active,
        low_apply=low_apply,
    )
    _, _, active_full = masked_operator(scheme.op, bcs)
    vc = attach_interface_solve(vc, scheme.op, active_full, **interface_kw)
    return vc
