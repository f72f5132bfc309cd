"""Element-distributed SPMD execution for unstructured (imported) meshes.

The reference's unstructured path inherits dolfinx's MPI partitioning:
cells are distributed over ranks, each rank assembles and applies its own
elements, and PETSc reduces the shared-DoF (ghost) contributions
(reference ``demo/weak-dirichlet/flower/main.py:46`` — every mesh lives on
``MPI.COMM_WORLD``).  The SPMD twin for the unstructured backend
(:mod:`phifem_tpu.uassembly`):

* every entity batch's ELEMENT axis is padded and sharded over a 1D
  ``jax.sharding.Mesh`` — the per-element work (gather -> batched local
  matmul -> scatter-add) is where the arithmetic lives;
* DoF vectors stay replicated — imported meshes are reference-scale
  (10^3-10^5 cells; the structured lattice is the scale path), so one
  vector copy per device is cheap and removes all halo bookkeeping on
  irregular connectivity;
* the matvec is ONE ``shard_map`` program: each device scatters its
  elements' contributions into a device-local accumulator and a single
  ``lax.psum`` reduces them — the MPI ghost-update analogue.

Unlike :class:`~phifem_tpu.parallel.halo.HaloOperator` (structured row
slabs, ppermute halo exchange, O(1) vector memory per device) this trades
replicated vectors for zero assumptions about mesh structure — exactly the
dolfinx decomposition contract the reference relies on.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..assembly import Operator
from ..solvers import lift_rhs, tree_axpy, tree_dot

Array = jnp.ndarray

AXIS = "shard"

__all__ = [
    "ElementShardedOperator",
    "element_sharded_solve",
    "PartitionedUOperator",
    "partitioned_solve",
]


def _rep(mesh: Mesh):
    return NamedSharding(mesh, P())


def _shd(mesh: Mesh):
    return NamedSharding(mesh, P(AXIS))


class ElementShardedOperator:
    """Entity batches sharded over the device mesh; replicated DoF vectors.

    The matvec acts as the reduced operator (identity on inactive/BC DoFs)
    like :func:`phifem_tpu.solvers.masked_operator`.  After
    ``op.reassemble()`` call :meth:`refresh` to re-shard the rebuilt
    data-dependent element matrices (geometry-uniform batches are
    constants and never change).
    """

    def __init__(self, op: Operator, mesh: Mesh, bcs=()):
        self.op, self.mesh, self.bcs = op, mesh, tuple(bcs)
        nP = mesh.shape[AXIS]
        self.nP = nP

        self._segdofs: List[List[Array]] = []
        self._segmeta: List[List[Tuple[str, Tuple[int, ...]]]] = []
        self._valid: List[Array] = []
        self._orient: List[Optional[Array]] = []
        self._nep: List[int] = []
        for b in op.batches:
            ne = b.segments[0][1].shape[0]
            ne_p = max(1, -(-ne // nP))
            self._nep.append(ne_p)
            valid = np.zeros(nP * ne_p, bool)
            valid[:ne] = True
            valid = valid.reshape(nP, ne_p)
            segdofs, segmeta = [], []
            for name, dofs, vs in b.segments:
                d = np.zeros((nP * ne_p,) + dofs.shape[1:], np.int32)
                d[:ne] = np.asarray(dofs)
                segdofs.append(
                    jax.device_put(d.reshape((nP, ne_p) + dofs.shape[1:]), _shd(mesh))
                )
                segmeta.append((name, tuple(vs)))
            self._segdofs.append(segdofs)
            self._segmeta.append(segmeta)
            self._valid.append(jax.device_put(valid, _shd(mesh)))
            if b.orient is not None:
                o = np.zeros(nP * ne_p, np.int32)
                o[:ne] = np.asarray(b.orient)
                self._orient.append(
                    jax.device_put(o.reshape(nP, ne_p), _shd(mesh))
                )
            else:
                self._orient.append(None)
        self._mats = self._shard_mats()

        # masked-operator data (replicated — vectors are replicated too)
        diag = op.diagonal()
        active = jax.tree.map(lambda d: d != 0.0, diag)
        for bc in bcs:
            active[bc.field] = jnp.logical_and(
                active[bc.field],
                jnp.logical_not(jnp.broadcast_to(bc.mask, active[bc.field].shape)),
            )
        self.active = active
        self.diag = jax.tree.map(
            lambda d, a: jnp.where(a, d, jnp.ones_like(d)), diag, active
        )
        self._mv = self._build_matvec()

    def _shard_mats(self) -> List[Array]:
        mats = []
        for b, ne_p, orient in zip(self.op.batches, self._nep, self._orient):
            if orient is not None:
                # uniform batch: tiny (norient, L, L) table — replicate
                mats.append(jax.device_put(jnp.asarray(b.matrices), _rep(self.mesh)))
            else:
                m = np.asarray(b.matrices)
                ne = m.shape[0]
                pad = np.zeros((self.nP * ne_p,) + m.shape[1:], m.dtype)
                pad[:ne] = m
                mats.append(
                    jax.device_put(
                        pad.reshape((self.nP, ne_p) + m.shape[1:]), _shd(self.mesh)
                    )
                )
        return mats

    def refresh(self) -> None:
        """Re-shard element matrices after ``op.reassemble()`` (the
        distributed-assembly step: rebuilt per-element matrices repartition
        over the mesh; dof tables/orientations are topology and never move)."""
        self._mats = self._shard_mats()

    # ------------------------------------------------------------- matvec
    def _build_matvec(self) -> Callable:
        segmeta = self._segmeta
        mesh = self.mesh

        def local_mv(x, segdofs, valids, mats_list, orients):
            y = jax.tree.map(jnp.zeros_like, x)
            for meta, dofs_l, valid, mats, orient in zip(
                segmeta, segdofs, valids, mats_list, orients
            ):
                dofs = [d[0] for d in dofs_l]  # (ne_p, nloc): leading dev axis
                ne_p = dofs[0].shape[0]
                parts = []
                for (f, vs), di in zip(meta, dofs):
                    parts.append(x[f][di].reshape(ne_p, -1))
                xg = jnp.concatenate(parts, axis=1)
                if orient is None:
                    yl = jnp.einsum("eij,ej->ei", mats[0], xg)
                else:
                    ol = orient[0]
                    yl = xg @ mats[0].T
                    for o in range(1, mats.shape[0]):
                        yl = jnp.where((ol == o)[:, None], xg @ mats[o].T, yl)
                    yl = yl * valid[0][:, None].astype(yl.dtype)
                cur = 0
                for (f, vs), di in zip(meta, dofs):
                    nloc = di.shape[1]
                    vsz = int(np.prod(vs)) if vs else 1
                    seg = yl[:, cur : cur + nloc * vsz].reshape((ne_p, nloc) + vs)
                    y[f] = y[f].at[di].add(seg)
                    cur += nloc * vsz
            return jax.tree.map(lambda v: lax.psum(v, AXIS), y)

        rep, shd = P(), P(AXIS)
        x_spec = {f: rep for f in self.op.system.fields}
        in_specs = (
            x_spec,
            [[shd for _ in ds] for ds in self._segdofs],
            [shd for _ in self._valid],
            [rep if o is not None else shd for o in self._orient],
            [None if o is None else shd for o in self._orient],
        )
        mv_sharded = jax.shard_map(
            local_mv, mesh=mesh, in_specs=in_specs, out_specs=x_spec
        )

        segdofs, valids, orients = self._segdofs, self._valid, self._orient
        active = self.active

        def matvec(x, mats_list=None):
            mats_list = self._mats if mats_list is None else mats_list
            xa = jax.tree.map(lambda xi, a: jnp.where(a, xi, 0.0), x, active)
            yv = mv_sharded(xa, segdofs, valids, mats_list, orients)
            return jax.tree.map(
                lambda yi, xi, a: jnp.where(a, yi, xi), yv, x, active
            )

        return matvec

    def matvec(self, x: Dict[str, Array]) -> Dict[str, Array]:
        """Masked distributed matvec on replicated DoF pytrees."""
        return self._mv(x)


def element_sharded_solve(
    op: Operator,
    b: Dict[str, Array],
    mesh: Mesh,
    bcs=(),
    method: str = "bicgstab",
    tol: float = 1e-10,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    deflate: Optional[Tuple[Dict[str, Array], ...]] = None,
):
    """Distributed Krylov solve on an imported (unstructured) mesh.

    The element work and the per-element assembly distribute over the
    mesh; the Krylov recurrence runs replicated (its vectors are) and the
    matvec's single psum is the only cross-device reduction per iteration
    — the SPMD replacement for PETSc's MPI KSP on a dolfinx-partitioned
    mesh (reference N13).  ``deflate`` carries known null-space modes
    (e.g. S5 rigid modes) exactly like :func:`phifem_tpu.solvers.solve`.

    Returns ``(x, relres, iterations)``.
    """
    E = ElementShardedOperator(op, mesh, bcs)
    b = lift_rhs(op, b, bcs, E.active, raw_matvec=None)
    b = jax.device_put(b, _rep(mesh))

    dsqrt = jax.tree.map(
        lambda d: jnp.sqrt(jnp.where(jnp.abs(d) > 1e-30, jnp.abs(d), 1.0)),
        E.diag,
    )
    dinv = jax.tree.map(lambda d: 1.0 / d, dsqrt)

    def mv_eq(y):
        xs = jax.tree.map(jnp.multiply, y, dinv)
        return jax.tree.map(jnp.multiply, E.matvec(xs), dinv)

    if maxiter is None:
        maxiter = 25 * int(math.isqrt(op.system.num_dofs)) + 1000

    from ..solvers import _pbicgstab, _pcg

    runner = {"cg": _pcg, "bicgstab": _pbicgstab}[method]

    @jax.jit
    def run(b, defl):
        beq = jax.tree.map(jnp.multiply, b, dinv)
        mv, M = mv_eq, lambda r: r
        if defl:
            ortho = []
            for v in defl:
                q = jax.tree.map(
                    lambda vi, m, di: jnp.where(m, vi, 0.0) * di,
                    v, E.active, dsqrt,
                )
                for o in ortho:
                    q = tree_axpy(-tree_dot(o, q), o, q)
                nrm = jnp.sqrt(tree_dot(q, q))
                q = jax.tree.map(lambda qi: qi / jnp.maximum(nrm, 1e-300), q)
                ortho.append(q)

            def _proj(v):
                for o in ortho:
                    v = tree_axpy(-tree_dot(o, v), o, v)
                return v

            mv_plain = mv_eq

            def mv(y):
                z = _proj(mv_plain(_proj(y)))
                for o in ortho:
                    z = tree_axpy(tree_dot(o, y), o, z)
                return z

            M = _proj
            beq = _proj(beq)

        x0 = jax.tree.map(jnp.zeros_like, beq)
        x, it = runner(mv, beq, x0, tol=tol, atol=atol, maxiter=maxiter, M=M)
        r = jax.tree.map(lambda bi, ai: bi - ai, beq, mv(x))
        rnorm = jnp.sqrt(tree_dot(r, r))
        bnorm = jnp.sqrt(tree_dot(beq, beq))
        if defl:
            x = _proj(x)
        x = jax.tree.map(jnp.multiply, x, dinv)
        return x, jnp.stack(
            [rnorm / jnp.maximum(bnorm, 1e-300), it.astype(rnorm.dtype)]
        )

    x, stats = run(b, deflate)
    stats = np.asarray(stats)
    return x, float(stats[0]), int(stats[1])


# ---------------------------------------------------------------------------
# Memory-scaling variant: PARTITIONED DoF vectors (dolfinx's distributed
# vectors).  Each device owns a contiguous block of
# every field's scalar DoFs; elements are assigned to the owner of their
# first DoF; ghost values cross devices through ONE precomputed
# lax.all_to_all exchange per matvec (and one reverse exchange for the
# scatter-add), so per-device vector memory is ~1/n_devices instead of the
# full replica ElementShardedOperator keeps.
# ---------------------------------------------------------------------------


class PartitionedUOperator:
    """Element- AND DoF-partitioned unstructured operator.

    Host preprocessing (once): per-field block ownership, per-device
    element lists, global->device-local DoF remaps, and the pairwise
    send/recv index maps of the ghost exchange.  Device execution: the
    matvec is one ``shard_map`` program — gather ghosts (all_to_all),
    per-element gather -> batched matmul -> scatter-add into the local
    accumulator, return ghost contributions to their owners (reverse
    all_to_all).  This is exactly dolfinx's owner-computes + ghost-update
    decomposition (reference ``mesh_scripts.py:264``'s parallel contract)
    expressed in XLA collectives.

    Local index space per field on each device: ``[0, chunk)`` owned
    (global ``g - p*chunk``), then the device's ghosts, then ONE dummy
    slot absorbing padded entities and padded exchange slots.
    """

    def __init__(self, op: Operator, mesh: Mesh, bcs=()):
        self.op, self.mesh, self.bcs = op, mesh, tuple(bcs)
        nP = mesh.shape[AXIS]
        self.nP = nP
        names = list(op.system.fields)
        self.names = names

        # ---- ownership
        self.chunk: Dict[str, int] = {}
        self.vshape: Dict[str, Tuple[int, ...]] = {}
        for f in names:
            sp = op.system.fields[f]
            self.chunk[f] = -(-sp.num_scalar_dofs // nP)
            self.vshape[f] = tuple(sp.dof_shape[1:])

        def owner_of(f, g):
            return np.minimum(g // self.chunk[f], nP - 1)

        # ---- element partition (owner of first dof of first segment)
        ent_dev: List[np.ndarray] = []
        for b in op.batches:
            f0, d0, _ = b.segments[0]
            ent_dev.append(owner_of(f0, np.asarray(d0).reshape(d0.shape[0], -1)[:, 0]))

        # ---- per-device ghost discovery
        ghosts = {f: [set() for _ in range(nP)] for f in names}
        for b, dev in zip(op.batches, ent_dev):
            for f, dofs, _ in b.segments:
                dn = np.asarray(dofs).reshape(dofs.shape[0], -1)
                own = owner_of(f, dn)
                for p in range(nP):
                    rows = dev == p
                    if rows.any():
                        foreign = dn[rows][own[rows] != p]
                        ghosts[f][p].update(foreign.tolist())
        ghost_list = {
            f: [np.array(sorted(s), np.int64) for s in ghosts[f]]
            for f in names
        }
        self.nghost = {
            f: max(1, max(len(g) for g in ghost_list[f])) for f in names
        }

        # local slot of a global dof on device p (own / ghost / dummy)
        def local_of(f, p, g):
            ch = self.chunk[f]
            gl = ghost_list[f][p]
            res = np.full(g.shape, self._dummy(f), np.int64)
            own = owner_of(f, g) == p
            res[own] = g[own] - p * ch
            if len(gl):
                pos = np.clip(np.searchsorted(gl, g), 0, len(gl) - 1)
                hit = (~own) & (gl[pos] == g)
                res[hit] = ch + pos[hit]
            return res

        # ---- exchange maps: for device pair (p owner <- q requester)
        # recv_slot[q][p] = local slots on q for dofs owned by p
        # send_idx[p][q] = local-own indices on p for those same dofs
        S = {f: 1 for f in names}
        per_pair = {f: [[None] * nP for _ in range(nP)] for f in names}
        for f in names:
            ch = self.chunk[f]
            for q in range(nP):
                gl = ghost_list[f][q]
                own = owner_of(f, gl) if len(gl) else np.zeros(0, np.int64)
                for p in range(nP):
                    sel = gl[own == p] if len(gl) else np.zeros(0, np.int64)
                    per_pair[f][q][p] = sel
                    S[f] = max(S[f], len(sel))
        self.S = S
        send_idx, recv_slot, exch_valid = {}, {}, {}
        for f in names:
            ch = self.chunk[f]
            si = np.zeros((nP, nP, S[f]), np.int32)
            rs = np.full((nP, nP, S[f]), self._dummy(f), np.int32)
            va = np.zeros((nP, nP, S[f]), bool)
            for q in range(nP):
                gl = ghost_list[f][q]
                for p in range(nP):
                    sel = per_pair[f][q][p]
                    m = len(sel)
                    if m:
                        si[p, q, :m] = sel - p * ch
                        rs[q, p, :m] = ch + np.searchsorted(gl, sel)
                        # SEND-side layout (device p, peer q): masks the
                        # reverse exchange's scatter-add on the owner
                        va[p, q, :m] = True
            # sharded over leading device axis
            send_idx[f] = jax.device_put(si, _shd(mesh))
            recv_slot[f] = jax.device_put(rs, _shd(mesh))
            exch_valid[f] = jax.device_put(va, _shd(mesh))
        self.send_idx, self.recv_slot, self.exch_valid = (
            send_idx, recv_slot, exch_valid
        )

        # ---- per-device element tables, remapped to local DoF slots
        self._segmeta: List[List[Tuple[str, Tuple[int, ...]]]] = []
        self._segdofs: List[List[Array]] = []
        self._valid: List[Array] = []
        self._orient: List[Optional[Array]] = []
        self._nep: List[int] = []
        self._perm: List[np.ndarray] = []  # entity permutation per batch
        for b, dev in zip(op.batches, ent_dev):
            counts = np.bincount(dev, minlength=nP)
            ne_p = max(1, int(counts.max()))
            self._nep.append(ne_p)
            order = np.argsort(dev, kind="stable")
            self._perm.append(order)
            # slot table: for device p, its entities padded to ne_p
            slot = np.full((nP, ne_p), -1, np.int64)
            for p in range(nP):
                rows = order[dev[order] == p]
                slot[p, : len(rows)] = rows
            valid = slot >= 0
            slot_safe = np.where(valid, slot, 0)
            segdofs, segmeta = [], []
            for f, dofs, vs in b.segments:
                dn = np.asarray(dofs)
                picked = dn[slot_safe]  # (nP, ne_p, *loc)
                loc = np.zeros_like(picked, dtype=np.int32)
                for p in range(nP):
                    loc[p] = local_of(f, p, picked[p])
                # padded entities -> dummy slot (scatter-adds vanish there)
                loc[~valid] = self._dummy(f)
                segdofs.append(jax.device_put(loc, _shd(mesh)))
                segmeta.append((f, tuple(vs)))
            self._segdofs.append(segdofs)
            self._segmeta.append(segmeta)
            self._valid.append(jax.device_put(valid, _shd(mesh)))
            if b.orient is not None:
                o = np.asarray(b.orient)[slot_safe].astype(np.int32)
                self._orient.append(jax.device_put(o, _shd(mesh)))
            else:
                self._orient.append(None)
        self._mats = self._shard_mats()

        # ---- masked-operator data, partitioned
        diag = op.diagonal()
        active = jax.tree.map(lambda d: d != 0.0, diag)
        for bc in bcs:
            active[bc.field] = jnp.logical_and(
                active[bc.field],
                jnp.logical_not(
                    jnp.broadcast_to(bc.mask, active[bc.field].shape)
                ),
            )
        self.active_rep = active
        self.diag_rep = jax.tree.map(
            lambda d, a: jnp.where(a, d, jnp.ones_like(d)), diag, active
        )
        self.active = {
            f: self.partition_field(f, jnp.broadcast_to(
                active[f], op.system.fields[f].dof_shape))
            for f in names
        }
        self.diag = {
            f: self.partition_field(f, jnp.broadcast_to(
                self.diag_rep[f], op.system.fields[f].dof_shape))
            for f in names
        }
        self._mv = self._build_matvec()

    def _dummy(self, f: str) -> int:
        return self.chunk[f] + self.nghost[f]

    # ------------------------------------------------------- partition I/O
    def partition_field(self, f: str, v: Array) -> Array:
        """(N, *vs) replicated -> (nP, chunk, *vs) sharded (zero padded)."""
        ch, nP = self.chunk[f], self.nP
        vn = np.asarray(v)
        pad = np.zeros((nP * ch,) + vn.shape[1:], vn.dtype)
        pad[: vn.shape[0]] = vn
        return jax.device_put(
            pad.reshape((nP, ch) + vn.shape[1:]), _shd(self.mesh)
        )

    def partition(self, x: Dict[str, Array]) -> Dict[str, Array]:
        return {f: self.partition_field(f, x[f]) for f in self.names}

    def unpartition(self, x: Dict[str, Array]) -> Dict[str, Array]:
        out = {}
        for f in self.names:
            sp = self.op.system.fields[f]
            v = np.asarray(x[f]).reshape((-1,) + tuple(sp.dof_shape[1:]))
            out[f] = jnp.asarray(v[: sp.num_scalar_dofs])
        return out

    def _shard_mats(self) -> List[Array]:
        mats = []
        for b, ne_p, orient, perm in zip(
            self.op.batches, self._nep, self._orient, self._perm
        ):
            if orient is not None:
                mats.append(
                    jax.device_put(jnp.asarray(b.matrices), _rep(self.mesh))
                )
            else:
                # permuted to device order, then packed into the
                # (nP, ne_p) slot layout via the batch's validity mask
                # (row-major over valid slots == device-then-original
                # order == perm order)
                m = np.asarray(b.matrices)[perm]
                valid = np.asarray(self._valid[len(mats)])
                pad = np.zeros((self.nP, ne_p) + m.shape[1:], m.dtype)
                pad[valid] = m
                mats.append(jax.device_put(pad, _shd(self.mesh)))
        return mats

    def refresh(self) -> None:
        """Re-shard data-dependent element matrices after op.reassemble()
        (distributed assembly: topology/maps never move)."""
        self._mats = self._shard_mats()

    # ------------------------------------------------------------- matvec
    def _exchange_ghosts(self, f: str, x_own, send_idx, recv_slot):
        """x_own (chunk, *vs) -> x_loc (chunk+G+1, *vs) with ghosts."""
        buf = x_own[send_idx[0]]  # (nP, S, *vs)
        recv = lax.all_to_all(buf, AXIS, split_axis=0, concat_axis=0)
        L = self._dummy(f) + 1
        x_loc = jnp.zeros((L,) + x_own.shape[1:], x_own.dtype)
        x_loc = x_loc.at[: self.chunk[f]].set(x_own)
        return x_loc.at[recv_slot[0].reshape(-1)].set(
            recv.reshape((-1,) + x_own.shape[1:])
        )

    def _return_ghosts(self, f: str, y_loc, y_own, send_idx, recv_slot, valid):
        """Send ghost-slot accumulations back to their owners and add."""
        contrib = y_loc[recv_slot[0]]  # (nP, S, *vs)
        back = lax.all_to_all(contrib, AXIS, split_axis=0, concat_axis=0)
        vm = valid[0].reshape(valid[0].shape + (1,) * (y_own.ndim - 1))
        back = jnp.where(vm, back, 0.0)
        return y_own.at[send_idx[0]].add(back)

    def _build_matvec(self) -> Callable:
        segmeta = self._segmeta
        mesh = self.mesh
        names = self.names

        def local_mv(x, active, segdofs, valids, mats_list, orients,
                     send_idx, recv_slot, exch_valid):
            # x: {f: (1, chunk, *vs)} local blocks (leading device axis 1)
            x_own = {f: jnp.where(active[f][0], x[f][0], 0.0) for f in names}
            x_loc = {
                f: self._exchange_ghosts(
                    f, x_own[f], send_idx[f], recv_slot[f]
                )
                for f in names
            }
            y_loc = {f: jnp.zeros_like(x_loc[f]) for f in names}
            for meta, dofs_l, valid, mats, orient in zip(
                segmeta, segdofs, valids, mats_list, orients
            ):
                dofs = [d[0] for d in dofs_l]  # (ne_p, *loc)
                ne_p = dofs[0].shape[0]
                parts = []
                for (f, vs), di in zip(meta, dofs):
                    parts.append(x_loc[f][di].reshape(ne_p, -1))
                xg = jnp.concatenate(parts, axis=1)
                if orient is None:
                    yl = jnp.einsum("eij,ej->ei", mats[0], xg)
                    yl = yl * valid[0][:, None].astype(yl.dtype)
                else:
                    ol = orient[0]
                    yl = xg @ mats[0].T
                    for o in range(1, mats.shape[0]):
                        yl = jnp.where((ol == o)[:, None], xg @ mats[o].T, yl)
                    yl = yl * valid[0][:, None].astype(yl.dtype)
                cur = 0
                for (f, vs), di in zip(meta, dofs):
                    nloc = int(np.prod(di.shape[1:]))
                    vsz = int(np.prod(vs)) if vs else 1
                    nn = nloc
                    seg = yl[:, cur : cur + nn * vsz].reshape(
                        (ne_p,) + tuple(di.shape[1:]) + vs
                    )
                    y_loc[f] = y_loc[f].at[di].add(seg)
                    cur += nn * vsz
            y_own = {}
            for f in names:
                yo = y_loc[f][: self.chunk[f]]
                yo = self._return_ghosts(
                    f, y_loc[f], yo, send_idx[f], recv_slot[f], exch_valid[f]
                )
                y_own[f] = jnp.where(active[f][0], yo, x[f][0])
            return {f: y_own[f][None] for f in names}

        self._local_mv = local_mv
        shd = P(AXIS)
        x_spec = {f: shd for f in names}
        in_specs = (
            x_spec,
            {f: shd for f in names},
            [[shd for _ in ds] for ds in self._segdofs],
            [shd for _ in self._valid],
            [P() if o is not None else shd for o in self._orient],
            [None if o is None else shd for o in self._orient],
            {f: shd for f in names},
            {f: shd for f in names},
            {f: shd for f in names},
        )
        self._mv_in_specs = in_specs
        mv_sharded = jax.shard_map(
            local_mv, mesh=mesh, in_specs=in_specs, out_specs=x_spec
        )

        def matvec(x, mats_list=None):
            mats_list = self._mats if mats_list is None else mats_list
            return mv_sharded(
                x, self.active, self._segdofs, self._valid, mats_list,
                self._orient, self.send_idx, self.recv_slot, self.exch_valid,
            )

        return matvec

    def matvec(self, x: Dict[str, Array]) -> Dict[str, Array]:
        """Masked distributed matvec on PARTITIONED pytrees
        ((nP, chunk, *vs) sharded arrays)."""
        return self._mv(x)


def partitioned_solve(
    op: Operator,
    b: Dict[str, Array],
    mesh: Mesh,
    bcs=(),
    method: str = "bicgstab",
    tol: float = 1e-10,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    deflate: Optional[Tuple[Dict[str, Array], ...]] = None,
):
    """Distributed Krylov solve with PARTITIONED DoF vectors.

    Memory-scaling twin of :func:`element_sharded_solve`: every Krylov
    vector is an owner-block sharded array (per-device memory
    ~1/n_devices), the matvec's ghost traffic is two targeted
    ``lax.all_to_all`` exchanges (dolfinx's VecGhostUpdate analogue), and
    the whole recurrence runs device-local inside ONE ``shard_map``
    program with ``lax.psum`` inner products.

    Returns ``(x, relres, iterations)`` with ``x`` unpartitioned.
    """
    from ..solvers import _pbicgstab, _pcg, tree_dot32

    E = PartitionedUOperator(op, mesh, bcs)
    names = E.names
    b = lift_rhs(op, b, bcs, E.active_rep, raw_matvec=None)
    b_p = E.partition(b)
    defl_p = tuple(E.partition(v) for v in (deflate or ()))

    if maxiter is None:
        maxiter = 25 * int(math.isqrt(op.system.num_dofs)) + 1000

    def pdot(a, c):
        return lax.psum(tree_dot32(a, c), AXIS)

    runner = {"cg": _pcg, "bicgstab": _pbicgstab}[method]
    local_mv = E._local_mv

    def run_local(b, diag, active, segdofs, valids, mats, orients,
                  send_idx, recv_slot, exch_valid, defl):
        def mv(x):
            return local_mv(
                x, active, segdofs, valids, mats, orients,
                send_idx, recv_slot, exch_valid,
            )

        dsqrt = jax.tree.map(
            lambda d: jnp.sqrt(jnp.where(jnp.abs(d) > 1e-30, jnp.abs(d), 1.0)),
            diag,
        )
        dinv = jax.tree.map(lambda d: 1.0 / d, dsqrt)

        def mv_eq(y):
            xs = jax.tree.map(jnp.multiply, y, dinv)
            return jax.tree.map(jnp.multiply, mv(xs), dinv)

        beq = jax.tree.map(jnp.multiply, b, dinv)
        M = lambda r: r
        mveq = mv_eq
        if defl:
            ortho = []
            for v in defl:
                q = jax.tree.map(
                    lambda vi, m, di: jnp.where(m, vi, 0.0) * di,
                    v, active, dsqrt,
                )
                for o in ortho:
                    q = tree_axpy(-pdot(o, q), o, q)
                nrm = jnp.sqrt(pdot(q, q))
                q = jax.tree.map(lambda qi: qi / jnp.maximum(nrm, 1e-300), q)
                ortho.append(q)

            def _proj(v):
                for o in ortho:
                    v = tree_axpy(-pdot(o, v), o, v)
                return v

            mv_plain = mv_eq

            def mveq(y):
                z = _proj(mv_plain(_proj(y)))
                for o in ortho:
                    z = tree_axpy(pdot(o, y), o, z)
                return z

            M = _proj
            beq = _proj(beq)

        x0 = jax.tree.map(jnp.zeros_like, beq)
        x, it = runner(
            mveq, beq, x0, tol=tol, atol=atol, maxiter=maxiter, M=M,
            dot=pdot,
        )
        r = jax.tree.map(lambda bi, ai: bi - ai, beq, mveq(x))
        rnorm = jnp.sqrt(pdot(r, r))
        bnorm = jnp.sqrt(pdot(beq, beq))
        if defl:
            x = _proj(x)
        x = jax.tree.map(jnp.multiply, x, dinv)
        return x, jnp.stack(
            [rnorm / jnp.maximum(bnorm, 1e-300), it.astype(rnorm.dtype)]
        )

    shd = P(AXIS)
    x_spec = {f: shd for f in names}
    (_, act_s, segdof_s, valid_s, mat_s, orient_s, si_s, rs_s, ev_s) = (
        E._mv_in_specs
    )
    run_sharded = jax.jit(jax.shard_map(
        run_local,
        mesh=mesh,
        in_specs=(
            x_spec, x_spec, act_s, segdof_s, valid_s, mat_s, orient_s,
            si_s, rs_s, ev_s, tuple(x_spec for _ in defl_p),
        ),
        out_specs=(x_spec, P()),
    ))
    x_p, stats = run_sharded(
        b_p, E.diag, E.active, E._segdofs, E._valid, E._mats, E._orient,
        E.send_idx, E.recv_slot, E.exch_valid, defl_p,
    )
    stats = np.asarray(stats)
    return E.unpartition(x_p), float(stats[0]), int(stats[1])
