"""Row-slab domain decomposition with explicit halo exchange (shard_map).

The real distributed-memory execution path (reference N13 / SURVEY 2c: the
dolfinx MPI domain decomposition the reference inherits, with its own tagging
not yet parallel-safe, ``mesh_scripts.py:264``): the background lattice is
partitioned into P row slabs over a 1D device mesh.  The operator matvec is
a ``jax.shard_map`` program per device:

1. pull H halo rows of x from the next device (one ``lax.ppermute``);
2. apply every entity batch locally — uniform terms as masked lattice
   stencils, cut-cell/ghost/boundary batches as gathered batched matmuls
   over host-prepartitioned per-device entity lists;
3. push the H rows of locally-computed contributions that belong to the
   next device back (one reverse ``ppermute``) and add.

Everything outside the matvec (Jacobi scaling, Krylov recurrences, dot
products) runs as ordinary jnp ops on the sharded padded arrays — GSPMD
inserts the psums.  Works for ANY grid size: rows are padded to a multiple
of the device count and padded DoFs are handled as inactive (identity
rows), exactly like exterior DoFs.

Supported field layouts: P1 vertex lattices (scalar/vector/tensor) and DG0
cell fields — every space the reference demos use.  Higher-degree fields
raise :class:`UnsupportedFieldError`; callers fall back to the GSPMD
sharding-constraint path (:mod:`.sharding`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..assembly import Operator
from ..grid import Grid
from ..ops.stencil import _QUAD_OFFS, _TRI_OFFS, StencilCellBatch
from ..solvers import lift_rhs

Array = jnp.ndarray

AXIS = "shard"

__all__ = ["HaloOperator", "UnsupportedFieldError", "halo_solve"]


class UnsupportedFieldError(ValueError):
    """System contains a field the halo decomposition cannot slab-partition."""


def _field_rows_width(space, grid: Grid) -> Tuple[int, int]:
    """(row count, scalar DoFs per row) of a field's row-major DoF layout."""
    if space.element.family == "DG" and space.degree == 0:
        return grid.ny, grid.nx * grid.cells_per_block
    if space.element.family == "Lagrange" and space.degree == 1:
        return grid.ny + 1, grid.nx + 1
    raise UnsupportedFieldError(
        f"halo decomposition supports P1/DG0 fields, got "
        f"{space.element.family} degree {space.degree}"
    )


def _sharded_spec(v) -> P:
    return P(AXIS, *([None] * (v.ndim - 1)))


def _replicated_spec(v) -> P:
    return P(*([None] * v.ndim))


class HaloOperator:
    """Slab-decomposed masked operator over a 1D device mesh.

    The matvec acts as the reduced operator A_red (identity on inactive /
    BC / padded DoFs) on *padded* DoF pytrees (see :meth:`pad`).
    """

    def __init__(self, op: Operator, grid: Grid, mesh: Mesh, bcs=()):
        self.op, self.grid, self.mesh, self.bcs = op, grid, mesh, tuple(bcs)
        nP = mesh.shape[AXIS]
        self.nP = nP

        # field row-major layouts: name -> (rows, width, value_shape)
        self.layout: Dict[str, Tuple[int, int, Tuple[int, ...]]] = {}
        rmax = 0
        for name, s in op.system.fields.items():
            rows, width = _field_rows_width(s, grid)
            self.layout[name] = (rows, width, tuple(s.value_shape))
            rmax = max(rmax, rows)
        self.m = m = -(-rmax // nP)  # rows per device

        # ---- classify batches, compute halo width from the entity tables
        stencil_raw, generic_raw = [], []
        H = 1
        for b in op.batches:
            if isinstance(b, StencilCellBatch):
                stencil_raw.append(b)
                continue
            rows_segs = [
                np.asarray(dofs) // self.layout[name][1]
                for name, dofs, vs in b.segments
            ]
            r0 = np.min([r.min(axis=1) for r in rows_segs], axis=0)
            span = max(int((r.max(axis=1) - r0).max()) for r in rows_segs)
            H = max(H, span)
            generic_raw.append((b, r0))
        if H > m:
            raise UnsupportedFieldError(
                f"halo width {H} exceeds slab height {m} "
                f"(grid too small for {nP} devices)"
            )
        self.H = H

        def shard(arr):
            arr = jnp.asarray(arr)
            return jax.device_put(arr, NamedSharding(mesh, _sharded_spec(arr)))

        # ---- stencil specs: pad + shard the per-orientation region masks;
        # table layout (rows, no, nx) so the row axis leads (shardable)
        self._stencil_mats: List[Array] = []  # (no, l, l) replicated
        self._stencil_masks: List[Array] = []  # (P*m, no, nx) sharded
        self._stencil_offs: List[Tuple] = []
        self._stencil_fields: List[str] = []
        for b in stencil_raw:
            bmasks = b.masks_or_ones()
            no, ny, nx = bmasks.shape
            mpad = np.zeros((nP * m, no, nx), bmasks.dtype)
            mpad[:ny] = np.moveaxis(bmasks, 0, 1)
            self._stencil_fields.append(b.field)
            self._stencil_mats.append(jnp.asarray(b.matrices))
            self._stencil_masks.append(shard(mpad))
            self._stencil_offs.append(
                _TRI_OFFS if grid.is_simplex else (_QUAD_OFFS,)
            )

        # ---- generic batches: host-prepartitioned per-device entity tables
        # each entry: (seg_dofs [(P,ne,nloc) sharded ...], seg_meta, valid,
        #              mats, orient)  with mats (P,ne,L,L) sharded for
        # per-entity batches or (no,L,L) replicated for uniform ones
        self._gen_segdofs: List[List[Array]] = []
        self._gen_segmeta: List[List[Tuple[str, Tuple[int, ...]]]] = []
        self._gen_valid: List[Array] = []
        self._gen_mats: List[Array] = []
        self._gen_orient: List[Optional[Array]] = []
        for b, r0 in generic_raw:
            dev = np.clip(r0 // m, 0, nP - 1)
            counts = np.bincount(dev, minlength=nP)
            ne_max = max(1, int(counts.max()))
            perm = np.zeros((nP, ne_max), np.int64)
            valid = np.zeros((nP, ne_max), bool)
            for p in range(nP):
                idx = np.where(dev == p)[0]
                perm[p, : len(idx)] = idx
                valid[p, : len(idx)] = True
            segdofs, segmeta = [], []
            for name, dofs, vs in b.segments:
                rows, width, _ = self.layout[name]
                d = np.asarray(dofs)[perm].astype(np.int64)
                d = d - (np.arange(nP) * m * width)[:, None, None]
                d[~valid] = 0
                assert d.min() >= 0 and d.max() < (m + H) * width, (
                    "entity DoF outside its owner's slab+halo"
                )
                segdofs.append(shard(d.astype(np.int32)))
                segmeta.append((name, vs))
            self._gen_segdofs.append(segdofs)
            self._gen_segmeta.append(segmeta)
            self._gen_valid.append(shard(valid))
            if b.orient is not None:
                orient = np.asarray(b.orient)[perm]
                orient[~valid] = 0
                self._gen_mats.append(jnp.asarray(b.matrices))
                self._gen_orient.append(shard(orient.astype(np.int32)))
            else:
                mats = jnp.asarray(b.matrices)[jnp.asarray(perm)]
                mats = mats * jnp.asarray(valid)[..., None, None].astype(mats.dtype)
                self._gen_mats.append(shard(mats))
                self._gen_orient.append(None)

        # ---- masked-operator data: diagonal / active (padded + sharded)
        diag = op.diagonal()
        active = jax.tree.map(lambda d: d != 0.0, diag)
        for bc in bcs:
            active[bc.field] = jnp.logical_and(
                active[bc.field],
                jnp.logical_not(
                    jnp.broadcast_to(bc.mask, active[bc.field].shape)
                ),
            )
        self.active_global = active
        self.active = {k: self.pad_field(k, v, fill=False) for k, v in active.items()}
        diag_p = {k: self.pad_field(k, v) for k, v in diag.items()}
        self.diag = jax.tree.map(
            lambda d, a: jnp.where(a, d, jnp.ones_like(d)), diag_p, self.active
        )
        self._mv = self._build_matvec()

    # ------------------------------------------------------------ pad/unpad
    def pad_field(self, name: str, v: Array, fill=0) -> Array:
        """(rows*width, *vs) -> padded, row-sharded (P*m*width, *vs)."""
        rows, width, _ = self.layout[name]
        total = self.nP * self.m
        x = v.reshape((rows, width) + v.shape[1:])
        padshape = (total - rows, width) + v.shape[1:]
        x = jnp.concatenate(
            [x, jnp.full(padshape, fill, v.dtype)], axis=0
        ).reshape((total * width,) + v.shape[1:])
        return jax.device_put(x, NamedSharding(self.mesh, _sharded_spec(x)))

    def pad(self, x: Dict[str, Array]) -> Dict[str, Array]:
        return {k: self.pad_field(k, v) for k, v in x.items()}

    def unpad(self, x: Dict[str, Array]) -> Dict[str, Array]:
        out = {}
        for k, v in x.items():
            rows, width, _ = self.layout[k]
            out[k] = v.reshape((self.nP * self.m, width) + v.shape[1:])[
                :rows
            ].reshape((rows * width,) + v.shape[1:])
        return out

    # ------------------------------------------------------------- matvec
    def _build_matvec(self):
        m, H, nP = self.m, self.H, self.nP
        layout = self.layout
        names = list(self.op.system.fields)
        st_fields, st_offs = self._stencil_fields, self._stencil_offs
        segmeta = self._gen_segmeta

        pull = [(i, i - 1) for i in range(1, nP)]  # receive from next
        push = [(i, i + 1) for i in range(nP - 1)]  # hand halo rows down

        def local_mv(x_loc, st_mats, st_masks, segdofs, valids, mats_list, orients):
            ext, y = {}, {}
            for f in names:
                rows, width, vs = layout[f]
                xl = x_loc[f].reshape((m, width) + x_loc[f].shape[1:])
                halo = lax.ppermute(xl[:H], AXIS, perm=pull)
                ext[f] = jnp.concatenate([xl, halo], axis=0)  # (m+H, width, *vs)
                y[f] = jnp.zeros_like(ext[f])

            # uniform scalar-P1 terms: masked lattice stencils (halo-1)
            for f, A_all, masks, offs_all in zip(
                st_fields, st_mats, st_masks, st_offs
            ):
                ml = jnp.moveaxis(masks, 0, 1)  # (no, m, nx)
                X, Y = ext[f], y[f]
                nx = ml.shape[-1]
                for o in range(A_all.shape[0]):
                    A, M = A_all[o], ml[o]
                    offs = offs_all[o] if len(offs_all) > 1 else offs_all[0]
                    xl = [X[dy : dy + m, dx : dx + nx] for (dx, dy) in offs]
                    for i, (dxi, dyi) in enumerate(offs):
                        zi = M * sum(A[i, j] * xl[j] for j in range(len(offs)))
                        Y = Y.at[dyi : dyi + m, dxi : dxi + nx].add(zi)
                y[f] = Y

            # entity batches: gather -> batched matmul -> scatter-add
            for meta, dofs_list, valid, mats, orient in zip(
                segmeta, segdofs, valids, mats_list, orients
            ):
                dofs_loc = [d[0] for d in dofs_list]  # squeeze (1, ne, nloc)
                valid_loc = valid[0]
                ne = valid_loc.shape[0]
                parts = []
                for (f, vs), dofs in zip(meta, dofs_loc):
                    flat = ext[f].reshape(((m + H) * layout[f][1],) + ext[f].shape[2:])
                    parts.append(flat[dofs].reshape(ne, -1))
                xg = jnp.concatenate(parts, axis=1)
                if orient is None:
                    yl = jnp.einsum("eij,ej->ei", mats[0], xg)
                else:
                    ol = orient[0]
                    yl = xg @ mats[0].T
                    for o in range(1, mats.shape[0]):
                        yl = jnp.where((ol == o)[:, None], xg @ mats[o].T, yl)
                    yl = yl * valid_loc[:, None].astype(yl.dtype)
                cur = 0
                for (f, vs), dofs in zip(meta, dofs_loc):
                    nloc = dofs.shape[1]
                    vsz = int(np.prod(vs)) if vs else 1
                    seg = yl[:, cur : cur + nloc * vsz].reshape((ne, nloc) + vs)
                    flat = y[f].reshape(((m + H) * layout[f][1],) + y[f].shape[2:])
                    flat = flat.at[dofs].add(seg)
                    y[f] = flat.reshape(y[f].shape)
                    cur += nloc * vsz

            out = {}
            for f in names:
                rows, width, vs = layout[f]
                recv = lax.ppermute(y[f][m : m + H], AXIS, perm=push)
                yl = y[f][:m].at[:H].add(recv)
                out[f] = yl.reshape((m * width,) + yl.shape[2:])
            return out

        # operands + their specs (mats for uniform batches are replicated;
        # everything row/device-partitioned is sharded on the leading axis)
        st_mats = self._stencil_mats
        st_masks = self._stencil_masks
        segdofs = self._gen_segdofs
        valids = self._gen_valid
        mats_list = self._gen_mats
        orients = self._gen_orient

        x_spec = {f: P(AXIS, *([None] * len(layout[f][2]))) for f in names}
        in_specs = (
            x_spec,
            [_replicated_spec(v) for v in st_mats],
            [_sharded_spec(v) for v in st_masks],
            [[_sharded_spec(d) for d in ds] for ds in segdofs],
            [_sharded_spec(v) for v in valids],
            [
                _replicated_spec(v) if o is not None else _sharded_spec(v)
                for v, o in zip(mats_list, orients)
            ],
            [None if o is None else _sharded_spec(o) for o in orients],
        )

        mv_sharded = jax.shard_map(
            local_mv,
            mesh=self.mesh,
            in_specs=in_specs,
            out_specs=x_spec,
        )

        active = self.active

        def matvec(x):
            xa = jax.tree.map(
                lambda xi, a: jnp.where(a, xi, 0.0), x, {f: active[f] for f in x}
            )
            yv = mv_sharded(
                xa, st_mats, st_masks, segdofs, valids, mats_list, orients
            )
            return jax.tree.map(
                lambda yi, xi, a: jnp.where(a, yi, xi),
                yv,
                x,
                {f: active[f] for f in x},
            )

        return matvec

    def matvec(self, x: Dict[str, Array]) -> Dict[str, Array]:
        """Masked matvec on padded sharded DoF pytrees (identity on
        inactive/BC/padded DoFs)."""
        return self._mv(x)


def halo_solve(
    op: Operator,
    grid: Grid,
    b: Dict[str, Array],
    mesh: Mesh,
    bcs=(),
    method: str = "bicgstab",
    tol: float = 1e-10,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
):
    """Distributed Krylov solve via the halo-exchange matvec.

    Returns ``(x, relres)`` with ``x`` in the standard (unpadded) layout.
    Dot products psum over the mesh; the matvec's slab seams ride
    collective permutes — the SPMD replacement for PETSc's MPI KSP
    (reference N9/N13).
    """
    H = HaloOperator(op, grid, mesh, bcs)
    b = lift_rhs(op, b, bcs, H.active_global)
    bp = H.pad(b)  # padded rows carry b=0 and active=False -> stay 0

    # symmetric diagonal equilibration (see solvers.solve)
    dsqrt = jax.tree.map(
        lambda d: jnp.sqrt(jnp.where(jnp.abs(d) > 1e-30, jnp.abs(d), 1.0)),
        H.diag,
    )
    dinv = jax.tree.map(lambda d: 1.0 / d, dsqrt)

    def matvec_eq(y):
        xs = jax.tree.map(jnp.multiply, y, dinv)
        z = H.matvec(xs)
        return jax.tree.map(jnp.multiply, z, dinv)

    beq = jax.tree.map(jnp.multiply, bp, dinv)

    if maxiter is None:
        maxiter = 25 * int(math.isqrt(op.system.num_dofs)) + 1000

    solver = {
        "cg": jax.scipy.sparse.linalg.cg,
        "bicgstab": jax.scipy.sparse.linalg.bicgstab,
    }[method]

    @jax.jit
    def run(beq):
        x, _ = solver(matvec_eq, beq, tol=tol, atol=atol, maxiter=maxiter)
        r = jax.tree.map(lambda bi, ai: bi - ai, beq, matvec_eq(x))
        dot = lambda t: jax.tree.reduce(
            jnp.add, jax.tree.map(lambda v: jnp.vdot(v, v), t)
        )
        return x, jnp.sqrt(dot(r)) / jnp.maximum(jnp.sqrt(dot(beq)), 1e-300)

    y, rel = run(beq)
    x = jax.tree.map(jnp.multiply, y, dinv)
    return H.unpad(x), float(rel)
