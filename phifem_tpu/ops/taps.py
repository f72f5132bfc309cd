"""Tap-form ("stencil-sparse") lattice operators.

Any assembled phi-FEM operator over degree-1 Lagrange (scalar / vector /
tensor) and DG0 fields on the structured grid has a sparsity graph that
lives on small constant lattice offsets: cell terms couple DoFs within one
cell (offset <= 1), interior-facet (ghost) terms couple the two cells
sharing a facet (offset <= 2), one-sided boundary terms a single cell.
This module re-expresses such an operator as a set of *block taps*

    y[bi][r, c, ki] += W_t[r, c, ki, kj] * x[bj][r + dr, c + dc, kj]

where ``bi``/``bj`` are *block lattices* — one (ny+1, nx+1, ncomp) vertex
lattice per Lagrange-P1 field, one (ny, nx, ncomp) cell lattice per DG0
field and triangle orientation — and ``W_t`` is a spatially varying
block-weight plane.  The matvec is then a short fixed sequence of shifted
elementwise multiply-adds (an einsum over the small channel axis per tap)
that XLA fuses into a few bandwidth-bound passes: no gathers, scatters or
index tables anywhere on the Krylov hot path.  For the S5 elasticity bulk
this is exactly the (2x2)-block vertex stencil, with spatially varying
weights carrying the cut-cell penalty couplings.

Division of labour with :mod:`phifem_tpu.ops.stencil`: geometry-uniform
scalar terms (the bulk stiffness) already run as constant-coefficient
stencils with O(1) weight storage — those batches are applied as-is.  The
taps carry everything else.  Weight planes are rebuilt by one jitted
scatter when the data-dependent element matrices change
(``Operator.reassemble``).

Reference counterpart: the CSR matrices PETSc assembles for every demo
solve (``demo/weak-dirichlet/flower/main.py:137-154``) — the same
operator values, laid out for a vector machine instead of pointer-chasing
SpMV.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import Grid
from . import HIGHEST

Array = jnp.ndarray

__all__ = ["TapOperator", "build_tap_operator", "supports_tap_form"]


# --------------------------------------------------------- field analysis
def _field_kind(space) -> Optional[str]:
    """'p1' | 'dg0' | None (unsupported)."""
    if space.element.family == "DG" and space.degree == 0:
        return "dg0"
    if space.element.family == "Lagrange" and space.degree == 1:
        return "p1"
    return None


def supports_tap_form(system) -> bool:
    return all(_field_kind(s) is not None for s in system.fields.values())


@dataclasses.dataclass(frozen=True)
class _FieldSpec:
    name: str
    kind: str  # 'p1' | 'dg0'
    vshape: Tuple[int, ...]
    vsz: int  # channels per block lattice
    nblocks: int  # block lattices of this field (2 for tri DG0)
    base: int  # first block-lattice id
    shape: Tuple[int, int]  # lattice (rows, cols)


def _field_specs(system, grid: Grid) -> List[_FieldSpec]:
    specs, base = [], 0
    for name, s in system.fields.items():
        kind = _field_kind(s)
        if kind == "p1":
            nb, shape = 1, (grid.ny + 1, grid.nx + 1)
        else:  # dg0
            nb = 2 if grid.is_simplex else 1
            shape = (grid.ny, grid.nx)
        specs.append(
            _FieldSpec(name, kind, tuple(s.value_shape), s.value_size, nb, base, shape)
        )
        base += nb
    return specs


def _scalar_positions(spec: _FieldSpec, grid: Grid, dofs: np.ndarray):
    """Per scalar-DoF id: (block index within field, row, col)."""
    if spec.kind == "p1":
        C = grid.nx + 1
        return np.zeros_like(dofs), dofs // C, dofs % C
    if grid.is_simplex:
        o = dofs % 2
        block = dofs // 2
    else:
        o = np.zeros_like(dofs)
        block = dofs
    return o, block // grid.nx, block % grid.nx


# ------------------------------------------------------------- the operator
@dataclasses.dataclass
class TapOperator:
    """Lattice block-tap form of an assembled
    :class:`phifem_tpu.assembly.Operator`.

    ``make_matvec(op)`` returns a drop-in replacement for
    ``Operator.matvec`` on the Krylov hot path (same pytree in/out).
    Stencil batches (uniform scalar terms) keep their own O(1)-weight
    path; ``W`` carries every remaining batch.
    """

    grid: Grid
    specs: List[_FieldSpec]
    taps: List[Tuple[int, int, int, int]]  # (bi, bj, dr, dc)
    tap_offsets: np.ndarray  # (ntaps + 1,) starts into the flat W buffer
    blk_shapes: List[Tuple[int, int]]  # per block id: lattice (rows, cols)
    blk_ch: List[int]  # per block id: channels
    pad: int
    W: Array  # flat concatenated (R, C, vi, vj) planes
    _w_static: Array  # static (non-rebuilt) batch contribution
    _dyn: List[Tuple[int, np.ndarray]]  # (batch index, flat scatter ids)
    _stencil_ids: List[int]  # op.batches indices applied outside the taps
    data_version: int = -1

    @property
    def num_taps(self) -> int:
        return len(self.taps)

    # -------------------------------------------------- lattice <-> pytree
    def _decompose(self, x: Dict[str, Array]) -> List[Array]:
        blocks: List[Array] = []
        for sp in self.specs:
            R, C = sp.shape
            if sp.nblocks == 1:
                blocks.append(x[sp.name].reshape(R, C, sp.vsz))
            else:  # tri DG0: cells interleave orientation 0/1
                a = x[sp.name].reshape(R, C, 2, sp.vsz)
                blocks.extend(a[:, :, ls, :] for ls in range(2))
        return blocks

    def _recompose(self, blocks: List[Array]) -> Dict[str, Array]:
        out: Dict[str, Array] = {}
        i = 0
        for sp in self.specs:
            R, C = sp.shape
            if sp.nblocks == 1:
                v = blocks[i]
            else:
                v = jnp.stack(blocks[i : i + sp.nblocks], axis=2)
            i += sp.nblocks
            nsc = R * C * sp.nblocks
            out[sp.name] = v.reshape((nsc,) + sp.vshape)
        return out

    # ------------------------------------------------------------- matvec
    def make_matvec(self, op, dtype=None, W=None):
        """A matvec closure computing in ``dtype`` (None = input dtype).
        Stencil-batch matrices / weight planes are pre-cast once.

        ``W`` optionally overrides the weight buffer — pass it as a traced
        jit argument to get a compiled solver that survives
        ``reassemble`` (weights change, structure doesn't).

        Two application forms:

        * per-tap loop (the original): one pad-slice + einsum per tap —
          bandwidth-optimal but OP-COUNT-bound on small/medium lattices
          (the 5-field S5 operator has ~600 taps, ~600 ops per matvec at
          59k DoF);
        * dense per-pair form (default when it fits): taps grouped by
          block pair and stacked over the full (2P+1)^2 offset axis —
          ONE permutation gather re-lays W into per-pair
          (noff^2, Ri, Ci, vi, vj) tensors (zeros on absent offsets),
          then one einsum per block pair against a shared stack of all
          shifted views.  ~25x fewer ops at ~2 extra passes over W.
          Gated by PHIFEM_TAPS_DENSE_MAX (elements; default 1.2e8) so
          10M-DoF-scale operators keep the bandwidth-optimal loop.
        """
        import os as _os

        P = self.pad
        if W is None:
            W = self.W
        if dtype is not None:
            W = W.astype(dtype)
        sten = []
        for bi in self._stencil_ids:
            b = op.batches[bi]
            if dtype is not None:
                b = dataclasses.replace(
                    b,
                    matrices=jnp.asarray(b.matrices, dtype),
                    masks=None if b.masks is None else jnp.asarray(b.masks, dtype),
                )
            sten.append(b)
        taps, off = self.taps, self.tap_offsets
        shapes, chans = self.blk_shapes, self.blk_ch

        groups: Dict[Tuple[int, int], List[int]] = {}
        for t, (bi, bj, dr, dc) in enumerate(taps):
            groups.setdefault((bi, bj), []).append(t)
        noff = 2 * P + 1
        pair_list = sorted(groups)
        dense_total = sum(
            noff * noff * shapes[bi][0] * shapes[bi][1] * chans[bi] * chans[bj]
            for bi, bj in pair_list
        )
        dense_max = int(
            float(_os.environ.get("PHIFEM_TAPS_DENSE_MAX", "1.2e8"))
        )
        use_dense = dense_total <= dense_max
        if use_dense:
            # dense per-pair layout (Ri, Ci, vi, noff^2 * vj): the offset
            # axis is FOLDED INTO THE CONTRACTION so the application is
            # the same per-position small matmul einsum as the per-tap
            # loop ("rcik,rck->rci") rather than a 5-D (t, r, c, i, j)
            # batched form, whose compile ran out of memory on the S5
            # operator
            nW = int(off[-1])
            noff2 = noff * noff
            perm = np.full(dense_total, nW, np.int64)
            dense_off: Dict[Tuple[int, int], int] = {}
            cur = 0
            for pair in pair_list:
                bi, bj = pair
                Ri, Ci = shapes[bi]
                vi, vj = chans[bi], chans[bj]
                dense_off[pair] = cur
                r = np.arange(Ri)[:, None, None, None]
                c = np.arange(Ci)[None, :, None, None]
                ki = np.arange(vi)[None, None, :, None]
                kj = np.arange(vj)[None, None, None, :]
                rcki = ((r * Ci + c) * vi + ki)
                for t in groups[pair]:
                    _, _, dr, dc = taps[t]
                    slot = (dr + P) * noff + (dc + P)
                    dense_idx = (rcki * noff2 + slot) * vj + kj
                    w_idx = off[t] + rcki * vj + kj
                    perm[cur + dense_idx.reshape(-1)] = w_idx.reshape(-1)
                cur += noff2 * Ri * Ci * vi * vj
            perm_j = jnp.asarray(
                perm, jnp.int32 if nW < 2**31 else jnp.int64
            )
            offsets = [
                (dr, dc)
                for dr in range(-P, P + 1)
                for dc in range(-P, P + 1)
            ]

        def matvec(x: Dict[str, Array]) -> Dict[str, Array]:
            if dtype is not None:
                x = {k: v.astype(dtype) for k, v in x.items()}
            blocks = self._decompose(x)
            padded: List[Optional[Array]] = [None] * len(blocks)
            y: List[Optional[Array]] = [None] * len(blocks)
            if use_dense:
                Wd = jnp.concatenate([W, jnp.zeros(1, W.dtype)])[perm_j]
                # one extra pad ring vs the per-tap loop: the dense form
                # slices ALL (2P+1)^2 offsets for every (source, target-
                # shape) combination, including offsets no tap uses, and
                # a P1 target lattice is one row/col larger than a DG0
                # source — without the ring those slices would clamp
                # short (absent-offset weights are zero, so the ring's
                # content never contributes)
                P2 = P + 1
                xs_cache: Dict[Tuple[int, int, int], Array] = {}
                for pair in pair_list:
                    bi, bj = pair
                    Ri, Ci = shapes[bi]
                    vi, vj = chans[bi], chans[bj]
                    key = (bj, Ri, Ci)
                    if padded[bj] is None:
                        padded[bj] = jnp.pad(
                            blocks[bj], ((P2, P2), (P2, P2), (0, 0))
                        )
                    # xs: (Ri, Ci, noff^2 * vj) — offsets stacked into
                    # the contraction axis (see perm layout note above)
                    if key not in xs_cache:
                        xs_cache[key] = jnp.stack(
                            [
                                padded[bj][
                                    P2 + dr : P2 + dr + Ri,
                                    P2 + dc : P2 + dc + Ci,
                                    :,
                                ]
                                for dr, dc in offsets
                            ],
                            axis=2,
                        ).reshape(Ri, Ci, noff * noff * vj)
                    o0 = dense_off[pair]
                    Wp = Wd[
                        o0 : o0 + noff * noff * Ri * Ci * vi * vj
                    ].reshape(Ri, Ci, vi, noff * noff * vj)
                    part = jnp.einsum(
                        "rcik,rck->rci", Wp, xs_cache[key], precision=HIGHEST
                    )
                    y[bi] = part if y[bi] is None else y[bi] + part
            else:
                for t, (bi, bj, dr, dc) in enumerate(taps):
                    Ri, Ci = shapes[bi]
                    vi, vj = chans[bi], chans[bj]
                    if padded[bj] is None:
                        padded[bj] = jnp.pad(
                            blocks[bj], ((P, P), (P, P), (0, 0))
                        )
                    xs = padded[bj][
                        P + dr : P + dr + Ri, P + dc : P + dc + Ci, :
                    ]
                    w = W[off[t] : off[t + 1]].reshape(Ri, Ci, vi, vj)
                    if vi == 1 and vj == 1:
                        part = w[:, :, 0, :] * xs
                    else:
                        part = jnp.einsum(
                            "rcij,rcj->rci", w, xs, precision=HIGHEST
                        )
                    y[bi] = part if y[bi] is None else y[bi] + part
            for i in range(len(y)):
                if y[i] is None:
                    y[i] = jnp.zeros(shapes[i] + (chans[i],), W.dtype)
            out = self._recompose(y)
            for b in sten:
                out = b.matvec_into(x, out)
            return out

        matvec.dense_form = use_dense
        return matvec

    # ------------------------------------------------------------ refresh
    def refresh(self, op) -> "TapOperator":
        """Re-scatter the data-dependent batches' current element matrices
        into the weight buffer (one jitted program)."""
        if not self._dyn:
            self.data_version = op.data_version
            return self
        runner = getattr(self, "_refresh_jit", None)
        if runner is None:
            idxs = [jnp.asarray(ids) for _, ids in self._dyn]

            @jax.jit
            def runner(w_static, mats_list):
                W = w_static
                for ids, m in zip(idxs, mats_list):
                    W = W.at[ids].add(m.reshape(-1).astype(W.dtype))
                return W

            self._refresh_jit = runner
        mats = [op.batches[bi].matrices for bi, _ in self._dyn]
        self.W = runner(self._w_static, mats)
        self.data_version = op.data_version
        return self


# --------------------------------------------------------------- builder
def _batch_entity_matrices_np(b) -> Optional[np.ndarray]:
    """Static per-entity matrices of a batch, or None if data-dependent."""
    if getattr(b, "rebuild", None) is not None:
        return None
    mats = np.asarray(b.matrices)
    if b.orient is not None:
        mats = mats[np.asarray(b.orient)]
    else:
        ne = b.segments[0][1].shape[0]
        mats = np.broadcast_to(mats, (ne,) + mats.shape[-2:])
    return mats


def _batch_local_meta(b, specs_by_name, grid: Grid):
    """Per (entity, local scalar column) in gather() order:
    block-lattice id, row, col, channel."""
    bl_cols, r_cols, c_cols, ch_cols = [], [], [], []
    for name, dofs, vs in b.segments:
        sp = specs_by_name[name]
        d = np.asarray(dofs)
        ls, r, c = _scalar_positions(sp, grid, d)  # (ne, nloc) each
        for li in range(d.shape[1]):
            for k in range(sp.vsz):
                bl_cols.append(sp.base + ls[:, li])
                r_cols.append(r[:, li])
                c_cols.append(c[:, li])
                ch_cols.append(np.full(d.shape[0], k, np.int64))
    return (
        np.stack(bl_cols, axis=1).astype(np.int64),
        np.stack(r_cols, axis=1).astype(np.int64),
        np.stack(c_cols, axis=1).astype(np.int64),
        np.stack(ch_cols, axis=1),
    )  # (ne, L) each


def build_tap_operator(op) -> Optional[TapOperator]:
    """Build the block-tap form of ``op``, or None when a field layout is
    unsupported (degree >= 2 Lagrange) or no batch benefits (pure-stencil
    operators keep their O(1)-weight path).  The structure (tap set,
    scatter ids) depends only on entity lists, so it survives
    ``reassemble``; :meth:`TapOperator.refresh` updates the values.
    """
    from ..ops.stencil import StencilCellBatch

    system = op.system
    if not supports_tap_form(system):
        return None
    grid_list = [s.grid for s in system.fields.values()]
    grid = grid_list[0]
    if any(g is not grid for g in grid_list):
        return None

    stencil_ids = [
        bi for bi, b in enumerate(op.batches) if isinstance(b, StencilCellBatch)
    ]
    generic_ids = [
        bi for bi, b in enumerate(op.batches) if not isinstance(b, StencilCellBatch)
    ]
    if not generic_ids:
        return None  # pure uniform-stencil operator: nothing to gain

    specs = _field_specs(system, grid)
    specs_by_name = {sp.name: sp for sp in specs}
    blk_shapes: List[Tuple[int, int]] = []
    blk_ch: List[int] = []
    for sp in specs:
        blk_shapes.extend([sp.shape] * sp.nblocks)
        blk_ch.extend([sp.vsz] * sp.nblocks)

    # pass 1 (host): per batch, per local scalar pair -> tap keys; prune
    # pairs statically zero (static batches only — dynamic values change)
    key_to_tap: Dict[Tuple[int, int, int, int], int] = {}

    def tap_of(keys_2d: np.ndarray) -> np.ndarray:
        uniq, inv = np.unique(keys_2d, axis=0, return_inverse=True)
        lut = np.empty(len(uniq), np.int64)
        for u, row in enumerate(uniq):
            key = (int(row[0]), int(row[1]), int(row[2]), int(row[3]))
            if key not in key_to_tap:
                key_to_tap[key] = len(key_to_tap)
            lut[u] = key_to_tap[key]
        return lut[inv]

    per_batch = []  # (bi, [(i, j, tids)], r, c, ch, static_mats|None)
    for bi in generic_ids:
        b = op.batches[bi]
        bl, r, c, ch = _batch_local_meta(b, specs_by_name, grid)
        ne, L = bl.shape
        mats = _batch_entity_matrices_np(b)
        pairs = []
        for i in range(L):
            for j in range(L):
                if mats is not None and not np.abs(mats[:, i, j]).max() > 0.0:
                    continue  # structurally zero coupling
                keys = np.stack(
                    [bl[:, i], bl[:, j], r[:, j] - r[:, i], c[:, j] - c[:, i]],
                    axis=1,
                )
                pairs.append((i, j, tap_of(keys)))
        per_batch.append((bi, pairs, r, c, ch, mats))

    taps: List[Tuple[int, int, int, int]] = [None] * len(key_to_tap)
    for key, t in key_to_tap.items():
        taps[t] = key
    pad = 2
    for _, _, dr, dc in taps:
        pad = max(pad, abs(dr), abs(dc))

    sizes = np.asarray(
        [
            blk_shapes[bi][0] * blk_shapes[bi][1] * blk_ch[bi] * blk_ch[bj]
            for bi, bj, _, _ in taps
        ],
        np.int64,
    )
    tap_offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    total = int(tap_offsets[-1])
    # per-tap index helpers (indexed by tap id)
    t_C = np.asarray([blk_shapes[t[0]][1] for t in taps], np.int64)
    t_vi = np.asarray([blk_ch[t[0]] for t in taps], np.int64)
    t_vj = np.asarray([blk_ch[t[1]] for t in taps], np.int64)

    def flat_idx(tids, ri, ci, ki, kj):
        # layout per tap: (r, c, ki, kj) row-major
        return tap_offsets[tids] + (
            ((ri * t_C[tids] + ci) * t_vi[tids] + ki) * t_vj[tids] + kj
        )

    # pass 2: flat scatter indices; static values -> w_static, dynamic ->
    # per-batch index arrays for the jitted refresh
    w_static = np.zeros(total, np.float64)
    dyn: List[Tuple[int, np.ndarray]] = []
    for bi, pairs, r, c, ch, mats in per_batch:
        ne, L = r.shape
        if mats is None:
            # dynamic: scatter the FULL (ne, L, L) matrix each refresh
            flat = np.empty((ne, L, L), np.int64)
            pair_t = {(i, j): t for i, j, t in pairs}
            for i in range(L):
                for j in range(L):
                    tids = pair_t[(i, j)]
                    flat[:, i, j] = flat_idx(
                        tids, r[:, i], c[:, i], ch[:, i], ch[:, j]
                    )
            dyn.append((bi, flat.reshape(-1)))
        else:
            for i, j, tids in pairs:
                idx = flat_idx(tids, r[:, i], c[:, i], ch[:, i], ch[:, j])
                np.add.at(w_static, idx, mats[:, i, j])

    top = TapOperator(
        grid=grid,
        specs=specs,
        taps=[tuple(t) for t in taps],
        tap_offsets=tap_offsets,
        blk_shapes=blk_shapes,
        blk_ch=blk_ch,
        pad=int(pad),
        W=jnp.asarray(w_static),
        _w_static=jnp.asarray(w_static),
        _dyn=dyn,
        _stencil_ids=stencil_ids,
        data_version=-1,
    )
    return top.refresh(op)
