"""Integration entity lists: one-sided boundary measures and facet sets.

Replaces the reference's ``_compute_integration_entities``
(``src/phifem/mesh_scripts.py:137-192``), which builds dolfinx
``(cell, local_facet)`` pair lists so a ``ds`` measure integrates each facet
from a chosen side (subdomain ids 100 = Gamma_h seen from inside Omega_h and
101 = seen from outside, ``mesh_scripts.py:617-633``).

Here a one-sided facet set is a static struct-of-arrays: facet ids, the
chosen side's cell ids, the local facet index within that cell, and the sign
applied to the facet's base normal to make it *outward* for the chosen cell.
These arrays are frozen per mesh+levelset (preprocessing), so the assembly
kernels that consume them are static-shape jitted gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .grid import Grid

Array = jnp.ndarray

__all__ = [
    "FacetSideList",
    "BoundaryMeasure",
    "one_sided_facets",
    "one_sided_facets_multi",
]


@dataclasses.dataclass(frozen=True)
class FacetSideList:
    """A set of facets each integrated from one chosen adjacent cell."""

    grid: Grid
    facets: Array  # (n,) int32 facet ids
    cells: Array  # (n,) int32 chosen-side cell ids
    local_facets: Array  # (n,) int32 local index of facet within cell
    signs: Array  # (n,) float: +1 if chosen cell is the minus side

    @property
    def num_facets(self) -> int:
        return int(self.facets.shape[0])

    @property
    def normals(self) -> Array:
        """(n, 2) outward unit normals w.r.t. the chosen cells (replaces
        ``ufl.FacetNormal`` restricted to the one-sided measure)."""
        return self.grid.facet_base_normals[self.facets] * self.signs[:, None]

    @property
    def lengths(self) -> Array:
        return self.grid.facet_lengths[self.facets]

    def integration_entities(self) -> np.ndarray:
        """dolfinx-style raveled ``[c0, f0, c0, f1, c1, f0, ...]`` pairs
        (reference ``mesh_scripts.py:186-192``) — for parity checks."""
        return np.ravel(
            np.column_stack(
                [np.asarray(self.cells), np.asarray(self.local_facets)]
            )
        ).astype(np.int32)


def _one_sided_facets_host(
    grid: Grid, facet_ids: np.ndarray, cell_tags: np.ndarray, side_tags: tuple
) -> tuple:
    """Host half of :func:`one_sided_facets`: select the side cells and
    return the four numpy arrays (cells, facets, local_facets, signs)
    ready for a (possibly batched) device upload."""
    facet_ids = np.asarray(facet_ids, np.int32)
    f2c = grid.f2c_np[facet_ids]  # (n, 2)
    tags = np.asarray(cell_tags)
    t0 = np.where(f2c[:, 0] >= 0, tags[np.maximum(f2c[:, 0], 0)], -1)
    t1 = np.where(f2c[:, 1] >= 0, tags[np.maximum(f2c[:, 1], 0)], -1)
    in0 = np.isin(t0, side_tags) & (f2c[:, 0] >= 0)
    in1 = np.isin(t1, side_tags) & (f2c[:, 1] >= 0)
    # exactly one side should qualify; prefer slot 0 like the reference's
    # first-occurrence dedup (mesh_scripts.py:167-170)
    keep = in0 | in1
    facet_ids = facet_ids[keep]
    chosen = np.where(in0[keep], f2c[keep, 0], f2c[keep, 1])
    signs = np.where(in0[keep], 1.0, -1.0)
    local_np = grid.local_facet_index_np(chosen, facet_ids)
    return (
        chosen.astype(np.int32),
        facet_ids.astype(np.int32),
        local_np,
        signs,
    )


def one_sided_facets(
    grid: Grid, facet_ids: np.ndarray, cell_tags: np.ndarray, side_tags: tuple
) -> FacetSideList:
    """Build a :class:`FacetSideList` choosing, for each facet, the adjacent
    cell whose tag is in ``side_tags`` (reference ``mesh_scripts.py:156-165``:
    ``integration_cells`` selection via ``np.isin``)."""
    # ONE batched device_put instead of one upload per array
    cells, facets, local, signs_j = jax.device_put(
        _one_sided_facets_host(grid, facet_ids, cell_tags, side_tags)
    )
    return FacetSideList(grid, facets, cells, local, signs_j)


def one_sided_facets_multi(
    grid: Grid, specs: Dict[int, tuple], cell_tags: np.ndarray
) -> Dict[int, FacetSideList]:
    """Build several one-sided facet sets with a SINGLE batched device
    upload.  ``specs`` maps subdomain id -> (facet_ids, side_tags); the
    warm re-tag path uploads all measures' entity arrays in one call."""
    host = {
        ind: _one_sided_facets_host(grid, fids, cell_tags, side)
        for ind, (fids, side) in specs.items()
    }
    dev = jax.device_put(host)
    return {
        ind: FacetSideList(grid, facets, cells, local, signs)
        for ind, (cells, facets, local, signs) in dev.items()
    }


@dataclasses.dataclass(frozen=True)
class BoundaryMeasure:
    """Callable container mapping subdomain ids to one-sided facet sets —
    the analogue of the reference's ``ds`` measure with
    ``subdomain_data=integration_entities`` (``mesh_scripts.py:631-633``).

    ``build`` defers construction (host entity-list prep + the batched
    device upload) until
    a consumer actually asks for a facet set: a warm re-tag inside a
    convergence/assembly loop re-uses the operator's frozen facet lists
    and never touches the fresh measure, so the eager upload was pure
    round-trip cost on the hot path."""

    entries: Optional[Dict[int, FacetSideList]] = None
    build: Optional[Callable[[], Dict[int, FacetSideList]]] = None

    def _resolved(self) -> Dict[int, FacetSideList]:
        if self.entries is None:
            object.__setattr__(self, "entries", self.build())
        return self.entries

    def __call__(self, ind: int) -> FacetSideList:
        return self._resolved()[ind]

    def ids(self):
        return tuple(self._resolved().keys())
