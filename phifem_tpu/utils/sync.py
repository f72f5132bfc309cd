"""Packed host synchronization for deferred device results.

Several pipeline stages return objects whose host-side payload is
deliberately left on device (`compute_tags_measures` tags, `solve(...,
sync=False)` stats): every ``jax.device_get`` is a host synchronization,
so a warm tag -> reassemble -> solve iteration that synchronized
stage-by-stage would stall the device between stages.  ``fetch_all`` gathers every
pending device value into ONE ``jax.device_get`` and hands each object its
slice back.

The protocol is duck-typed: an object participates by exposing
``_pending() -> pytree | None`` (device arrays still awaiting fetch, or
``None`` once materialized) and ``_absorb(host_values)``.  Participants:
:class:`phifem_tpu.tagging.TagsMeasures` and
:class:`phifem_tpu.solvers.SolveResult`.  (``EntityTags`` do not implement
the protocol themselves — they ride their owning ``TagsMeasures``: pass the
``TagsMeasures`` to ``fetch_all`` and both tag arrays materialize.)

The reference has no analogue — dolfinx/PETSc run host-side so every value
is already local; this is the device-side replacement for "assembly and KSP
results are just there" (reference ``demo/*/main.py`` solve sections).
"""

from __future__ import annotations

import jax

__all__ = ["fetch_all"]


def fetch_all(*objs) -> None:
    """Synchronize all pending device payloads of ``objs`` in one fetch.

    Objects already materialized (``_pending() is None``) are skipped;
    the rest are fetched together in a single ``jax.device_get`` round
    trip and populated in place.
    """
    pend = [o._pending() for o in objs]
    if all(p is None for p in pend):
        return
    vals = jax.device_get(pend)
    for o, p, v in zip(objs, pend, vals):
        if p is not None:
            o._absorb(v)
