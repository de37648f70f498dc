"""Measured kernel autotuning: per-(backend, geometry) variant selection.

The port of the JAX package's ``tuning`` package:

* :mod:`.geometry` — canonical geometry keys + the shared plan-cache
  policy (:data:`~.geometry.PLAN_CACHE_SIZE`, hit/miss-counted lru);
* :mod:`.cache` — the versioned persistent tune cache (torn/corrupt
  recovery, schema gate);
* :mod:`.autotune` — the tuner itself: measurement discipline,
  exact-hit-match equivalence gating, the static fallback ladder and
  the ``PUTPU_AUTOTUNE`` escape hatch.
"""

from .geometry import (  # noqa: F401
    PLAN_CACHE_SIZE,
    counted_plan_cache,
    geometry_key,
)

__all__ = ["PLAN_CACHE_SIZE", "counted_plan_cache", "geometry_key"]
