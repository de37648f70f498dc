"""Resource-exhaustion resilience: the OOM degradation ladder
(:mod:`.ladder`).  The preflight memory budget is not ported yet."""

from .ladder import OOMFloorError, is_resource_exhausted  # noqa: F401

__all__ = ["OOMFloorError", "is_resource_exhausted"]
