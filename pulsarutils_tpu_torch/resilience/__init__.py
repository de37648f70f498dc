"""Resource-exhaustion resilience: the OOM degradation ladder
(:mod:`.ladder`) and the preflight memory budget
(:mod:`.memory_budget`)."""

from .ladder import OOMFloorError, is_resource_exhausted  # noqa: F401

__all__ = ["OOMFloorError", "is_resource_exhausted"]
