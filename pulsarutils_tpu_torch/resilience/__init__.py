"""Resource-exhaustion resilience: the OOM degradation ladder
(:mod:`.ladder`) and the preflight memory budget
(:mod:`.memory_budget`), and the live feed's load shedding
(:mod:`.shedding`)."""

from .ladder import OOMFloorError, is_resource_exhausted  # noqa: F401
from .shedding import ShedPolicy, resolve_shed_policy  # noqa: F401

__all__ = ["OOMFloorError", "is_resource_exhausted", "ShedPolicy",
           "resolve_shed_policy"]
