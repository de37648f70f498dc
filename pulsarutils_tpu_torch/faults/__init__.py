"""Fault injection and failure policy for the chunk loop.

* :mod:`.inject` — a seeded :class:`~.inject.FaultPlan` that injects
  failures at the loop's seams (reads, data corruption, device dispatch,
  the host fallback, persist writes), armed by context manager, by
  :func:`~.inject.arm` or by the ``PUTPU_FAULT_PLAN`` environment
  variable; with no plan armed every hook is one ``None`` check;
* :mod:`.policy` — deadline-bounded dispatch, the integrity gate and the
  quarantine manifest;
* :mod:`.audit` — the end-of-run check of ledger, candidate files and
  manifest against each other;
* :mod:`.reasons` — the manifest's reason vocabulary.

The JAX package's ``faults`` package, on tensors where the port's loop
holds tensors.
"""

from .audit import audit_run
from .inject import FaultPlan, FaultSpec, active, arm, disarm
from .policy import (DispatchPolicy, DispatchTimeoutError, IntegrityPolicy,
                     QuarantineManifest, call_with_deadline, gate_chunk,
                     gate_frames, gate_tensor, join_abandoned,
                     resolve_integrity_policy)

__all__ = [
    "DispatchPolicy",
    "DispatchTimeoutError",
    "FaultPlan",
    "FaultSpec",
    "IntegrityPolicy",
    "QuarantineManifest",
    "active",
    "arm",
    "audit_run",
    "call_with_deadline",
    "disarm",
    "gate_chunk",
    "gate_frames",
    "gate_tensor",
    "join_abandoned",
    "resolve_integrity_policy",
]
