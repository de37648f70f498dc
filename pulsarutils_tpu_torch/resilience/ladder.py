"""The OOM degradation ladder: classify, count, descend, recover.

An out-of-memory error is not one of the transient dispatch faults the
chunk loop retries (the identical dispatch would run out identically).
The run descends a ladder of smaller re-dispatches instead, each giving
the undivided dispatch's table bit for bit:

=========== ================================================= ==========
step        mechanism                                          surface
=========== ================================================= ==========
split_dm    the direct sweep dedisperses its trials in         direct
            2, 4, ... times smaller superblocks (a trial       sweep,
            row is an independent sum over channels, scored    gather,
            on its own), down to one trial block a launch;     roll
            the gather and roll sweeps run their trial
            blocks in 2, 4, ... passes, each pass's scores
            read back before the next
unfuse      the hybrid's fused seed program (one chain of      hybrid
            launches, one readback) splits back into its
            coarse sweep and the host-driven rescore (the
            two-stage path); its best row, rebin, peak and
            hits are the fused run's
halve_batch an N-beam batch re-dispatches as two half-batches  beams
            (each beam runs the same per-beam body whatever
            the batch width, so every beam's table is the
            unsplit batch's bit for bit); a single beam has
            nothing to split and its error propagates
floor       nothing smaller is left: on ``device="cpu"`` the   chunk
            host path (``kernel="auto"``) is tried once; an    loop
            out-of-memory error there, or at the card's
            floor, quarantines the chunk as ``oom_floor``
=========== ================================================= ==========

The port never falls back from the card to the host.

State is one process-global level (device memory is a global resource),
reset at the start of each ``search_by_chunks`` session: within a run a
descent is sticky.  The preflight (:mod:`.memory_budget`) descends the
same ladder before a gather or roll sweep whose estimated footprint
does not fit the headroom.  Counters (the JAX package's names):
``putpu_oom_events_total`` (by surface), ``putpu_oom_ladder_steps_total``
(by step) and ``putpu_oom_splits_total`` (by stage).
"""

from __future__ import annotations

import threading

import torch

from ..obs import metrics as _metrics

__all__ = ["OOMFloorError", "is_resource_exhausted", "reset", "level",
           "descend", "direct_plan", "direct_maxed", "direct_step",
           "unfuse_engaged", "oom_event", "count_split", "STEPS"]

#: the rungs of the table above, in descent order
STEPS = ("split_dm", "unfuse", "halve_batch", "floor")

#: message markers of an allocator failure: the XLA status text the JAX
#: package matches, and the CUDA caching allocator's
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Resource exhausted",
                "Out of memory", "out of memory")

_lock = threading.Lock()
_LEVEL = 0


class OOMFloorError(RuntimeError):
    """The ladder's floor itself ran out of memory: the chunk cannot be
    searched on this device at any geometry, and the chunk loop
    quarantines it as ``oom_floor``."""


def is_resource_exhausted(exc):
    """True when ``exc`` is device or host memory exhaustion:
    ``torch.OutOfMemoryError`` (the CUDA caching allocator's) and
    ``MemoryError`` always, another exception by the markers in its
    message, a ``ValueError``/``TypeError`` never (a configuration
    error)."""
    if isinstance(exc, (MemoryError, torch.OutOfMemoryError)):
        return True
    if isinstance(exc, (ValueError, TypeError)):
        return False
    msg = str(exc)
    return any(m in msg for m in _OOM_MARKERS)


def reset():
    """Back to the undegraded level (session start; tests)."""
    global _LEVEL
    with _lock:
        _LEVEL = 0


def level():
    """The current degradation level (0 = undegraded)."""
    return _LEVEL


def descend(step):
    """One descent: bump the level, count the step.  Returns the new
    level."""
    global _LEVEL
    with _lock:
        _LEVEL += 1
        new = _LEVEL
    _metrics.counter("putpu_oom_ladder_steps_total", step=step).inc()
    return new


def oom_event(surface, headroom=None):
    """Count one caught out-of-memory error on ``surface``; record the
    headroom at failure (``headroom=None``: the memory budget's
    :func:`~.memory_budget.headroom_bytes`, no gauge when unknown)."""
    _metrics.counter("putpu_oom_events_total", surface=surface).inc()
    if headroom is None:
        from . import memory_budget as _mb

        headroom = _mb.headroom_bytes()
    if headroom is not None:
        _metrics.gauge("putpu_oom_headroom_at_failure_bytes").set(
            int(headroom))


def count_split(stage, n=1):
    """Count ``n`` splitting decisions (``stage``: ``preflight``, planned
    by :mod:`.memory_budget` before the sweep, or ``ladder``, after a
    caught OOM)."""
    if n > 0:
        _metrics.counter("putpu_oom_splits_total", stage=stage).inc(int(n))


def direct_plan(formulation, nblocks=None):
    """Passes a direct sweep's ``nblocks`` trial blocks are split into at
    the current level: 1 at level 0, doubling with each descent, at most
    one block a pass.  ``formulation`` is the sweep's (``"pallas"``, the
    direct sweep's superblocks; ``"gather"``, ``"roll"``), as in the JAX
    package; each splits the same way.  ``direct_plan(nblocks)`` is the
    direct sweep's."""
    if nblocks is None:
        nblocks = formulation
    lvl = _LEVEL
    if lvl <= 0:
        return 1
    return min(2 ** lvl, max(int(nblocks), 1))


def direct_maxed(formulation, nblocks=None):
    """True when the sweep has no smaller dispatch left
    (:func:`direct_plan`'s arguments)."""
    if nblocks is None:
        nblocks = formulation
    return direct_plan(formulation, nblocks) >= max(int(nblocks), 1)


def direct_step(formulation):
    """The step name the next descent of a ``formulation`` sweep takes."""
    del formulation
    return "split_dm"


def unfuse_engaged():
    """True once any descent happened: the hybrid drops its fused seed
    program for the two-stage path."""
    return _LEVEL >= 1
