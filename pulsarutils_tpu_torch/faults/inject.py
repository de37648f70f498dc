"""Seeded, composable fault injection for the chunk loop.

A :class:`FaultPlan` is a list of :class:`FaultSpec` records, each naming
a **site** (the seam it fires at), a failure **kind**, the chunk starts it
applies to and a firing budget (``times``).  The instrumented code calls
the module-level hooks (:func:`fire`, :func:`corrupt`,
:func:`truncated_length`, :func:`wire_action`, :func:`ingest_action`);
with no plan armed every hook is one module-global ``None`` check and
the production path is unchanged.

============ ========================================= =====================
site         seam                                      kinds
============ ========================================= =====================
``read``     ``FilterbankReader.read_block`` and        ``error``,
             ``read_frames_into`` (the loop's reads)   ``truncate``
``corrupt``  the reader thread, after the read         ``nan``, ``inf``,
                                                       ``dead_channels``,
                                                       ``zero_run``,
                                                       ``saturate``,
                                                       ``impulse``
``dispatch`` the per-chunk device search               ``error``, ``hang``,
                                                       ``oom``
``mesh``     the sharded route inside the dispatch     ``error``, ``hang``,
             (and the mesh hybrid's fused round)       ``oom``
``beams``    ``BeamBatcher.search``, before the        ``error``, ``oom``
             batched dispatch (``chunk=None``)
``host``     the host (CPU) fallback rung of the       ``oom``
             chunk search
``persist``  ``CandidateStore.save_candidate``         ``error``
``fleet``    ``FleetWorker._run_unit``, before a        ``error``, ``hang``
             leased unit's search (``chunk`` = its
             first chunk)
``period``   the periodicity job's trial sweep, on     ``error``, ``hang``,
             its device; a raise propagates (no host   ``oom``
             path in the port)
``wire``     the fleet's wire client                   ``drop``, ``delay``,
             (``protocol.post_json_retry``), per       ``duplicate``
             message: ``drop`` raises a transport
             error before sending, ``delay`` sleeps
             ``seconds`` first, ``duplicate`` sends it
             twice; ``msg`` restricts a spec to one
             message (``register``, ``lease``,
             ``complete``, ``release``)
``ingest``   the live feed's send path, per packet     ``drop``, ``reorder``,
             (``chunks`` selects packet ``seq``s)      ``duplicate``,
                                                       ``corrupt``,
                                                       ``disconnect``,
                                                       ``burst``
============ ========================================= =====================

``kind="oom"`` raises a real ``torch.OutOfMemoryError`` (the type the
CUDA caching allocator throws) at a device site and ``MemoryError`` at
``host``, so the resilience ladder's classifier
(:func:`~..resilience.ladder.is_resource_exhausted`) is exercised on the
failure production raises.

Arming: ``with plan.armed(): ...``, :func:`arm`, or the
``PUTPU_FAULT_PLAN`` environment variable holding the plan's JSON (read
once, at the first hook call), so a CLI run can be drilled unchanged.
Every firing is counted per spec and mirrored into
``putpu_faults_injected_total{site=...}``.

Corruption is deterministic: the rng is seeded from ``(spec.seed,
chunk)``, so the same plan over the same block corrupts the same values
as the JAX package's hook does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time

import numpy as np
import torch

from ..obs import metrics as _metrics

#: the process-wide armed plan (None = injection off)
_ACTIVE = None
_ENV_CHECKED = False
#: suppression depth: hooks no-op while > 0 (see :func:`suppressed`)
_SUPPRESS = 0

#: exception classes a spec may raise by name
_EXC_TYPES = {
    "OSError": OSError,
    "IOError": OSError,
    "RuntimeError": RuntimeError,
    "MemoryError": MemoryError,
}

#: default exception class per site when the spec names none
_SITE_DEFAULT_EXC = {"read": "OSError", "persist": "OSError"}

CORRUPT_KINDS = ("nan", "inf", "dead_channels", "zero_run", "saturate",
                 "impulse")

#: partition-chaos kinds of the ``wire`` site
_WIRE_KINDS = ("drop", "delay", "duplicate")

#: feed-chaos kinds of the ``ingest`` site, applied per packet by
#: :func:`~..ingest.source.feed_packets` (the ``chunks`` selector
#: matches the packet ``seq``)
_INGEST_KINDS = ("drop", "reorder", "duplicate", "corrupt",
                 "disconnect", "burst")


def _resource_exhausted_exc(site, chunk):
    """An injected OOM shaped like production's: ``torch.OutOfMemoryError``
    at a device site, ``MemoryError`` at ``host`` (the ladder floor)."""
    tag = f"(FAULTPLAN: injected {site} oom, chunk={chunk})"
    if site == "host":
        return MemoryError(f"host out of memory allocating 16.00 GiB {tag}")
    return torch.OutOfMemoryError(
        f"CUDA out of memory. Tried to allocate 16.00 GiB. {tag}")


@dataclasses.dataclass
class FaultSpec:
    """One injectable failure.  ``chunks=None`` matches every chunk;
    ``times=None`` never exhausts (a persistent fault), ``times=1`` is a
    transient."""

    site: str
    kind: str = "error"
    chunks: tuple | None = None     # chunk istarts; None = all
    times: int | None = 1           # firing budget; None = unlimited
    frac: float = 0.01              # corruption fraction
    seconds: float = 60.0           # hang duration
    seed: int = 0                   # corruption rng seed (mixed w/ chunk)
    exc: str | None = None          # exception class name for kind=error
    amp: float = 20.0               # impulse amplitude, in block stds
    msg: str | None = None          # wire-message selector; None = all
    fired: int = dataclasses.field(default=0, init=False)

    def matches(self, site, chunk):
        if site != self.site:
            return False
        if self.chunks is not None and chunk is not None \
                and int(chunk) not in {int(c) for c in self.chunks}:
            return False
        return True

    def to_json(self):
        d = {"site": self.site, "kind": self.kind, "times": self.times,
             "frac": self.frac, "seconds": self.seconds, "seed": self.seed}
        if self.chunks is not None:
            d["chunks"] = [int(c) for c in self.chunks]
        if self.exc is not None:
            d["exc"] = self.exc
        if self.amp != 20.0:
            d["amp"] = self.amp
        if self.msg is not None:
            d["msg"] = self.msg
        return d


class FaultPlan:
    """A set of :class:`FaultSpec` with thread-safe firing budgets (hooks
    fire from the reader thread, the persist worker and the main loop)."""

    def __init__(self, specs=()):
        self.specs = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                      for s in specs]
        self._lock = threading.Lock()

    def _claim(self, spec):
        """Atomically consume one firing from ``spec``'s budget."""
        with self._lock:
            if spec.times is not None and spec.fired >= spec.times:
                return False
            spec.fired += 1
        _metrics.counter("putpu_faults_injected_total",
                         site=spec.site).inc()
        return True

    def fired(self, site=None):
        """Total firings, optionally restricted to one site."""
        with self._lock:
            return sum(s.fired for s in self.specs
                       if site is None or s.site == site)

    def fire(self, site, chunk=None, **ctx):
        """Raise or hang for matching ``error``/``hang``/``oom`` specs."""
        for spec in self.specs:
            if spec.kind not in ("error", "hang", "oom") \
                    or not spec.matches(site, chunk):
                continue
            if not self._claim(spec):
                continue
            if spec.kind == "hang":
                time.sleep(spec.seconds)
                continue
            if spec.kind == "oom":
                raise _resource_exhausted_exc(site, chunk)
            exc_name = spec.exc or _SITE_DEFAULT_EXC.get(site,
                                                         "RuntimeError")
            exc_cls = _EXC_TYPES.get(exc_name, RuntimeError)
            raise exc_cls(f"FAULTPLAN: injected {site} {spec.kind} "
                          f"(chunk={chunk})")

    def wire_action(self, site, msg=None):
        """First matching wire-chaos action, ``(kind, seconds)``, or
        ``None``; a spec's ``msg`` restricts it to one message name."""
        for spec in self.specs:
            if spec.kind not in _WIRE_KINDS or spec.site != site:
                continue
            if spec.msg is not None and msg is not None \
                    and spec.msg != msg:
                continue
            if not self._claim(spec):
                continue
            return spec.kind, spec.seconds
        return None

    def ingest_action(self, site, seq=None):
        """First matching feed-chaos action for one packet, ``(kind,
        seconds, frac)``, or ``None``; the spec's ``chunks`` selector
        matches the packet ``seq``."""
        for spec in self.specs:
            if spec.kind not in _INGEST_KINDS or spec.site != site:
                continue
            if not spec.matches(site, seq):
                continue
            if not self._claim(spec):
                continue
            return spec.kind, spec.seconds, spec.frac
        return None

    def truncated_length(self, site, chunk, n):
        """Shortened read length for matching ``truncate`` specs."""
        for spec in self.specs:
            if spec.kind == "truncate" and spec.matches(site, chunk) \
                    and self._claim(spec):
                n = max(int(n * (1.0 - spec.frac)), 1)
        return n

    def wants_corrupt(self, site, chunk):
        """True when a corrupt-kind spec matches and has budget left: the
        reader then reads that chunk as a host float block."""
        with self._lock:
            return any(spec.kind in CORRUPT_KINDS
                       and spec.matches(site, chunk)
                       and (spec.times is None or spec.fired < spec.times)
                       for spec in self.specs)

    def corrupt(self, site, block, chunk=None):
        """Apply matching corruption kinds to a copy of ``block`` (a host
        array; floating dtypes are kept, integers become float32)."""
        out = None
        for spec in self.specs:
            if spec.kind not in CORRUPT_KINDS \
                    or not spec.matches(site, chunk):
                continue
            if not self._claim(spec):
                continue
            if out is None:
                src = np.asarray(block)
                dtype = (src.dtype if np.issubdtype(src.dtype, np.floating)
                         else np.float32)
                out = np.array(src, dtype=dtype, copy=True)
            rng = np.random.default_rng(
                (int(spec.seed), 0 if chunk is None else int(chunk)))
            nchan, nsamp = out.shape
            if spec.kind in ("nan", "inf"):
                k = max(int(out.size * spec.frac), 1)
                idx = rng.choice(out.size, size=k, replace=False)
                # .flat: a transposed block's ravel() would be a copy
                out.flat[idx] = np.nan if spec.kind == "nan" else np.inf
            elif spec.kind == "dead_channels":
                k = max(int(nchan * spec.frac), 1)
                out[rng.choice(nchan, size=k, replace=False)] = 0.0
            elif spec.kind == "impulse":
                # broadband RFI: bright un-dispersed impulses in every
                # channel at a few time bins
                k = max(int(nsamp * spec.frac), 1)
                ts = rng.choice(nsamp, size=k, replace=False)
                scale = float(np.nanstd(
                    np.where(np.isinf(out), np.nan, out)))
                if not np.isfinite(scale) or scale == 0.0:
                    scale = 1.0
                out[:, ts] += spec.amp * scale
            elif spec.kind == "zero_run":
                # dropped packets: a contiguous run of zeroed frames
                k = max(int(nsamp * spec.frac), 1)
                lo = int(rng.integers(0, max(nsamp - k, 1)))
                out[:, lo:lo + k] = 0.0
            elif spec.kind == "saturate":
                # clipped digitiser: everything above the (1 - frac)
                # quantile collapses onto one rail value (nan-aware, so
                # it composes after a nan/inf spec)
                v = np.nanquantile(np.where(np.isinf(out), np.nan, out),
                                   1.0 - spec.frac)
                if np.isfinite(v):
                    out[out >= v] = float(v)
        return block if out is None else out

    @contextlib.contextmanager
    def armed(self):
        """Arm this plan process-wide for the block (the previously armed
        plan is restored on exit)."""
        global _ACTIVE
        prev = _ACTIVE
        _ACTIVE = self
        try:
            yield self
        finally:
            _ACTIVE = prev

    def to_json(self):
        return json.dumps({"specs": [s.to_json() for s in self.specs]})

    @classmethod
    def from_json(cls, blob):
        data = json.loads(blob) if isinstance(blob, str) else blob
        specs = data["specs"] if isinstance(data, dict) else data
        out = []
        for d in specs:
            d = dict(d)
            if d.get("chunks") is not None:
                d["chunks"] = tuple(d["chunks"])
            out.append(FaultSpec(**d))
        return cls(out)


@contextlib.contextmanager
def suppressed():
    """Disable every hook inside the block: for code that shares a seam
    but is not the chunk loop under test (the bad-channel pre-scan reads
    the whole file through ``read_block`` before the loop starts)."""
    global _SUPPRESS
    _SUPPRESS += 1
    try:
        yield
    finally:
        _SUPPRESS -= 1


def arm(plan):
    """Arm ``plan`` process-wide (prefer ``plan.armed()`` in tests)."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def disarm():
    global _ACTIVE
    _ACTIVE = None


def active():
    """The armed plan, or None.  The first call reads
    ``PUTPU_FAULT_PLAN`` (the plan's JSON) once; to arm a plan later in
    the process use :func:`arm` or ``plan.armed()``."""
    global _ACTIVE, _ENV_CHECKED
    if _ACTIVE is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        blob = os.environ.get("PUTPU_FAULT_PLAN")
        if blob:
            _ACTIVE = FaultPlan.from_json(blob)
    return _ACTIVE


def _plan():
    plan = _ACTIVE if _ACTIVE is not None or _ENV_CHECKED else active()
    return None if _SUPPRESS else plan


def fire(site, chunk=None, **ctx):
    plan = _plan()
    if plan is not None:
        plan.fire(site, chunk=chunk, **ctx)


def corrupt(site, block, chunk=None):
    plan = _plan()
    return block if plan is None else plan.corrupt(site, block, chunk=chunk)


def wants_corrupt(site, chunk):
    plan = _plan()
    return plan is not None and plan.wants_corrupt(site, chunk)


def truncated_length(site, chunk, n):
    plan = _plan()
    return n if plan is None else plan.truncated_length(site, chunk, n)


def wire_action(site, msg=None):
    plan = _plan()
    return None if plan is None else plan.wire_action(site, msg=msg)


def ingest_action(site, seq=None):
    plan = _plan()
    return None if plan is None else plan.ingest_action(site, seq=seq)
