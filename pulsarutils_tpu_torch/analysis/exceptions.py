"""Broad-exception checker (``broad-except``).

The containment design narrows every ``except Exception`` handler to the
exact failure set it means to contain (``(OSError, ValueError, KeyError,
BadZipFile)`` at resume-restore, OSError-only persist retries), because a
broad handler that swallows a ``TypeError`` turns a deterministic
configuration bug into silent data loss or a permanent silent fallback.
This checker makes the narrowing stick: bare ``except:``, ``except
Exception`` and ``except BaseException`` are findings unless the handler
sits in a declared containment seam.

The seam allowlist (:data:`CONTAINMENT_SEAMS`) names the places whose
*job* is to contain arbitrary failure, reviewed once and recorded here:

* observability must never take down a survey (HTTP scrape handlers,
  trace/profiler shutdown, report writers, the end-of-run audit);
* an out-of-memory error on the card (``torch.OutOfMemoryError``) and
  a CUDA runtime error share no narrower base class with the host's
  ``MemoryError``, so the OOM-ladder and dispatch retry seams catch
  Exception — each re-raises ``(ValueError, TypeError)`` and
  ``KernelBuildError`` first (deterministic errors), a convention this
  checker cannot fully prove but the seam list keeps auditable;
* capability probes (memory stats, the card's peaks) where any failure
  means "feature absent".

A handler outside the list needs an inline waiver with a reason — or,
usually better, a narrower tuple.
"""

from __future__ import annotations

import ast

from .core import register

#: (package-relative path, qualname prefix) pairs whose broad handlers
#: are the reviewed containment seams.  A qualname prefix of "" covers
#: the whole file (reserve for observability-only modules).
CONTAINMENT_SEAMS = {
    # -- observability must never take down a run --------------------------
    ("obs/server.py", "_Handler.do_GET"),
    ("obs/server.py", "_Handler.do_POST"),  # job API request containment
    ("obs/server.py", "ObsServer.progress_snapshot"),  # user progress_fn
    ("obs/trace.py", "trace_session"),
    ("obs/roofline.py", "_peaks"),          # card name probe
    ("obs/memory.py", "device_memory_snapshot"),
    # alert fan-out is observability-only: a dead webhook, a failing
    # lineage hook or a full disk must be counted, dead-lettered and
    # contained — never raised into the search loop
    ("obs/push.py", ""),
    # -- capability probes: failure == feature absent ----------------------
    ("utils/logging_utils.py", "measure_device_rtt"),
    # -- dispatch fallback/retry seams (a CPU run's sticky fallback; on
    # the card each re-raises) -------------------------------------------
    ("parallel/stream.py", "stream_search"),
    ("pipeline/search_pipeline.py", "_search_with_fallback"),
    ("pipeline/search_pipeline.py", "search_by_chunks"),
    ("faults/policy.py", "call_with_deadline"),  # watchdog-thread relay
    # OOM degradation-ladder catch sites: each classifies with
    # resilience.ladder.is_resource_exhausted and RE-RAISES everything
    # that is not an out-of-memory error (after the (ValueError,
    # TypeError, KernelBuildError) re-raise)
    ("ops/search.py", "_search_direct_laddered"),
    ("parallel/sharded_fdmt.py", "sharded_hybrid_search"),
    ("beams/batcher.py", "BeamBatcher.search"),
    # the direct sweep's memmap plane: released on ANY exit (a ladder
    # descent starts a new file), then re-raised
    ("ops/search.py", "_search_direct"),
    # one failed tenant batch marks its jobs FAILED; the service worker
    # thread must survive to run the next batch
    ("beams/service.py", "SurveyService._run_batch"),
    # one failed periodicity job likewise
    ("beams/service.py", "SurveyService._run_periodicity"),
    # a poisoned leased unit reports its error string and the
    # coordinator requeues (bounded by max_attempts); the fleet worker
    # must survive to lease the next unit
    ("fleet/worker.py", "FleetWorker._run_unit_inner"),
    # the time-series sampler's spill/hook and its background loop:
    # metric history is observability — a failed sample, JSONL spill or
    # SLO evaluation hook must log and move on, never kill a run
    ("obs/timeseries.py", "TimeSeriesSampler.sample"),
    ("obs/timeseries.py", "TimeSeriesSampler._loop"),
    # the driver's report writer shares search_by_chunks' never-fatal
    # observability rule
    ("periodicity/driver.py", "periodicity_search"),
    # the accel-backend resolution: a CPU run degrades to time_stretch
    # as in the JAX package, the card re-raises
    ("periodicity/driver.py", "_resolve_accel_backend"),
    # the tuner: a CPU measurement failure gives the static choice, the
    # card re-raises for the static candidate and drops any other
    ("tuning/autotune.py", "KernelTuner.resolve"),
    ("tuning/autotune.py", "KernelTuner._measure"),
    # -- CLI report amendment: observability never fails the run -----------
    ("cli/search_main.py", "main"),
}

_BROAD = {"Exception", "BaseException"}


def _broad_names(handler):
    """Broad exception names this handler catches (empty if narrow)."""
    if handler.type is None:
        return ["<bare>"]
    nodes = (handler.type.elts if isinstance(handler.type, ast.Tuple)
             else [handler.type])
    out = []
    for node in nodes:
        if isinstance(node, ast.Name) and node.id in _BROAD:
            out.append(node.id)
        elif isinstance(node, ast.Attribute) and node.attr in _BROAD:
            out.append(node.attr)
    return out


@register
class BroadExceptChecker:
    id = "broad-except"
    ids = ("broad-except",)

    def check(self, ctx):
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            broad = _broad_names(node)
            if not broad:
                continue
            qualname = ctx.qualname(node)
            if self._sanctioned(ctx.pkgpath, qualname):
                continue
            what = ("bare except:" if broad == ["<bare>"]
                    else f"except {'/'.join(broad)}")
            where = qualname or "<module>"
            out.append(ctx.finding(
                node, "broad-except",
                f"{what} in {where} outside the containment-seam "
                "allowlist — narrow it to the failures this site "
                "contains (deterministic ValueError/TypeError must "
                "propagate), or add the seam "
                "to CONTAINMENT_SEAMS / waive with a reason"))
        return out

    def _sanctioned(self, pkgpath, qualname):
        if pkgpath is None:
            return False
        for path, prefix in CONTAINMENT_SEAMS:
            if pkgpath != path:
                continue
            if prefix == "" or qualname == prefix \
                    or qualname.startswith(prefix + "."):
                return True
        return False
