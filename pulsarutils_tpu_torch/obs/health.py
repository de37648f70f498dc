"""Rolling anomaly engine: per-chunk telemetry -> one health verdict.

The port's copy of the JAX package's engine (the same update sequence
gives the same verdicts, held equal by the tests).  :class:`HealthEngine`
consumes one update per chunk — wall seconds, candidate count, headroom,
retrace/retry/quarantine events, canary recall — and folds them through
EWMA baselines with hysteresis into a single ``OK`` / ``DEGRADED`` /
``CRITICAL`` verdict plus a reasoned incident log:

* **slow chunks** — a chunk several times the EWMA wall baseline;
* **candidate storm** — table rows above the threshold far above their
  baseline (the RFI-storm signature); sustained, CRITICAL;
* **device headroom** — a low free-memory fraction degrades, near zero
  is critical;
* **retraces / dispatch retries / quarantines / persist dead letters /
  OOM events** — the robustness layer's counters become conditions; a
  permanent fallback is a sticky condition;
* **live-feed conditions** (gaps, overruns, disconnects), for a feed
  that reports them;
* **canary recall floor** — once enough canaries were injected
  (:mod:`.canary`), a windowed recall below the floor is CRITICAL even
  when every throughput counter is green.

Conditions use hysteresis: a raised condition stays active for
``recover_after`` further updates unless raised again; sticky ones never
decay.  Verdict transitions are recorded apart from incidents.

Thread-safe: the HTTP scrape thread (:mod:`.server`) reads
:meth:`snapshot` while the chunk loop calls :meth:`update`.
"""

from __future__ import annotations

import collections
import threading
import time

from . import metrics as _metrics

__all__ = ["OK", "DEGRADED", "CRITICAL", "HealthEngine"]

OK = "OK"
DEGRADED = "DEGRADED"
CRITICAL = "CRITICAL"

#: severity order for folding conditions into one verdict
_RANK = {OK: 0, DEGRADED: 1, CRITICAL: 2}


class _Condition:
    __slots__ = ("kind", "severity", "detail", "ttl", "sticky")

    def __init__(self, kind, severity, detail, ttl, sticky):
        self.kind = kind
        self.severity = severity
        self.detail = detail
        self.ttl = ttl
        self.sticky = sticky


class HealthEngine:
    """Fold per-chunk telemetry into an OK/DEGRADED/CRITICAL verdict.

    Call :meth:`update` once per chunk (the drivers do this when an
    engine is wired in); read :meth:`verdict` / :meth:`snapshot` from
    anywhere.  All thresholds are constructor knobs with deliberately
    conservative defaults — the engine flags *kinds* of trouble (3x
    wall, order-of-magnitude candidate spikes), not scheduler noise.
    """

    def __init__(self, *, wall_factor=3.0, ewma_alpha=0.3, warmup=2,
                 cand_factor=8.0, cand_abs_min=16, storm_critical_after=3,
                 headroom_degraded=0.10, headroom_critical=0.03,
                 retrace_budget=3, retry_budget=3, quarantine_critical=3,
                 recall_floor=0.7, recall_min_injected=10,
                 recall_window=20, recover_after=2, max_incidents=200,
                 gap_degraded=0.0, overrun_critical_after=3):
        self.wall_factor = float(wall_factor)
        self.ewma_alpha = float(ewma_alpha)
        self.warmup = int(warmup)
        self.cand_factor = float(cand_factor)
        self.cand_abs_min = int(cand_abs_min)
        self.storm_critical_after = int(storm_critical_after)
        self.headroom_degraded = float(headroom_degraded)
        self.headroom_critical = float(headroom_critical)
        self.retrace_budget = int(retrace_budget)
        self.retry_budget = int(retry_budget)
        self.quarantine_critical = int(quarantine_critical)
        self.recall_floor = float(recall_floor)
        self.recall_min_injected = int(recall_min_injected)
        self.recall_window = int(recall_window)
        self.recover_after = int(recover_after)
        self.gap_degraded = float(gap_degraded)
        self.overrun_critical_after = int(overrun_critical_after)

        self._lock = threading.Lock()
        self._active = {}           # kind -> _Condition
        self._incidents = collections.deque(maxlen=max_incidents)
        self.transitions = []       # (chunk, from, to, reasons)
        self._verdict = OK
        self._updates = 0
        self._wall_ewma = None
        self._cand_ewma = None
        self._storm_run = 0
        self._retraces = 0
        self._retries = 0
        self._quarantined = 0
        self._oom_events = 0
        self._overrun_run = 0

    # -- condition plumbing --------------------------------------------------

    def _raise(self, chunk, kind, severity, detail, sticky=False):
        cond = self._active.get(kind)
        if cond is None or _RANK[severity] > _RANK[cond.severity]:
            self._incidents.append({
                "chunk": chunk, "kind": kind, "severity": severity,
                "event": "raised", "detail": detail,
                "t": round(time.time(), 3)})
            _metrics.counter("putpu_health_incidents_total",
                             kind=kind).inc()
        if cond is None:
            self._active[kind] = _Condition(kind, severity, detail,
                                            self.recover_after, sticky)
        else:
            if _RANK[severity] > _RANK[cond.severity]:
                cond.severity = severity
            cond.detail = detail
            cond.ttl = self.recover_after
            cond.sticky = cond.sticky or sticky

    def _decay(self, chunk, raised):
        for kind in list(self._active):
            cond = self._active[kind]
            if kind in raised or cond.sticky:
                continue
            cond.ttl -= 1
            if cond.ttl <= 0:
                del self._active[kind]
                self._incidents.append({
                    "chunk": chunk, "kind": kind,
                    "severity": cond.severity, "event": "resolved",
                    "detail": cond.detail, "t": round(time.time(), 3)})

    def _refold(self, chunk):
        new = OK
        for cond in self._active.values():
            if _RANK[cond.severity] > _RANK[new]:
                new = cond.severity
        if new != self._verdict:
            self.transitions.append(
                {"chunk": chunk, "from": self._verdict, "to": new,
                 "reasons": sorted(self._active)})
            self._verdict = new
        _metrics.gauge("putpu_health_status").set(_RANK[new])

    # -- the per-chunk update ------------------------------------------------

    def update(self, chunk, *, wall_s=None, candidates=None,
               quarantined=False, dead_letter=False, retraces=0,
               dispatch_retries=0, headroom_frac=None, fallback=False,
               canary=None, oom_events=0, oom_floor=False,
               ingest_gap_frac=None, ingest_overrun=0,
               ingest_disconnects=0):
        """Fold one chunk's telemetry in; returns the verdict after it.

        ``candidates`` is the number of table rows above the hit
        threshold (the RFI-storm signal — NOT the 0/1 hit decision);
        ``headroom_frac`` is free-device-memory / limit when known;
        ``canary`` is the controller's :meth:`~.canary.CanaryController.
        summary` dict (``injected`` + ``window_recall`` are consumed);
        ``oom_events`` is this chunk's caught-RESOURCE_EXHAUSTED count
        (degradation-ladder descents -> ``memory_pressure`` DEGRADED)
        and ``oom_floor`` marks a chunk quarantined because
        even the ladder's numpy floor OOMed (-> ``oom_floor``
        CRITICAL); both decay on clean chunks like every non-sticky
        condition, so the verdict recovers once pressure lifts.

        The ``ingest_*`` trio comes from a live-feed assembler, once
        per cut chunk: ``ingest_gap_frac`` above
        ``gap_degraded`` raises ``feed_gap`` DEGRADED (a lossy feed is
        degraded science even when every chunk clears the quarantine
        rail); ``ingest_overrun`` (chunks shed since the last cut)
        raises ``feed_overrun`` DEGRADED, escalating to CRITICAL after
        ``overrun_critical_after`` consecutive overrun chunks (search
        is persistently behind the feed — data loss is structural, not
        a blip); ``ingest_disconnects`` raises ``feed_disconnect``
        DEGRADED.  All three decay over ``recover_after`` clean chunks
        like every non-sticky condition: disconnect -> reconnect ->
        OK once the feed holds.
        """
        with self._lock:
            self._updates += 1
            raised = set()

            def flag(kind, severity, detail, sticky=False):
                raised.add(kind)
                self._raise(chunk, kind, severity, detail, sticky)

            if wall_s is not None:
                wall_s = float(wall_s)
                if self._wall_ewma is not None \
                        and self._updates > self.warmup \
                        and wall_s > self.wall_factor * self._wall_ewma \
                        + 0.05:
                    flag("slow_chunk", DEGRADED,
                         f"chunk wall {wall_s:.2f}s vs EWMA baseline "
                         f"{self._wall_ewma:.2f}s "
                         f"(factor {self.wall_factor:g})")
                else:
                    # spikes are excluded from the baseline on purpose:
                    # a storm of slow chunks must not drag the baseline
                    # up until the storm looks normal
                    self._wall_ewma = (wall_s if self._wall_ewma is None
                                       else (1 - self.ewma_alpha)
                                       * self._wall_ewma
                                       + self.ewma_alpha * wall_s)

            if candidates is not None:
                candidates = int(candidates)
                baseline = self._cand_ewma if self._cand_ewma is not None \
                    else 0.0
                ceiling = max(self.cand_abs_min,
                              self.cand_factor * (baseline + 1.0))
                if self._updates > self.warmup and candidates > ceiling:
                    self._storm_run += 1
                    sev = (CRITICAL
                           if self._storm_run >= self.storm_critical_after
                           else DEGRADED)
                    flag("candidate_storm", sev,
                         f"{candidates} candidates in one chunk vs "
                         f"baseline {baseline:.1f} (RFI storm signature; "
                         f"{self._storm_run} consecutive)")
                else:
                    self._storm_run = 0
                    self._cand_ewma = (float(candidates)
                                       if self._cand_ewma is None
                                       else (1 - self.ewma_alpha)
                                       * self._cand_ewma
                                       + self.ewma_alpha * candidates)

            if quarantined:
                self._quarantined += 1
                sev = (CRITICAL
                       if self._quarantined >= self.quarantine_critical
                       else DEGRADED)
                flag("quarantine", sev,
                     f"chunk {chunk} quarantined "
                     f"({self._quarantined} so far)")
            if dead_letter:
                flag("persist_dead_letter", DEGRADED,
                     f"chunk {chunk} persisted to the dead-letter "
                     "manifest (candidate missing on purpose)")
            if retraces:
                self._retraces += int(retraces)
                if self._retraces >= self.retrace_budget:
                    flag("retrace_storm", DEGRADED,
                         f"{self._retraces} retraces (shape drift? "
                         "interior chunks should reuse one executable)")
            if dispatch_retries:
                self._retries += int(dispatch_retries)
                if self._retries >= self.retry_budget:
                    flag("dispatch_retries", DEGRADED,
                         f"{self._retries} dispatch retries "
                         "(flaky device/link)")
            if fallback:
                flag("numpy_fallback", DEGRADED,
                     "device search fell back to the numpy reference "
                     "path permanently (reference speed)", sticky=True)

            if oom_events:
                self._oom_events += int(oom_events)
                flag("memory_pressure", DEGRADED,
                     f"{int(oom_events)} RESOURCE_EXHAUSTED caught on "
                     f"chunk {chunk} ({self._oom_events} this run) — "
                     "the degradation ladder is re-dispatching smaller "
                     "(byte-identical, slower)")
            if oom_floor:
                flag("oom_floor", CRITICAL,
                     f"chunk {chunk} quarantined at the ladder floor: "
                     "even the numpy reference path ran out of memory "
                     "— this host cannot search chunks of this "
                     "geometry at all")

            if ingest_gap_frac is not None \
                    and float(ingest_gap_frac) > self.gap_degraded:
                flag("feed_gap", DEGRADED,
                     f"{100 * float(ingest_gap_frac):.2f}% of chunk "
                     f"{chunk}'s samples never arrived (zero-filled)")
            if ingest_overrun:
                self._overrun_run += 1
                sev = (CRITICAL
                       if self._overrun_run >= self.overrun_critical_after
                       else DEGRADED)
                flag("feed_overrun", sev,
                     f"{int(ingest_overrun)} chunk(s) shed at chunk "
                     f"{chunk} — search is behind the feed "
                     f"({self._overrun_run} consecutive)")
            else:
                self._overrun_run = 0
            if ingest_disconnects:
                flag("feed_disconnect", DEGRADED,
                     f"{int(ingest_disconnects)} feed disconnect(s) "
                     f"before chunk {chunk} (reconnected)")

            if headroom_frac is not None:
                headroom_frac = float(headroom_frac)
                if headroom_frac < self.headroom_critical:
                    flag("device_headroom", CRITICAL,
                         f"device headroom {100 * headroom_frac:.1f}% "
                         "(next chunk is an OOM away)")
                elif headroom_frac < self.headroom_degraded:
                    flag("device_headroom", DEGRADED,
                         f"device headroom {100 * headroom_frac:.1f}%")

            if canary and canary.get("injected", 0) \
                    >= self.recall_min_injected:
                recall = canary.get("window_recall")
                if recall is not None and recall < self.recall_floor:
                    flag("canary_recall", CRITICAL,
                         f"canary recall {recall:.2f} over the last "
                         f"{canary.get('window', self.recall_window)} "
                         f"injections is below the {self.recall_floor:g} "
                         "floor — detection efficiency is degrading "
                         "while perf counters may still be green")

            self._decay(chunk, raised)
            self._refold(chunk)
            return self._verdict

    # -- external conditions (the SLO engine's and the push broker's seam) --

    def note_alert(self, kind, severity, detail, chunk="slo"):
        """Raise (or refresh) a condition from OUTSIDE the per-chunk
        update path — the SLO engine feeds burn-rate alerts here, so a
        budget burn degrades the same verdict the fleet's lease gating
        and ``/healthz`` probes already act on.  Unlike chunk-raised
        conditions the severity tracks the raiser EXACTLY — a page
        that subsides to a ticket must de-escalate ``/healthz`` from
        503, not hold CRITICAL until the slow window drains.
        Externally-raised conditions do not decay on chunk updates
        (the raiser knows when the burn stopped): pair with
        :meth:`resolve_alert`."""
        with self._lock:
            cond = self._active.get(kind)
            if cond is None or _RANK[severity] > _RANK[cond.severity]:
                self._incidents.append({
                    "chunk": chunk, "kind": kind, "severity": severity,
                    "event": "raised", "detail": detail,
                    "t": round(time.time(), 3)})
                _metrics.counter("putpu_health_incidents_total",
                                 kind=kind).inc()
            if cond is None:
                self._active[kind] = _Condition(
                    kind, severity, detail, self.recover_after,
                    sticky=True)
            else:
                cond.severity = severity      # both directions
                cond.detail = detail
                cond.ttl = self.recover_after
            self._refold(chunk)

    def resolve_alert(self, kind, chunk="slo"):
        """Clear a :meth:`note_alert` condition once its source stops
        firing (idempotent)."""
        with self._lock:
            cond = self._active.pop(kind, None)
            if cond is not None:
                self._incidents.append({
                    "chunk": chunk, "kind": kind,
                    "severity": cond.severity, "event": "resolved",
                    "detail": cond.detail, "t": round(time.time(), 3)})
            self._refold(chunk)

    # -- read side -----------------------------------------------------------

    @property
    def verdict(self):
        with self._lock:
            return self._verdict

    def reasons(self):
        """Active condition kinds, worst first."""
        with self._lock:
            return [c.kind for c in sorted(
                self._active.values(),
                key=lambda c: (-_RANK[c.severity], c.kind))]

    def snapshot(self, max_incidents=50):
        """JSON-ready state for ``/healthz`` and the survey report."""
        with self._lock:
            return {
                "status": self._verdict,
                "reasons": [
                    {"kind": c.kind, "severity": c.severity,
                     "detail": c.detail}
                    for c in sorted(self._active.values(),
                                    key=lambda c: (-_RANK[c.severity],
                                                   c.kind))],
                "updates": self._updates,
                "incidents": list(self._incidents)[-max_incidents:],
                "transitions": list(self.transitions),
            }
