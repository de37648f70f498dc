"""The quarantine manifest's reason vocabulary, equal to the JAX
package's.

Every record :class:`~.policy.QuarantineManifest` appends names one of
these reasons; the audit (:mod:`.audit`) joins the manifest against the
ledger by reason.  Stdlib only.
"""

from __future__ import annotations

__all__ = [
    "READ_ERROR", "SHORT_READ", "INTEGRITY_PREFIX", "PERSIST_DEAD_LETTER",
    "OOM_FLOOR", "FEED_GAP", "SHED_OVERRUN", "QUARANTINE_REASONS",
    "is_known_reason",
]

#: the chunk could not be read from its source at all (I/O error)
READ_ERROR = "read_error"

#: the source returned fewer samples than the chunk geometry promised
SHORT_READ = "short_read"

#: composite prefix: the integrity gate condemned the chunk; the gate's
#: specific reasons (``nan_frac``, ``dead_frac``, ...) follow the colon
INTEGRITY_PREFIX = "integrity:"

#: candidate persist exhausted its retry budget; the manifest record IS
#: the durable artifact (the candidate npz is missing on purpose)
PERSIST_DEAD_LETTER = "persist_dead_letter"

#: even the degradation ladder's host floor ran out of memory — this
#: host cannot search chunks of this geometry
OOM_FLOOR = "oom_floor"

#: live-feed packet loss left the chunk's missing fraction above the
#: integrity policy's zero rail
FEED_GAP = "feed_gap"

#: ingest outran search and the admission-control seam dropped this
#: (oldest) assembled chunk whole
SHED_OVERRUN = "shed_overrun"

#: reason -> one-line meaning.  ``integrity:`` is a prefix entry:
#: recorded reasons append the gate's own condemnation list after the
#: colon.
QUARANTINE_REASONS = {
    "read_error": "chunk unreadable from its source (I/O error)",
    "short_read": "source returned fewer samples than the geometry",
    "integrity:": "integrity gate condemned the chunk (composite prefix)",
    "persist_dead_letter": "candidate persist exhausted its retries",
    "oom_floor": "numpy ladder floor OOMed; geometry unsearchable here",
    "feed_gap": "live-feed packet loss above the missing-fraction rail",
    "shed_overrun": "ingest outran search; oldest chunk dropped whole",
}


def is_known_reason(reason):
    """True when ``reason`` is vocabulary — exact member, or an
    ``integrity:``-prefixed composite."""
    reason = str(reason)
    return reason in QUARANTINE_REASONS \
        or reason.startswith(INTEGRITY_PREFIX)
