"""The coordinator's write-ahead journal: a crash and restart loses
nothing.

The port of the JAX package's journal, record for record, so a journal
one package's coordinator wrote replays in the other's.
:class:`FleetJournal` appends ``fleet_journal.jsonl`` beside the per-file
ledgers, one JSON record per control-plane event, flushed per append
(:class:`~..io.atomic.JsonlAppender`: a SIGKILL loses nothing already
appended):

========== ===========================================================
kind       meaning
========== ===========================================================
header     first record: ``{"schema_version": ...}`` (a valid file of
           another version is rejected, not treated as corruption: it
           moves to ``.stale`` and a fresh journal starts)
file       one sharded file: fname, fingerprint, cleaned config,
           workload, root, artifact, chunk grid, footprint estimate
unit       one planned work unit: id, fname, chunks (a reshard appends
           a new unit record carrying the inherited attempt count)
grant      one lease grant: lease id, unit, worker, epoch, so a
           restarted coordinator knows which units were in flight
           (requeued) and never mints a lease id again
requeue    a unit went back to the queue: attempts and the bumped epoch
           (the fencing token moves on every steal, requeue, reshard
           and recovery, so a zombie's epoch stays stale across
           coordinator restarts)
failed     a unit exhausted ``max_attempts``
duplicate  a late completion whose lease was already resolved
stale      a completion or release carrying an out-of-date epoch
recovered  a :meth:`~.coordinator.FleetCoordinator.recover` replay
========== ===========================================================

Chunk completion is never journaled: the per-file resume ledger is the
one completion record, so the journal can be lost entirely and recovery
degrades to "re-add the surveys; the ledger skips everything done".

Durability: appends are single flushed lines; a torn tail is backed up
to ``.corrupt`` and truncated to the good prefix on replay
(:func:`~..io.atomic.read_jsonl_tail_safe`); a version mismatch is
valid but rejected.
"""

from __future__ import annotations

import os
import threading

from ..io.atomic import JsonlAppender, read_jsonl_tail_safe
from ..obs import metrics as _metrics
from ..utils.logging_utils import logger

__all__ = ["JOURNAL_NAME", "JOURNAL_SCHEMA_VERSION", "FleetJournal"]

#: bump when a record's meaning changes (replay semantics, epoch rules)
JOURNAL_SCHEMA_VERSION = 1

#: the journal's fixed name beside the ledgers in ``output_dir``
JOURNAL_NAME = "fleet_journal.jsonl"


class FleetJournal:
    """Append/replay the coordinator's control-plane event log.

    ``path=None`` disables journaling entirely (``append`` no-ops,
    ``replay`` returns nothing) — the byte-inert spelling for callers
    that must not touch the output directory.
    """

    def __init__(self, path):
        self.path = str(path) if path is not None else None
        #: serialises the header check-then-append and the appender
        #: handle (handler threads + the sweep loop all journal; two
        #: racing first appends must not both write a header)
        self._lock = threading.Lock()
        #: one persistent append-mode handle — per-event re-opens
        #: would serialize every protocol handler behind filesystem
        #: open latency on the documented shared-filesystem deployment
        self._appender = (JsonlAppender(self.path)
                          if self.path is not None else None)
        self._has_header = False
        if self.path is not None and self._journal_nonempty():
            # appending to an existing journal: the header (and its
            # version fate) is replay's concern, not append's
            self._has_header = True

    def _journal_nonempty(self):
        try:
            return os.path.getsize(self.path) > 0
        except OSError:
            return False

    @classmethod
    def in_dir(cls, output_dir):
        return cls(os.path.join(str(output_dir), JOURNAL_NAME))

    def append(self, kind, **fields):
        """Durably append one ``{"kind": kind, **fields}`` record."""
        if self.path is None:
            return
        with self._lock:
            if not self._has_header:
                self._appender.append({
                    "kind": "header",
                    "schema_version": JOURNAL_SCHEMA_VERSION})
                self._has_header = True
            self._appender.append({"kind": str(kind), **fields})
        _metrics.counter("putpu_fleet_journal_records_total").inc()

    def close(self):
        """Release the append handle (safe to call repeatedly; the
        journal reopens lazily if appended to again)."""
        with self._lock:
            if self._appender is not None:
                self._appender.reset()

    def replay(self):
        """The journal's replayable records, in append order.

        Applies the full durability ladder: a missing journal replays
        as empty (recovery falls back to the ledgers alone); a torn
        tail is truncated to a ``.corrupt`` backup; a missing or
        mismatched schema version rejects every record — the file is
        moved aside to ``.stale`` (it is *valid*, just another
        release's) and a fresh journal starts on the next append.
        """
        if self.path is None:
            return []
        with self._lock:
            # the torn-tail truncation (and the .stale move below)
            # REPLACE the file: a cached append handle would write to
            # the old inode and every record after it would vanish
            if self._appender is not None:
                self._appender.reset()
        records, _truncated = read_jsonl_tail_safe(self.path,
                                                   what="fleet journal")
        if not records:
            # a missing journal, or one whose only (torn) line was
            # truncated away: the next append must write a FRESH
            # header — a stale _has_header=True here would leave the
            # rest of the run headerless and make the NEXT recovery
            # reject the whole (valid) journal as version-mismatched
            with self._lock:
                self._has_header = False
            return []
        header = records[0]
        version = (header.get("schema_version")
                   if isinstance(header, dict)
                   and header.get("kind") == "header" else None)
        if version != JOURNAL_SCHEMA_VERSION:
            backup = self.path + ".stale"
            try:
                os.replace(self.path, backup)
            except OSError:
                backup = "<unmovable>"
            logger.warning(
                "fleet journal %s has schema version %r (expected %r): "
                "records rejected, file moved to %s — re-add surveys, "
                "the ledgers still skip everything done",
                self.path, version, JOURNAL_SCHEMA_VERSION, backup)
            with self._lock:
                self._has_header = False
            return []
        out = [r for r in records[1:] if isinstance(r, dict)]
        if out:
            _metrics.counter(
                "putpu_fleet_journal_replayed_total").inc(len(out))
        return out
