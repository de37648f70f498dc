"""End-of-run integrity audit: ledger vs candidate files vs quarantine.

A run leaves three artifacts in its output directory — the resume ledger
(``progress_<fingerprint>.json``), the candidate pairs (``*.info.npz`` +
``*.table.npz``) and the quarantine manifest
(``quarantine_<fingerprint>.jsonl``).  :func:`audit_run` cross-checks
them and reports every inconsistency, as the JAX package's audit does:

* a **torn pair** — an ``.info.npz`` without its ``.table.npz`` or vice
  versa (a crash mid-persist); ``repair=True`` removes the stray half;
* a **quarantined chunk with candidate files**;
* a **manifest/ledger mismatch** — a manifest record whose chunk the
  ledger does not mark done-with-reason, or a ledger reason with no
  manifest record.

Candidate pairs absent from the ledger are reported as ``orphans``
(informational): the crash window between ``save_candidate`` and
``mark_done``, or another configuration's pairs in a shared directory.
``search_by_chunks`` runs the audit at the end of every resumable run;
issue counts land on ``putpu_audit_issues_total``.
"""

from __future__ import annotations

import json
import logging
import os

from ..obs import metrics as _metrics
from . import reasons
from .policy import QuarantineManifest

logger = logging.getLogger("pulsarutils_tpu_torch")

#: dead-letter reason (the persist retry writes it; the audit knows a
#: dead-lettered chunk legitimately has no candidate pair)
DEAD_LETTER_REASON = reasons.PERSIST_DEAD_LETTER


def _candidate_pairs(directory):
    """``{(root, lo, hi): {"info": bool, "table": bool}}`` for every
    candidate stem in ``directory``."""
    pairs = {}
    for name in sorted(os.listdir(directory)):
        for suffix, part in ((".info.npz", "info"), (".table.npz", "table")):
            if not name.endswith(suffix):
                continue
            stem = name[: -len(suffix)]
            root, _, span = stem.rpartition("_")
            lo, _, hi = span.partition("-")
            try:
                key = (root, int(lo), int(hi))
            except ValueError:
                continue  # not a candidate file
            pairs.setdefault(key, {"info": False, "table": False})[part] = True
    return pairs


def audit_run(directory, fingerprint, root=None, repair=False):
    """Cross-check ledger vs candidate files vs quarantine manifest.

    Returns ``{"ok", "issues": [...], "orphans": [...], "repaired":
    [...], "checked": {...}}``; each issue is ``{"kind", "chunk"?,
    "detail"}``.  ``root`` restricts ledger-coupled checks to one file's
    candidates (a shared directory holds many roots); ``repair=True``
    deletes the stray half of torn pairs.

    The ledger is read directly (NOT through ``CandidateStore``, whose
    loader *recovers* a torn ledger by renaming it aside — an audit
    must never move the evidence it is auditing); an unreadable ledger
    is itself reported as an issue.
    """
    directory = str(directory)
    done = set()
    ledger_q = {}
    issues = []
    if fingerprint is not None:
        ledger_path = os.path.join(directory,
                                   f"progress_{fingerprint}.json")
        if os.path.exists(ledger_path):
            try:
                with open(ledger_path) as f:
                    ledger = json.load(f)
                done = set(ledger.get("done", []))
                ledger_q = {int(k): v for k, v in
                            ledger.get("quarantined", {}).items()}
            except (ValueError, OSError) as exc:
                issues.append({"kind": "ledger_unreadable",
                               "detail": f"{ledger_path}: {exc!r}"})
    manifest = QuarantineManifest(directory, fingerprint)
    records = manifest.records()
    manifest_by_chunk = {}
    for rec in records:
        manifest_by_chunk.setdefault(int(rec["chunk"]), []).append(rec)

    orphans = []
    repaired = []
    pairs = _candidate_pairs(directory)

    for (r, lo, hi), have in sorted(pairs.items()):
        # root filter FIRST: in a shared output directory another
        # configuration's run may be mid-save (info written, table not
        # yet) — flagging it would be a false inconsistency and
        # repair=True would delete its half-written file out from under
        # it
        if root is not None and r != root:
            continue
        base = os.path.join(directory, f"{r}_{lo}-{hi}")
        if not (have["info"] and have["table"]):
            missing = "table" if have["info"] else "info"
            present = "info" if have["info"] else "table"
            if lo in ledger_q:
                # expected remnant of a dead-lettered/quarantined
                # persist: the failed save may have written half the
                # pair before giving up — the ledger carries the
                # reason, so this is NOT an inconsistency; repair
                # still removes the stray half
                orphans.append({"kind": "dead_letter_remnant",
                                "chunk": lo,
                                "detail": f"{r}_{lo}-{hi}: partial pair "
                                          f"left by {ledger_q[lo]!r}"})
            else:
                issues.append({"kind": "torn_pair", "chunk": lo,
                               "detail": f"{r}_{lo}-{hi}: .{missing}.npz "
                                         "missing"})
            if repair:
                path = f"{base}.{present}.npz"
                try:
                    os.remove(path)
                    repaired.append(path)
                except OSError:
                    pass
            continue
        if lo in ledger_q:
            issues.append({"kind": "quarantined_with_candidate",
                           "chunk": lo,
                           "detail": f"{r}_{lo}-{hi} persisted but ledger "
                                     f"quarantines it ({ledger_q[lo]})"})
        elif fingerprint is not None and lo not in done:
            orphans.append({"kind": "unmarked_candidate", "chunk": lo,
                            "detail": f"{r}_{lo}-{hi} persisted but not "
                                      "marked done (resume reprocesses it)"})

    for chunk, recs in sorted(manifest_by_chunk.items()):
        if fingerprint is not None and chunk not in done:
            issues.append({"kind": "quarantine_not_done", "chunk": chunk,
                           "detail": "manifest records the chunk but the "
                                     "ledger does not mark it done"})
        if chunk not in ledger_q:
            issues.append({"kind": "quarantine_unmarked", "chunk": chunk,
                           "detail": "manifest records the chunk but the "
                                     "ledger carries no reason for it"})
    for chunk, reason in sorted(ledger_q.items()):
        if chunk not in manifest_by_chunk:
            issues.append({"kind": "quarantine_unrecorded", "chunk": chunk,
                           "detail": f"ledger marks {reason!r} but the "
                                     "manifest has no record"})

    if issues:
        _metrics.counter("putpu_audit_issues_total").inc(len(issues))
    return {"ok": not issues, "issues": issues, "orphans": orphans,
            "repaired": repaired,
            "checked": {"pairs": len(pairs), "done": len(done),
                        "quarantined": len(ledger_q),
                        "manifest_records": len(records)}}
