"""Committed baseline: grandfathered findings that do not fail the CLI.

A baseline entry fingerprints a finding by *content*, not line number —
``(checker id, repo-relative path, hash of the stripped source line,
ordinal among identical lines)`` — so unrelated edits above a
grandfathered site do not resurrect it, while editing the flagged line
itself (or adding a second identical violation) surfaces as new.

Workflow:

* ``--update-baseline`` rewrites the committed file from
  the current findings (waived findings are never baselined — they are
  already explicitly excepted in source);
* entries whose finding disappeared are dropped on update, so the
  baseline only ever shrinks as grandfathered sites get fixed;
* the CLI loads ``.putpu-torch-lint-baseline.json`` from the project root by
  default (``--no-baseline`` for the raw view).
"""

from __future__ import annotations

import hashlib
import json

__all__ = ["fingerprint", "fingerprints", "load", "save", "apply",
           "unscanned_entries"]


def _line_hash(finding, line_text):
    h = hashlib.sha1()
    h.update(line_text.strip().encode("utf-8", "replace"))
    return h.hexdigest()[:12]


def fingerprints(findings, sources):
    """``finding -> fingerprint`` for a batch.  ``sources`` maps relpath
    to the file's source lines (used for the content hash; a missing
    file hashes the empty string).  Identical (checker, path, line-text)
    triples are disambiguated by occurrence order."""
    seen = {}
    out = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col,
                                             f.checker)):
        lines = sources.get(f.path) or []
        text = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        base = f"{f.checker}:{f.path}:{_line_hash(f, text)}"
        n = seen.get(base, 0)
        seen[base] = n + 1
        out[id(f)] = f"{base}:{n}"
    return out


def fingerprint(finding, source_lines):
    """Fingerprint of one finding (see :func:`fingerprints`)."""
    return fingerprints([finding], {finding.path: source_lines})[
        id(finding)]


def load(path):
    """Load a baseline file -> set of fingerprints (missing file = empty
    baseline — a fresh checkout with no grandfathered findings)."""
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        return set()
    if isinstance(doc, dict):
        entries = doc.get("findings", [])
    else:
        entries = doc
    return {e["fingerprint"] if isinstance(e, dict) else str(e)
            for e in entries}


def save(path, findings, sources, notes=None, keep=None):
    """Write the baseline from current *unwaived* findings; returns the
    entry count.  Entries carry the human-readable location next to the
    fingerprint so review diffs are meaningful.  ``keep`` is raw entry
    dicts carried over verbatim (see :func:`unscanned_entries` — a
    partial-path update must not drop entries for files it never saw)."""
    fps = fingerprints(findings, sources)
    entries = list(keep or [])
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.checker)):
        if f.waived:
            continue
        entries.append({"fingerprint": fps[id(f)], "checker": f.checker,
                        "location": f.location(), "message": f.message})
    entries.sort(key=lambda e: (_location_key(e.get("location", "")),
                                e.get("checker", "")))
    doc = {"tool": "putpu-lint", "schema_version": 1,
           "note": notes or ("grandfathered findings; shrink me — fix or "
                             "inline-waive, then --update-baseline"),
           "findings": entries}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=False)
        fh.write("\n")
    return len(entries)


def _location_key(location):
    """Sort key for a ``path:line`` entry location (line numerically)."""
    path, _, line = location.rpartition(":")
    return (path, int(line)) if line.isdigit() else (location, 0)


def unscanned_entries(path, scanned_relpaths):
    """Raw entries of an existing baseline whose file was NOT part of
    this run (``scanned_relpaths``: the relpaths actually linted, e.g.
    ``project.sources``) — a partial-path ``--update-baseline`` carries
    these over instead of silently dropping them."""
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except (FileNotFoundError, ValueError):
        return []
    entries = doc.get("findings", []) if isinstance(doc, dict) else doc
    scanned = set(scanned_relpaths)
    out = []
    for e in entries:
        if not isinstance(e, dict):
            continue
        loc_path = e.get("location", "").rpartition(":")[0]
        if loc_path and loc_path not in scanned:
            out.append(e)
    return out


def apply(path_or_set, findings, sources=None):
    """Mark findings present in the baseline as ``baselined``.
    ``sources`` defaults to reading each finding's file lazily."""
    baseline = (path_or_set if isinstance(path_or_set, set)
                else load(path_or_set))
    if not baseline:
        return 0
    if sources is None:
        sources = _SourceCache()
    fps = fingerprints(findings, sources)
    n = 0
    for f in findings:
        if not f.waived and fps[id(f)] in baseline:
            f.baselined = True
            n += 1
    return n


class _SourceCache(dict):
    """Lazy relpath -> source-lines map (keyed like finding paths)."""

    def get(self, relpath, default=None):
        if relpath not in self:
            try:
                with open(relpath, encoding="utf-8") as fh:
                    self[relpath] = fh.read().splitlines()
            except OSError:
                self[relpath] = []
        return super().get(relpath, default)
