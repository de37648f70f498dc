"""Inline waiver syntax: ``# putpu-lint: disable=<id>[,<id>...]``.

A waiver comment suppresses matching findings on its own line, on the
next line (a comment-only line waives the statement below it), or — for
multi-line statements — anywhere inside the statement's line span.
``disable-file=<id>`` anywhere in the file waives the id file-wide
(reserve it for generated or reference-semantics modules).

Waivers are deliberate, reviewable exceptions: each one should carry a
short justification in the same comment, e.g.::

    std = np.asarray(block[:, ::stride])  # putpu-lint: disable=device-trip — host block

The parser tokenizes rather than regex-scanning the raw source so a
waiver-looking string literal never waives anything.
"""

from __future__ import annotations

import io
import re
import tokenize

__all__ = ["FileWaivers", "parse_waivers"]

_WAIVER_RE = re.compile(
    r"#\s*putpu-lint:\s*(disable|disable-file)\s*=\s*"
    r"([A-Za-z0-9_,\- ]+)")


class FileWaivers:
    """Waivers parsed from one file's comments."""

    def __init__(self):
        self.by_line = {}       # line -> set of ids
        self.file_wide = set()

    def waives(self, finding_id, line, end_line=None):
        if finding_id in self.file_wide:
            return True
        # covered comment lines: the line above the statement, then the
        # statement's own span — NOT the line after it (a comment there
        # is the line-above waiver of the NEXT statement)
        for ln in range(line - 1, (end_line or line) + 1):
            ids = self.by_line.get(ln)
            if ids and (finding_id in ids or "all" in ids):
                return True
        return False

    def unknown_ids(self, known):
        """``(line, [unknown ids])`` pairs for waiver hygiene checks."""
        out = []
        for line, ids in sorted(self.by_line.items()):
            bad = sorted(i for i in ids if i not in known and i != "all")
            if bad:
                out.append((line, bad))
        for wid in sorted(self.file_wide):
            if wid not in known and wid != "all":
                out.append((1, [wid]))
        return out


def parse_waivers(source):
    waivers = FileWaivers()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _WAIVER_RE.search(tok.string)
            if not m:
                continue
            kind, raw = m.groups()
            # the id list ends at the first token that is not a
            # separator-joined id (so a trailing "— reason" is free text)
            ids = set()
            for part in raw.split(","):
                part = part.strip().split()[0] if part.strip() else ""
                if part:
                    ids.add(part)
            if not ids:
                continue
            if kind == "disable-file":
                waivers.file_wide.update(ids)
            else:
                line = tok.start[0]
                waivers.by_line.setdefault(line, set()).update(ids)
    except tokenize.TokenizeError:
        pass
    return waivers
