"""Atomic persistence: write to a temporary file, then ``os.replace``.

A crash mid-write leaves the previous file intact.  Append-only JSONL
journals (the fleet coordinator's) use :class:`JsonlAppender` and read
back through :func:`read_jsonl_tail_safe`, which survives a torn tail.
The bytes are the JAX package's.
"""

from __future__ import annotations

import json
import logging
import os
import shutil

logger = logging.getLogger("pulsarutils_tpu_torch")


def atomic_write_text(path, text):
    """Write ``text`` to ``path`` atomically (tmp + ``os.replace``)."""
    path = str(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
    os.replace(tmp, path)


def atomic_write_json(path, doc, *, indent=None, sort_keys=False,
                      trailing_newline=False):
    """Serialise ``doc`` as JSON (compact by default) and write it
    atomically; the formatting knobs are the JAX package's."""
    text = json.dumps(doc, indent=indent, sort_keys=sort_keys)
    atomic_write_text(path, text + "\n" if trailing_newline else text)


def append_jsonl(path, record):
    """Append ``record`` as one JSON line (one write, then a flush): a
    killed process loses nothing, a machine crash tears at most the last
    line.  Returns the line."""
    path = str(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    line = json.dumps(record) + "\n"
    with open(path, "a", encoding="utf-8") as f:
        f.write(line)
        f.flush()
    return line


class JsonlAppender:
    """A persistent append-mode handle with :func:`append_jsonl`'s
    discipline (one line, then a flush), for journals written on a hot
    path where reopening the file per record would serialise every
    caller behind the filesystem's open latency.  Not thread-safe: the
    caller owns concurrency.

    Call :meth:`reset` after anything replaces the file behind the
    handle (a torn-tail truncation, a ``.stale`` move): a cached handle
    points at the old inode and its appends would vanish.
    """

    def __init__(self, path):
        self.path = str(path)
        self._fh = None

    def append(self, record):
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def reset(self):
        """Drop the cached handle (reopened on the next append)."""
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    close = reset


def read_jsonl_tail_safe(path, what="journal"):
    """Parse a JSONL file that may end in a torn line.

    Returns ``(records, truncated)``.  Every parseable line from the top
    is a record; the first unparseable line, and everything after it, is
    the torn tail of an interrupted append, and so is an unterminated
    last line even when it parses (the writer always ends a line).  A
    torn file is copied to ``<path>.corrupt`` and its good prefix written
    back in place (atomically), so the next append lands on a clean file.
    A missing file is ``([], False)``.
    """
    path = str(path)
    try:
        with open(path, encoding="utf-8") as f:
            raw = f.read()
    except FileNotFoundError:
        return [], False
    records = []
    good = []
    truncated = False
    for i, line in enumerate(raw.split("\n")):
        if line == "" and i == raw.count("\n"):
            break   # the empty split after the final newline
        try:
            records.append(json.loads(line))
            good.append(line)
        except ValueError:
            truncated = True
            break
    if not truncated and raw and not raw.endswith("\n") and good:
        records.pop()
        good.pop()
        truncated = True
    if truncated:
        backup = path + ".corrupt"
        try:
            shutil.copy2(path, backup)
        except OSError:
            backup = "<uncopyable>"
        atomic_write_text(path, "".join(g + "\n" for g in good))
        logger.warning(
            "torn %s tail in %s: backed up to %s, truncated to %d good "
            "record(s)", what, path, backup, len(records))
    return records, truncated
