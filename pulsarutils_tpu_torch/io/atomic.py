"""Atomic persistence: write to a temporary file, then ``os.replace``.

A crash mid-write leaves the previous file intact.
"""

from __future__ import annotations

import json
import os


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
