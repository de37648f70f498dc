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


def atomic_write_json(path, doc):
    """Serialise ``doc`` as compact JSON and write it atomically."""
    atomic_write_text(path, json.dumps(doc))
