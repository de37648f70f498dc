"""Atomic-persistence checker (``atomic-write``).

The coordinator write-ahead journal, the artifact fence map, the
ledgers and the progress files depend for *correctness* on the
torn-write discipline: durable ``*.json``/``*.jsonl`` state must be
written via tmp + ``os.replace`` (or, for journals, single flushed
line appends), and readers must survive whatever a crash still tears.
That discipline now lives in ONE sanctioned helper,
:mod:`pulsarutils_tpu_torch.io.atomic`; this checker makes the rule stick: a
direct ``open(<...>.json[l], "w"/"a"/"x")`` anywhere else in the tree
is a finding, because a plain overwrite of a state file is exactly the
torn-ledger/torn-journal bug class the helper exists to close.

The path must end in ``.json``/``.jsonl`` *statically* — a constant,
an f-string with a literal tail, a ``+`` concatenation, or an
``os.path.join`` whose last piece resolves — which keeps the checker
aimed at the real hazard (hard-coded state-file names like
``progress_{fp}.json``) and silent on ``--out``-style variables whose
targets are one-shot artifacts the operator names.  Writes to
``.tmp``-suffixed paths are not flagged: that *is* the atomic
pattern's first half, and it only exists inside the helper now.
"""

from __future__ import annotations

import ast

from .core import register

#: the one module allowed to open state files for writing: the
#: sanctioned tmp+``os.replace`` / flushed-append helper
SANCTIONED = ("io/atomic.py",)

_WRITE_MODES = set("wax")
_STATE_SUFFIXES = (".json", ".jsonl")


def _static_suffix(node):
    """The statically-known tail of a path expression, or ``None``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr) and node.values:
        last = node.values[-1]
        if isinstance(last, ast.Constant) and isinstance(last.value, str):
            return last.value
        return None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _static_suffix(node.right)
    if isinstance(node, ast.Call):
        from .core import dotted_name

        name = dotted_name(node.func)
        if name in ("os.path.join", "posixpath.join", "str") \
                and node.args:
            return _static_suffix(node.args[-1])
    return None


def _open_mode(call):
    """The mode string of an ``open()`` call (default ``"r"``), or
    ``None`` when it is not statically known."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return "r"
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value
    return None


@register
class AtomicWriteChecker:
    id = "atomic-write"
    ids = ("atomic-write",)

    def check(self, ctx):
        if ctx.pkgpath in SANCTIONED:
            return []
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if not (isinstance(node.func, ast.Name)
                    and node.func.id == "open") or not node.args:
                continue
            mode = _open_mode(node)
            if mode is None or not (_WRITE_MODES & set(mode)):
                continue
            suffix = _static_suffix(node.args[0])
            if suffix is None \
                    or not suffix.endswith(_STATE_SUFFIXES):
                continue
            what = "append to" if "a" in mode else "write of"
            out.append(ctx.finding(
                node, "atomic-write",
                f"direct {what} state file '...{suffix}' (mode "
                f"{mode!r}) — durable .json/.jsonl state must go "
                "through pulsarutils_tpu_torch.io.atomic "
                "(atomic_write_json / append_jsonl): a plain "
                "overwrite is the torn-ledger bug class the helper "
                "exists to close"))
        return out
