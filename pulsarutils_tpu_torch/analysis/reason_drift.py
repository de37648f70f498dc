"""Quarantine-reason vocabulary checker (``quarantine-reason-*``).

The quarantine manifest's ``reason`` strings are an external contract
exactly like the ``putpu_*`` metric names: the audit joins ledger and
manifest by reason, operators grep post-mortems by reason, and
the port's section of ``README.md`` documents a reason table.
:mod:`pulsarutils_tpu_torch.faults.reasons` is the single source of
truth; this checker enforces every direction so code and docs cannot
drift:

* ``quarantine-reason-unknown`` (per file) — a string literal passed as
  the reason of ``manifest.record(...)`` that the vocabulary does not
  define (``integrity:``-prefixed composites are sanctioned).
* ``quarantine-reason-dynamic`` (per file) — an f-string reason the
  checker cannot resolve, unless it visibly starts with the
  ``integrity:`` composite prefix.
* ``quarantine-reason-undocumented`` (finalize) — a vocabulary member
  with no row in the marked reason table of ``README.md``'s port
  section (between ``<!-- torch-quarantine-reasons:begin -->`` and
  ``:end`` markers; the JAX package's table lives in ``docs/``).
* ``quarantine-reason-doc-unknown`` (finalize) — a reason-table row
  naming something the vocabulary does not define.
* ``quarantine-reason-unused`` (finalize, full-tree scans only) — a
  vocabulary member nothing records and no code references: dead
  vocabulary.

Like the metric-name checker, the vocabulary is **parsed** (AST literal
extraction from ``faults/reasons.py``), never imported.
"""

from __future__ import annotations

import ast
import os
import re

from .core import PACKAGE_NAME, register

_INTEGRITY_PREFIX = "integrity:"
_DOC_PATH = "README.md"
_DOC_BEGIN = "<!-- torch-quarantine-reasons:begin -->"
_DOC_END = "<!-- torch-quarantine-reasons:end -->"
_REASONS_PATH = PACKAGE_NAME + "/faults/reasons.py"
_ROW_RE = re.compile(r"^\|\s*`([^`|]+)`")


def load_vocabulary(root):
    """``(reasons set, constant-name -> reason map)`` parsed from
    ``faults/reasons.py`` under ``root``; empty when absent.

    A rootless project (fixture runs) has no vocabulary in scope —
    falling back to the CWD here would leak the host repo's real
    vocabulary into fixture scans."""
    if not root:
        return set(), {}
    path = os.path.join(root, *_REASONS_PATH.split("/"))
    try:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
    except (OSError, SyntaxError):
        return set(), {}
    vocab, consts = set(), {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if "QUARANTINE_REASONS" in targets \
                and isinstance(node.value, ast.Dict):
            vocab = {k.value for k in node.value.keys
                     if isinstance(k, ast.Constant)
                     and isinstance(k.value, str)}
        elif targets and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            for t in targets:
                if t.isupper():
                    consts[t] = node.value.value
    return vocab, consts


def _vocab(project):
    key = "reason-drift/vocab"
    if key not in project.state:
        project.state[key] = load_vocabulary(project.root)
    return project.state[key]


def _known(reason, vocab):
    return reason in vocab or reason.startswith(_INTEGRITY_PREFIX)


def _reason_arg(node):
    """The reason expression of a ``*.record(chunk, end, reason, ...)``
    call, or ``None`` when this is not a manifest-record call.  A
    manifest record is always a method call: a bare ``record(...)`` (a
    module's own function, as ``obs/roofline.py``'s) is not one."""
    if not isinstance(node.func, ast.Attribute) \
            or node.func.attr != "record":
        return None
    for kw in node.keywords:
        if kw.arg == "reason":
            return kw.value
    if len(node.args) >= 3:
        return node.args[2]
    return None


@register
class ReasonDriftChecker:
    id = "quarantine-reason"
    ids = ("quarantine-reason-unknown", "quarantine-reason-dynamic",
           "quarantine-reason-undocumented",
           "quarantine-reason-doc-unknown", "quarantine-reason-unused")

    def check(self, ctx):
        project = ctx.project
        if project is None:
            return []
        vocab, consts = _vocab(project)
        if not vocab:
            return []  # no vocabulary in scope (fixture runs)
        used = project.state.setdefault("reason-drift/used", set())
        in_vocab_module = ctx.pkgpath.endswith("faults/reasons.py")
        out = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Attribute) and not in_vocab_module \
                    and node.attr in consts:
                used.add(consts[node.attr])
                continue
            if not isinstance(node, ast.Call):
                continue
            arg = _reason_arg(node)
            if arg is None:
                continue
            if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                           str):
                reason = arg.value
                if not in_vocab_module:
                    used.add(_INTEGRITY_PREFIX if reason.startswith(
                        _INTEGRITY_PREFIX) else reason)
                if not _known(reason, vocab):
                    out.append(ctx.finding(
                        node, "quarantine-reason-unknown",
                        f"quarantine reason {reason!r} is not in "
                        "faults/reasons.py QUARANTINE_REASONS — the "
                        "vocabulary the audit and docs check against"))
            elif isinstance(arg, ast.Name) and arg.id in consts:
                used.add(consts[arg.id])
            elif isinstance(arg, (ast.JoinedStr, ast.BinOp)):
                head = None
                if isinstance(arg, ast.JoinedStr) and arg.values:
                    head = arg.values[0]
                elif isinstance(arg, ast.BinOp):
                    head = arg.left
                head_str = None
                if isinstance(head, ast.Constant) \
                        and isinstance(head.value, str):
                    head_str = head.value
                elif isinstance(head, ast.Attribute) \
                        and head.attr in consts:
                    head_str = consts[head.attr]
                elif isinstance(head, ast.Name) and head.id in consts:
                    head_str = consts[head.id]
                if head_str is not None \
                        and head_str.startswith(_INTEGRITY_PREFIX):
                    used.add(_INTEGRITY_PREFIX)
                else:
                    out.append(ctx.finding(
                        node, "quarantine-reason-dynamic",
                        "dynamically built quarantine reason — the "
                        "checker cannot verify it against the "
                        "vocabulary; compose from the faults/reasons "
                        "constants (the integrity: prefix is the one "
                        "sanctioned composite)"))
        return out

    # -- cross-file + docs coverage ------------------------------------------

    def finalize(self, project):
        vocab, _consts = _vocab(project)
        if not vocab:
            return []
        out = []
        documented = set(self._doc_rows(project, out))
        for reason in sorted(vocab):
            if reason not in documented:
                out.append(self._finding(
                    _REASONS_PATH, 1,
                    "quarantine-reason-undocumented",
                    f"vocabulary reason {reason!r} has no row in the "
                    f"marked reason table of {_DOC_PATH} — docs and "
                    "code must not drift"))
        layers = {(PACKAGE_NAME + "/" + sub) for sub in
                  ("obs/", "parallel/", "pipeline/", "faults/", "io/",
                   "ingest/")}
        scanned_pkg = all(any(p.startswith(layer) for p in project.files)
                          for layer in layers)
        if scanned_pkg:
            used = project.state.get("reason-drift/used", set())
            for reason in sorted(vocab):
                if reason not in used:
                    out.append(self._finding(
                        _REASONS_PATH, 1,
                        "quarantine-reason-unused",
                        f"vocabulary reason {reason!r} is never "
                        "recorded or referenced by any scanned file — "
                        "dead vocabulary"))
        return out

    def _doc_rows(self, project, out):
        """Reason tokens from the marked table; doc-unknown findings
        are appended to ``out`` as a side effect."""
        if not project.root:
            return
        path = os.path.join(project.root, _DOC_PATH)
        try:
            with open(path, encoding="utf-8") as fh:
                lines = fh.read().splitlines()
        except OSError:
            return
        vocab, _ = _vocab(project)
        inside = False
        for lineno, text in enumerate(lines, 1):
            if _DOC_BEGIN in text:
                inside = True
                continue
            if _DOC_END in text:
                inside = False
                continue
            if not inside:
                continue
            m = _ROW_RE.match(text.strip())
            if not m:
                continue
            token = m.group(1)
            if token not in vocab:
                out.append(self._finding(
                    _DOC_PATH.replace(os.sep, "/"), lineno,
                    "quarantine-reason-doc-unknown",
                    f"reason-table row {token!r} is not defined in "
                    "faults/reasons.py QUARANTINE_REASONS"))
            yield token

    @staticmethod
    def _finding(path, line, checker, message):
        from .core import Finding

        return Finding(path=path, line=line, col=0, checker=checker,
                       message=message)
