"""putpu-lint core: findings, checker registry, the per-file/project run.

The framework is deliberately small and stdlib-only (``ast`` +
``tokenize``): it must be importable — and fast — without torch,
because it runs in CI, inside the perf gate
(:mod:`pulsarutils_tpu_torch.cli.gate_main`) and as a test over the
whole tree.

Concepts
--------

* :class:`Finding` — one violation: ``path:line``, checker id, message,
  severity.  Waiver/baseline status is stamped on during a run.
* checker — an object with an ``id``, the finding ``ids`` it may emit,
  a ``check(ctx)`` hook called once per file, and an optional
  ``finalize(project)`` hook called after every file was scanned (for
  cross-file invariants like metric-name coverage).  Register with
  :func:`register`.
* :class:`FileContext` — parsed source handed to checkers: the ``ast``
  tree, source lines, the repo-relative and package-relative paths, and
  the waivers parsed from comments (:mod:`.waivers`).
* :class:`LintProject` — one run over many files; accumulates findings
  and per-checker cross-file state.

Checkers report *every* violation; the run then marks each finding
waived (inline ``# putpu-lint: disable=<id>``) or baselined
(:mod:`.baseline`) — only the remainder is "new" and fails the CLI.
"""

from __future__ import annotations

import ast
import dataclasses
import os

from . import waivers as _waivers

__all__ = ["Finding", "FileContext", "LintProject", "register",
           "registered_checkers", "all_finding_ids", "lint_source",
           "lint_paths", "iter_python_files", "PACKAGE_NAME"]

PACKAGE_NAME = "pulsarutils_tpu_torch"


@dataclasses.dataclass
class Finding:
    """One lint violation at ``path:line``."""

    path: str
    line: int
    col: int
    checker: str           # finding id, e.g. "broad-except"
    message: str
    severity: str = "error"
    waived: bool = False
    baselined: bool = False
    #: last source line the waiver comment may sit on (multi-line
    #: statements accept a trailing waiver on any of their lines)
    end_line: int = 0

    def __post_init__(self):
        if not self.end_line:
            self.end_line = self.line

    @property
    def new(self):
        return not (self.waived or self.baselined)

    def location(self):
        return f"{self.path}:{self.line}"

    def to_dict(self):
        return {"path": self.path, "line": self.line, "col": self.col,
                "checker": self.checker, "message": self.message,
                "severity": self.severity, "waived": self.waived,
                "baselined": self.baselined}


class FileContext:
    """Everything a checker needs about one file."""

    def __init__(self, path, source, relpath=None, tree=None):
        self.path = str(path)
        self.source = source
        self.lines = source.splitlines()
        self.relpath = _posix(relpath if relpath is not None else path)
        self.pkgpath = _package_relative(self.relpath)
        self.tree = tree if tree is not None else ast.parse(
            source, filename=self.path)
        self.waivers = _waivers.parse_waivers(source)
        self.project = None  # set by LintProject before checkers run
        #: (node, parent) links + enclosing-scope helpers, built lazily
        self._parents = None

    # -- tree helpers --------------------------------------------------------

    def parents(self):
        """``{child_node: parent_node}`` for the whole tree (lazy)."""
        if self._parents is None:
            self._parents = {}
            for parent in ast.walk(self.tree):
                for child in ast.iter_child_nodes(parent):
                    self._parents[child] = parent
        return self._parents

    def ancestors(self, node):
        """Ancestor chain of ``node``, innermost first."""
        parents = self.parents()
        out = []
        cur = parents.get(node)
        while cur is not None:
            out.append(cur)
            cur = parents.get(cur)
        return out

    def enclosing_function(self, node):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def qualname(self, node):
        """Dotted class/function nesting of ``node`` (e.g.
        ``"Handler.do_GET"``), ``""`` at module level."""
        parts = []
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(anc.name)
        return ".".join(reversed(parts))

    def finding(self, node, checker, message, severity="error"):
        return Finding(
            path=self.relpath, line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0), checker=checker,
            message=message, severity=severity,
            end_line=getattr(node, "end_lineno", None)
            or getattr(node, "lineno", 1))


def dotted_name(node):
    """``"torch.cuda.synchronize"`` for a Name/Attribute chain, or
    ``None`` when the expression is not a plain dotted name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def name_root(node):
    """Leftmost name of a Name/Attribute/Subscript/Call chain (``"np"``
    for ``np.asarray(x)[0]``), or ``None``."""
    while True:
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            break
    return node.id if isinstance(node, ast.Name) else None


def _posix(path):
    return str(path).replace(os.sep, "/")


def _package_relative(relpath):
    """Path inside the :data:`PACKAGE_NAME` package (``"ops/search.py"``)
    or ``None`` for files outside it — checkers scoped to package layers
    (device-trip, float64-leak) key off this."""
    parts = _posix(relpath).split("/")
    if PACKAGE_NAME in parts:
        inner = parts[parts.index(PACKAGE_NAME) + 1:]
        return "/".join(inner) if inner else None
    return None


# -- checker registry --------------------------------------------------------

_CHECKERS = []


def register(checker):
    """Class decorator: instantiate and register a checker.  Checkers
    must expose ``id`` (str), ``ids`` (tuple of finding ids it emits)
    and ``check(ctx)``; ``finalize(project)`` is optional."""
    inst = checker() if isinstance(checker, type) else checker
    _CHECKERS.append(inst)
    return checker


def registered_checkers():
    _load_builtin_checkers()
    return list(_CHECKERS)


def all_finding_ids():
    ids = []
    for c in registered_checkers():
        ids.extend(c.ids)
    return sorted(set(ids))


_BUILTINS_LOADED = False


def _load_builtin_checkers():
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True
    from . import (dtypes, device_trip, exceptions, locks,  # noqa: F401
                   name_drift, persistence, reason_drift, spans)


# -- the run -----------------------------------------------------------------

class LintProject:
    """One lint run: scan files, apply waivers, collect findings.

    ``root`` is the project root used by cross-file checkers to locate
    artifacts (the manifest, docs, the committed gate baseline);
    ``manifest_names``/``dynamic_names`` override the manifest for
    fixture tests.
    """

    def __init__(self, root=None, select=None, manifest_names=None,
                 dynamic_names=None):
        self.root = str(root) if root else None
        self.select = set(select) if select else None
        self.manifest_names = manifest_names
        self.dynamic_names = dynamic_names
        self.findings = []
        self.files = []
        self.sources = {}       # relpath -> source lines (baseline hashes)
        #: free-form scratch space for checkers' cross-file state
        self.state = {}
        self.checkers = [c for c in registered_checkers()
                         if self.select is None or c.id in self.select
                         or any(i in self.select for i in c.ids)]

    def check_source(self, source, path):
        """Lint one in-memory source blob (fixture tests use virtual
        paths like ``"pulsarutils_tpu_torch/ops/x.py"`` to exercise the
        layer-scoped checkers)."""
        relpath = (_posix(os.path.relpath(path, self.root))
                   if self.root and os.path.isabs(str(path))
                   else _posix(path))
        try:
            ctx = FileContext(path, source, relpath=relpath)
        except SyntaxError as exc:
            self.findings.append(Finding(
                path=relpath, line=exc.lineno or 1, col=exc.offset or 0,
                checker="syntax-error", message=f"unparseable: {exc.msg}"))
            return []
        ctx.project = self  # cross-file checkers accumulate state here
        self.files.append(relpath)
        self.sources[relpath] = ctx.lines
        out = []
        for checker in self.checkers:
            out.extend(checker.check(ctx) or ())
        out.extend(self._waiver_hygiene(ctx))
        for f in out:
            f.waived = ctx.waivers.waives(f.checker, f.line, f.end_line)
        self.findings.extend(out)
        return out

    def check_file(self, path):
        with open(path, encoding="utf-8") as fh:
            return self.check_source(fh.read(), path)

    def finalize(self):
        """Run cross-file hooks; returns (and records) their findings.
        Finalize findings can be waived only via the baseline (they have
        no single source line to carry a comment)."""
        out = []
        for checker in self.checkers:
            hook = getattr(checker, "finalize", None)
            if hook is not None:
                out.extend(hook(self) or ())
        self.findings.extend(out)
        return out

    def _waiver_hygiene(self, ctx):
        """A waiver naming an unknown finding id is itself a finding —
        a typoed ``disable=`` must not silently waive nothing."""
        known = set(all_finding_ids())
        known.update(c.id for c in registered_checkers())
        out = []
        for line, ids in ctx.waivers.unknown_ids(known):
            for wid in ids:
                out.append(Finding(
                    path=ctx.relpath, line=line, col=0,
                    checker="lint-waiver-unknown",
                    message=f"waiver names unknown checker id {wid!r} "
                            f"(known: see --list-checkers)"))
        return out

    # -- results -------------------------------------------------------------

    def new_findings(self):
        return [f for f in self.findings if f.new]

    def apply_baseline(self, baseline):
        from . import baseline as _baseline

        return _baseline.apply(baseline, self.findings,
                               sources=self.sources)

    def report(self):
        """JSON-ready run report (the artifact the perf gate checks)."""
        findings = sorted(self.findings,
                          key=lambda f: (f.path, f.line, f.checker))
        return {
            "schema_version": 1,
            "tool": "putpu-lint",
            "files": len(self.files),
            "checkers": sorted(c.id for c in self.checkers),
            "findings": [f.to_dict() for f in findings],
            "new": sum(1 for f in findings if f.new),
            "waived": sum(1 for f in findings if f.waived),
            "baselined": sum(1 for f in findings if f.baselined),
            "clean": not any(f.new for f in findings),
        }


def iter_python_files(paths):
    """Yield ``.py`` files under ``paths`` (files pass through), sorted,
    skipping caches/hidden dirs."""
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(d for d in dirnames
                                 if not d.startswith((".", "__pycache__")))
            for name in sorted(filenames):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)


def lint_source(source, path="module.py", select=None, root=None,
                manifest_names=None, dynamic_names=None):
    """Lint one source string; returns the findings (waivers applied,
    no baseline).  The convenience entry fixture tests and the docs
    example use:

    >>> src = "try:\\n    pass\\nexcept Exception:\\n    pass\\n"
    >>> [f.checker for f in lint_source(src, path="pipeline/x.py")]
    ['broad-except']
    """
    project = LintProject(root=root, select=select,
                          manifest_names=manifest_names,
                          dynamic_names=dynamic_names)
    project.check_source(source, path)
    return [f for f in project.findings if not f.waived]


def lint_paths(paths, root=None, select=None, baseline=None):
    """Lint files/directories; returns the :class:`LintProject`."""
    if root is None:
        root = _default_root(paths)
    project = LintProject(root=root, select=select)
    for path in iter_python_files(paths):
        project.check_file(path)
    project.finalize()
    if baseline is not None:
        project.apply_baseline(baseline)
    return project


def _default_root(paths):
    """Repo root guess: the parent of the first scanned
    :data:`PACKAGE_NAME` directory, else the common prefix."""
    for p in paths:
        ap = os.path.abspath(str(p))
        parts = ap.split(os.sep)
        if PACKAGE_NAME in parts:
            idx = parts.index(PACKAGE_NAME)
            return os.sep.join(parts[:idx]) or os.sep
        if os.path.isdir(os.path.join(ap, PACKAGE_NAME)):
            return ap
    return os.path.dirname(os.path.abspath(str(paths[0]))) if paths else "."
