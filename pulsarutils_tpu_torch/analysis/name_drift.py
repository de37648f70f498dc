"""Metric/span name-drift checker (``metric-name-*``).

The ``putpu_*`` namespace is an external contract: the perf gate's
committed baselines, the observability docs and any deployed Prometheus
scrape configs all reference these names by string.
:mod:`pulsarutils_tpu_torch.obs.names` is the single source of truth
(``METRIC_NAMES``, the JAX package's table, plus the port's own
``PORT_METRIC_NAMES``), and this checker enforces both directions:

* ``metric-name-unknown`` (per file) — a ``putpu_*`` literal passed to
  ``counter()``/``gauge()``/``histogram()`` — or to the precision
  policy's ``_count()`` helper, which records the same names — that is
  not declared in the manifest.  Adding a metric means declaring it.
* ``metric-name-dynamic`` (per file) — an f-string metric name.  The
  checker cannot resolve it; the ONE sanctioned seam (the budget
  accountant's counter mirror) is inline-waived and its names are
  enumerated as ``BUDGET_COUNTERS`` in the manifest.
* ``metric-name-unemitted`` (finalize) — a manifest name no scanned
  file emits: a stale entry, or a renamed metric whose manifest row was
  left behind.
* ``metric-name-unknown-ref`` (finalize) — a ``putpu_*`` token in
  ``README.md`` or the committed gate baseline that the manifest does
  not declare: the doc (or baseline) references a series nothing emits.

The manifest is read by **parsing** ``obs/names.py`` (AST literal
extraction), not importing it — the linter must run without the package
importable, e.g. from a bare CI checkout.
"""

from __future__ import annotations

import ast
import os
import re

from .core import PACKAGE_NAME, dotted_name, register

#: the registry facades, and ``precision/policy.py``'s ``_count`` helper
#: (it counts the ``putpu_precision_*`` series per policy)
_METRIC_CALLS = {"counter", "gauge", "histogram", "_count"}
_NAME_RE = re.compile(r"putpu_[A-Za-z0-9_]+")
#: project artifacts whose putpu_* references must resolve
_REFERENCE_GLOBS = ("README.md", "BENCH_GATE_cpu.jsonl")
#: non-metric putpu_ identifiers (contextvars, file prefixes) that may
#: appear in prose — never emitted, never an error
_PROSE_ALLOWED = {"putpu_budget", "putpu_trace_track", "putpu_plane_",
                  "putpu_plane", "putpu_lint", "putpu_lint_baseline"}


def load_manifest(root):
    """``(static names, dynamic counter suffixes)`` parsed from
    ``obs/names.py`` under ``root`` (``METRIC_NAMES`` and
    ``PORT_METRIC_NAMES``); empty sets when absent."""
    path = os.path.join(root or ".", PACKAGE_NAME, "obs", "names.py")
    try:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
    except (OSError, SyntaxError):
        return set(), set()
    names, dynamic = set(), set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        targets = [t.id for t in node.targets
                   if isinstance(t, ast.Name)]
        if ("METRIC_NAMES" in targets or "PORT_METRIC_NAMES" in targets) \
                and isinstance(node.value, ast.Dict):
            names |= {k.value for k in node.value.keys
                      if isinstance(k, ast.Constant)
                      and isinstance(k.value, str)}
        if "BUDGET_COUNTERS" in targets:
            call = node.value
            args = (call.args if isinstance(call, ast.Call)
                    else [call])
            for arg in args:
                if isinstance(arg, (ast.Set, ast.List, ast.Tuple)):
                    dynamic = {e.value for e in arg.elts
                               if isinstance(e, ast.Constant)}
    return names, dynamic


def _manifest(project):
    key = "name-drift/manifest"
    if key not in project.state:
        if project.manifest_names is not None:
            static = set(project.manifest_names)
            dynamic = set(project.dynamic_names or ())
        else:
            static, dynamic = load_manifest(project.root)
        project.state[key] = (static, dynamic)
    return project.state[key]


def _known(name, static, dynamic):
    if name in static:
        return True
    return (name.startswith("putpu_") and name.endswith("_total")
            and name[len("putpu_"):-len("_total")] in dynamic)


@register
class NameDriftChecker:
    id = "metric-name"
    ids = ("metric-name-unknown", "metric-name-dynamic",
           "metric-name-unemitted", "metric-name-unknown-ref")

    def check(self, ctx):
        project = ctx.project
        if project is None:
            return []
        static, dynamic = _manifest(project)
        emitted = project.state.setdefault("name-drift/emitted", set())
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            callee = (dotted_name(node.func) or "").rsplit(".", 1)[-1]
            if callee not in _METRIC_CALLS:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                           str):
                name = arg.value
                if not name.startswith("putpu_"):
                    continue
                emitted.add(name)
                if not _known(name, static, dynamic):
                    out.append(ctx.finding(
                        node, "metric-name-unknown",
                        f"metric {name!r} is not declared in "
                        "obs/names.py METRIC_NAMES or PORT_METRIC_NAMES — "
                        "the manifest is the single source the gate/docs "
                        "check against"))
            elif isinstance(arg, ast.JoinedStr):
                head = arg.values[0] if arg.values else None
                if isinstance(head, ast.Constant) and str(
                        head.value).startswith("putpu_"):
                    emitted.add("<dynamic>")
                    out.append(ctx.finding(
                        node, "metric-name-dynamic",
                        "dynamically formatted putpu_* metric name — "
                        "the checker cannot verify it against the "
                        "manifest; enumerate the possible names in "
                        "obs/names.py and waive this one seam"))
        return out

    # -- cross-file coverage -------------------------------------------------

    def finalize(self, project):
        static, dynamic = _manifest(project)
        if not static and project.manifest_names is None:
            return []  # no manifest in scope (fixture runs)
        emitted = project.state.get("name-drift/emitted", set())
        dynamic_metrics = {f"putpu_{s}_total" for s in dynamic}
        out = []
        # the every-manifest-name-is-emitted direction is only sound on
        # a full-tree scan: require every emitting layer in the scan
        layers = {(PACKAGE_NAME + "/" + sub) for sub in
                  ("obs/", "parallel/", "pipeline/", "faults/", "io/")}
        scanned_pkg = all(any(p.startswith(layer) for p in project.files)
                          for layer in layers)
        if scanned_pkg:
            # direction 1: every manifest name is emitted somewhere
            for name in sorted(static):
                if name not in emitted and name not in dynamic_metrics:
                    out.append(self._proj_finding(
                        project, "metric-name-unemitted",
                        f"manifest declares {name!r} but no scanned "
                        "file emits it — stale entry or renamed metric"))
        # direction 2: docs/baseline references resolve
        for path, line, name in self._references(project):
            if name in _PROSE_ALLOWED:
                continue
            if not _known(name, static, dynamic):
                out.append(
                    type(self)._ref_finding(path, line, name))
        return out

    def _proj_finding(self, project, checker, message):
        from .core import Finding

        return Finding(path=PACKAGE_NAME + "/obs/names.py", line=1,
                       col=0, checker=checker, message=message)

    @staticmethod
    def _ref_finding(path, line, name):
        from .core import Finding

        return Finding(
            path=path, line=line, col=0, checker="metric-name-unknown-ref",
            message=f"{name!r} referenced here is not declared in "
                    "obs/names.py — the doc/baseline names a series "
                    "nothing emits")

    def _references(self, project):
        root = project.root
        if not root or project.manifest_names is not None:
            return
        targets = []
        for entry in _REFERENCE_GLOBS:
            path = os.path.join(root, entry)
            if os.path.isfile(path):
                targets.append(path)
            elif os.path.isdir(path):
                for name in sorted(os.listdir(path)):
                    if name.endswith((".md", ".jsonl")):
                        targets.append(os.path.join(path, name))
        for path in targets:
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            try:
                with open(path, encoding="utf-8") as fh:
                    for lineno, text in enumerate(fh, 1):
                        for m in _NAME_RE.finditer(text):
                            yield rel, lineno, m.group(0)
            except OSError:
                continue
