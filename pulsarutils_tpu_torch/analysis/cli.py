"""putpu-lint CLI for the port: run the checkers, report, gate.

Usage (the committed-tree invariant the test suite pins)::

    python -m pulsarutils_tpu_torch.cli.lint_main      # exit 0 = clean
    python -m pulsarutils_tpu_torch.cli.lint_main --format json \
        --out LINT_REPORT.json
    python -m pulsarutils_tpu_torch.cli.lint_main --update-baseline

Exit codes: 0 clean (no new findings), 1 new findings, 2 usage errors.
"New" means not inline-waived and not in the committed baseline
(``.putpu-torch-lint-baseline.json`` at the project root,
``--no-baseline`` to see everything).  The perf gate
(:mod:`pulsarutils_tpu_torch.cli.gate_main`) refuses to PASS unless
this exits clean.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import baseline as _baseline
from .core import (PACKAGE_NAME, _default_root, all_finding_ids,
                   lint_paths, registered_checkers)

BASELINE_NAME = ".putpu-torch-lint-baseline.json"

__all__ = ["main", "run_lint", "default_root", "BASELINE_NAME"]


def default_root():
    """The repo checkout this installed/checked-out package lives in."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return here


def run_lint(paths=None, root=None, select=None, use_baseline=True,
             baseline_path=None):
    """Programmatic entry (perf_gate, bench_suite, tests): lint and
    return the :class:`~.core.LintProject`."""
    # root follows the SCANNED tree, not this package's checkout — under
    # pip install (or linting a different project) the baseline and the
    # names.py manifest must resolve against the tree being linted
    if paths:
        paths = list(paths)
        root = root or _default_root(paths)
    else:
        root = root or default_root()
        paths = [os.path.join(root, PACKAGE_NAME)]
    baseline = None
    if use_baseline:
        baseline = baseline_path or os.path.join(root, BASELINE_NAME)
    return lint_paths(paths, root=root, select=select, baseline=baseline)


def _format_text(project, show_all=False):
    lines = []
    for f in sorted(project.findings,
                    key=lambda f: (f.path, f.line, f.checker)):
        if not show_all and not f.new:
            continue
        tag = ("" if f.new
               else " [waived]" if f.waived else " [baselined]")
        lines.append(f"{f.location()}: {f.checker}: {f.message}{tag}")
    rep = project.report()
    lines.append(f"putpu-lint: {rep['files']} files, "
                 f"{rep['new']} new finding(s), {rep['waived']} waived, "
                 f"{rep['baselined']} baselined "
                 f"({len(rep['checkers'])} checkers)")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="putpu-lint",
        description="project-specific AST invariant checker for "
                    f"{PACKAGE_NAME}: device-trip attribution, lock "
                    "discipline, metric-name drift, broad excepts, "
                    "float64 leaks")
    parser.add_argument("paths", nargs="*",
                        help=f"files/directories (default: the "
                             f"{PACKAGE_NAME}/ package of this "
                             "checkout)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--out", metavar="PATH",
                        help="also write the JSON run report to PATH "
                             "(the artifact the perf gate checks)")
    parser.add_argument("--baseline", metavar="PATH", default=None,
                        help=f"baseline file (default <root>/"
                             f"{BASELINE_NAME})")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline (show grandfathered "
                             "findings as new)")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline from current "
                             "unwaived findings, then exit 0")
    parser.add_argument("--select", nargs="*", metavar="ID",
                        help="run only these checker/finding ids")
    parser.add_argument("--show-all", action="store_true",
                        help="text output includes waived/baselined "
                             "findings")
    parser.add_argument("--list-checkers", action="store_true")
    opts = parser.parse_args(argv)

    if opts.list_checkers:
        for checker in sorted(registered_checkers(), key=lambda c: c.id):
            print(f"{checker.id}: {', '.join(checker.ids)}")
        print(f"finding ids: {', '.join(all_finding_ids())}")
        return 0

    if opts.paths:
        paths = opts.paths
        root = _default_root(paths)
    else:
        root = default_root()
        paths = [os.path.join(root, PACKAGE_NAME)]
    for p in paths:
        if not os.path.exists(p):
            print(f"putpu-lint: no such path: {p}", file=sys.stderr)
            return 2
    baseline_path = opts.baseline or os.path.join(root, BASELINE_NAME)

    project = run_lint(paths=paths, root=root, select=opts.select,
                       use_baseline=not (opts.no_baseline
                                         or opts.update_baseline),
                       baseline_path=baseline_path)

    if opts.update_baseline:
        if opts.select:
            print("putpu-lint: --update-baseline with --select would "
                  "drop every grandfathered entry from the unselected "
                  "checkers — run it unselected", file=sys.stderr)
            return 2
        # a partial-path run must not drop entries for unscanned files
        keep = _baseline.unscanned_entries(baseline_path,
                                           project.sources)
        n = _baseline.save(baseline_path, project.findings,
                           project.sources, keep=keep)
        print(f"putpu-lint: baseline rewritten with {n} grandfathered "
              f"finding(s) -> {baseline_path}")
        return 0

    report = project.report()
    if opts.out:
        with open(opts.out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=1)
            fh.write("\n")
    if opts.format == "json":
        print(json.dumps(report, indent=1))
    else:
        print(_format_text(project, show_all=opts.show_all))
    return 0 if report["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
