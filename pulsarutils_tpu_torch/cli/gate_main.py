"""Perf-regression gate CLI: a bench snapshot against a committed baseline.

The ``--snapshot`` mode of the JAX package's ``tools/perf_gate.py``, on
the port's gate (:mod:`..obs.gate`) and lint (:mod:`..analysis`)::

    python -m pulsarutils_tpu_torch.cli.gate_main --snapshot fresh.jsonl \
        [--baseline BENCH_GATE_cpu.jsonl] [--backend cpu] \
        [--configs 1 7 ...] [--tolerance 0.6] [--tol 7=0.8] \
        [--lint-report lint.json | --skip-lint]

It compares the snapshot's per-config headline values with the
baseline's, direction-aware by unit, under the JAX gate's default and
per-config tolerances; refuses (exit 2) a snapshot or baseline of
another schema version or of another bench lane (backend, precision
policy); fails on a budget-counter name the port's manifest does not
declare; and refuses to PASS unless the port's lint is clean (run
in-process, or read from ``--lint-report``).  It runs no bench suite:
the snapshot is given.

Exit codes: 0 = within tolerance, 1 = regression/missing/errored
config or lint failure, 2 = usage/baseline problems.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..obs import gate

__all__ = ["DEFAULT_CONFIGS", "DEFAULT_PER_CONFIG_TOL", "main",
           "run_lint_inprocess"]

#: the JAX gate's default configs and per-config tolerances, so the two
#: gates give one verdict on one snapshot: the raw walls (1, 7) and the
#: quotients of two walls (12-24) take wide bounds, the canary's recall
#: (10) a tight one (losing more than one of 13 canaries fails)
DEFAULT_CONFIGS = (1, 7, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
                   22, 23, 24)
DEFAULT_PER_CONFIG_TOL = {1: 0.75, 7: 1.2, 10: 0.08, 12: 0.75, 13: 0.75,
                          14: 0.75, 15: 0.75, 16: 0.75, 17: 0.75,
                          18: 0.75, 19: 0.75, 20: 0.75, 21: 0.75,
                          22: 0.75, 23: 0.75, 24: 0.75}


def _repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def run_lint_inprocess():
    """The port's lint over its package, in-process; ``(ok, detail)``."""
    from ..analysis.cli import run_lint

    project = run_lint()
    rep = project.report()
    if rep["clean"]:
        return True, (f"clean ({rep['files']} files, {rep['waived']} "
                      f"waived, {rep['baselined']} baselined)")
    locs = [f"{f.location()}: {f.checker}"
            for f in project.new_findings()]
    shown = "; ".join(locs[:5]) + (" ..." if len(locs) > 5 else "")
    return False, f"{rep['new']} new finding(s): {shown}"


def _parse_tol(items):
    out = {}
    for item in items or ():
        cfg, _, tol = item.partition("=")
        if not tol:
            raise SystemExit(f"--tol {item!r}: expected CONFIG=REL_TOL")
        out[int(cfg)] = float(tol)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="gate_main",
        description="compare a bench snapshot against a committed "
                    "baseline; exit 1 on regression")
    parser.add_argument("--snapshot", required=True,
                        help="the fresh snapshot (JSON lines)")
    parser.add_argument("--baseline", default=None,
                        help="committed snapshot; default: the "
                             "--backend lane's BENCH_GATE_<backend>"
                             ".jsonl at the repo root")
    parser.add_argument("--backend", default="cpu", metavar="NAME",
                        help="bench lane to gate (default cpu); must "
                             "match the baseline's stamped backend")
    parser.add_argument("--configs", type=int, nargs="*",
                        default=list(DEFAULT_CONFIGS),
                        help="configs to compare (default: "
                             f"{' '.join(map(str, DEFAULT_CONFIGS))})")
    parser.add_argument("--tolerance", type=float,
                        default=gate.DEFAULT_REL_TOL,
                        help="default relative tolerance (default "
                             f"{gate.DEFAULT_REL_TOL})")
    parser.add_argument("--tol", action="append", metavar="CONFIG=REL",
                        help="per-config tolerance override, repeatable")
    parser.add_argument("--lint-report", metavar="PATH", default=None,
                        help="a lint_main --out JSON report to check "
                             "(default: run the lint in-process)")
    parser.add_argument("--skip-lint", action="store_true",
                        help="gate on perf only (NOT for CI: the lint "
                             "gate is part of PASS)")
    opts = parser.parse_args(argv)
    if opts.baseline is None:
        opts.baseline = os.path.join(_repo_root(),
                                     f"BENCH_GATE_{opts.backend}.jsonl")

    if not os.path.exists(opts.baseline):
        print(f"gate: baseline {opts.baseline} not found", file=sys.stderr)
        return 2
    try:
        baseline = gate.load_snapshot(opts.baseline,
                                      expect_version=gate.SCHEMA_VERSION)
        fresh = gate.load_snapshot(opts.snapshot,
                                   expect_version=gate.SCHEMA_VERSION)
    except (OSError, ValueError) as exc:
        print(f"gate: {exc}", file=sys.stderr)
        return 2
    base_hdr = gate.load_header(opts.baseline)
    if base_hdr.get("backend") not in (None, opts.backend):
        print(f"gate: baseline {opts.baseline} is stamped for backend "
              f"{base_hdr['backend']!r} but the gate was asked for "
              f"--backend {opts.backend}", file=sys.stderr)
        return 2
    # the lane rule: walls of different backends or precision policies
    # are never compared
    mismatch = gate.header_mismatch(base_hdr, gate.load_header(opts.snapshot))
    if mismatch:
        print(f"gate: {mismatch}", file=sys.stderr)
        return 2

    per_config = dict(DEFAULT_PER_CONFIG_TOL)
    per_config.update(_parse_tol(opts.tol))
    ok, rows = gate.compare(baseline, fresh, rel_tol=opts.tolerance,
                            per_config_tol=per_config, configs=opts.configs)
    print(gate.format_report(rows))

    drifted = gate.unknown_budget_counters({**baseline, **fresh})
    if drifted:
        print(f"gate: snapshot counter name(s) not declared in "
              f"obs/names.py: {', '.join(drifted)}")
        ok = False

    if opts.skip_lint:
        lint_ok, detail = True, "skipped (--skip-lint)"
    elif opts.lint_report:
        lint_ok, detail = gate.check_lint_report(opts.lint_report)
    else:
        lint_ok, detail = run_lint_inprocess()
    print(f"gate: lint {'ok' if lint_ok else 'FAIL'} — {detail}")

    if ok and lint_ok:
        print("gate: PASS")
        return 0
    print("gate: FAIL (regression, missing config or lint — see above)")
    return 1


if __name__ == "__main__":
    sys.exit(main())
