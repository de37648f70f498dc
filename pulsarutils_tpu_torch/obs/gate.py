"""Perf-regression gate: compare a fresh bench snapshot to a baseline.

The port of the JAX package's module, with its verdicts.  A bench
snapshot is one JSON record per config (``{"config", "value", "unit",
...}``) after a ``{"schema_version": N, ...}`` header line, plus a final
metrics-registry line; a **gate baseline** is simply a committed
snapshot of that file (``BENCH_GATE_cpu.jsonl``).  The comparison here
is deliberately narrow and direction-aware:

* each config's headline ``value`` is compared against the baseline's,
  with a per-config relative tolerance (CPU shared-runner jitter is
  real: the default tolerance is generous — the gate exists to catch
  regressions in kind, 2x-10x cliffs, not 5% noise);
* direction comes from the record's ``unit``: throughput units
  (``.../sec``) must not drop, latency units (``s/chunk``, ``s (wall``)
  must not grow, and counter units (``trips saved``) must not drop;
* a config present in the baseline but missing (or errored) in the
  fresh snapshot is itself a failure — a bench that stops running is a
  regression, not a skip.

:mod:`pulsarutils_tpu_torch.cli.gate_main` is the CLI; this module is
imported by tests so the decision logic is unit-testable without running
a suite.  :data:`SCHEMA_VERSION` is the port's one home of the snapshot
and ``BUDGET_JSON`` footer version (the JAX package's, so one parser
reads both packages' files).
"""

from __future__ import annotations

import json

__all__ = ["DEFAULT_REL_TOL", "LANE_KEYS", "SCHEMA_VERSION",
           "load_header", "load_snapshot", "header_mismatch",
           "lower_is_better", "compare", "format_report",
           "check_lint_report", "unknown_budget_counters"]

#: snapshot/footer schema version.  Written as the first line of every
#: ``--metrics-out`` snapshot (``{"schema_version": N}``) and embedded
#: in the ``BUDGET_JSON`` footer; bumped whenever a record's meaning
#: changes.  The gate REJECTS a snapshot with a missing or mismatched
#: version instead of silently comparing incompatible records — a
#: schema drift must fail loudly, not pass as a 100%-ratio no-op.
#: v2: BUDGET_JSON grew the ``chunk_wall_s`` p50/p95/p99 block.
#: v3: the snapshot header grew the ``backend`` and ``precision_policy``
#: lane stamps (walls are only comparable within one lane).
SCHEMA_VERSION = 3

#: header keys that define a snapshot's **bench lane**.  Walls measured
#: on different backends, or under different accumulation-precision
#: policies (``PUTPU_PRECISION``), are measurements of different
#: machines/different math — the gate refuses to compare across lanes
#: instead of laundering a backend swap through a generous tolerance.
LANE_KEYS = ("backend", "precision_policy")

#: default relative tolerance — CPU wall-clock on shared runners jitters
#: by tens of percent; the gate targets step regressions (2x+), so a
#: miss must exceed baseline by 60% (latency) / fall below 40% of it
#: (throughput) before failing
DEFAULT_REL_TOL = 0.6

#: unit prefixes meaning "smaller is better"
_LATENCY_PREFIXES = ("s/", "s (", "seconds")


def lower_is_better(unit):
    """Direction from the record's unit string."""
    unit = (unit or "").strip().lower()
    return unit.startswith(_LATENCY_PREFIXES)


def load_header(path):
    """The snapshot's leading ``schema_version`` header line, as a dict.

    Returns ``{}`` when the first non-empty line is not a header (the
    header-less artifact shape) — lane fields then read as absent, which
    :func:`header_mismatch` treats as "undeclared", not as a clash.
    """
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                return {}
            if (isinstance(rec, dict) and "schema_version" in rec
                    and "config" not in rec):
                return rec
            return {}
    return {}


def header_mismatch(baseline_header, fresh_header):
    """``None`` when the two snapshots share a bench lane, else a
    human-readable refusal.

    A lane key (:data:`LANE_KEYS`) clashes only when **both** headers
    declare it and the values differ — a pre-lane snapshot that never
    stamped ``backend``/``precision_policy`` still gates (ad-hoc
    tooling over old artifacts), but two stamped snapshots from
    different backends or precision policies must never have their
    walls compared as if they measured the same thing.
    """
    for key in LANE_KEYS:
        base = baseline_header.get(key)
        fresh = fresh_header.get(key)
        if base is not None and fresh is not None and base != fresh:
            return (f"{key} mismatch: baseline is {base!r}, fresh "
                    f"snapshot is {fresh!r} — each (backend, precision "
                    "policy) lane gates against its own "
                    "BENCH_GATE_<backend>.jsonl baseline; regenerate "
                    "one for this lane instead of comparing across")
    return None


def load_snapshot(path, expect_version=None):
    """Parse a ``--metrics-out`` snapshot (JSON lines) into
    ``{config_number: record}``.  Error records (``{"config": n,
    "error": ...}``) are kept — :func:`compare` fails them explicitly.
    Lines without a ``config`` key (the ``schema_version`` header, the
    metrics-registry tail) are not config records.

    ``expect_version`` (the gate CLI passes :data:`SCHEMA_VERSION`)
    enforces the snapshot schema: a missing or mismatched
    ``schema_version`` header raises ``ValueError`` instead of letting
    incompatible records be compared as if they agreed."""
    records = {}
    version = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if not isinstance(rec, dict):
                continue
            if "schema_version" in rec and "config" not in rec:
                version = rec["schema_version"]
            if "config" in rec:
                records[int(rec["config"])] = rec
    if expect_version is not None and version != expect_version:
        raise ValueError(
            f"snapshot {path}: schema_version is {version!r}, expected "
            f"{expect_version!r} — regenerate it with the current "
            "bench's --metrics-out (silently comparing across "
            "schema versions is exactly what the gate must not do)")
    return records


def compare(baseline, fresh, rel_tol=DEFAULT_REL_TOL, per_config_tol=None,
            configs=None):
    """Compare snapshots; returns ``(ok, rows)``.

    ``baseline``/``fresh``: ``{config: record}`` as from
    :func:`load_snapshot`.  ``configs`` restricts the comparison (default:
    every config the baseline holds).  ``per_config_tol`` maps config
    number → relative tolerance, overriding ``rel_tol``.

    Each row: ``{"config", "unit", "baseline", "fresh", "ratio",
    "tolerance", "lower_is_better", "status", "detail"}`` with status
    ``ok`` / ``regressed`` / ``missing`` / ``error``.
    """
    per_config_tol = per_config_tol or {}
    rows = []
    ok = True
    for cfg in sorted(configs if configs is not None else baseline):
        cfg = int(cfg)
        base = baseline.get(cfg)
        tol = float(per_config_tol.get(cfg, rel_tol))
        row = {"config": cfg, "tolerance": tol, "baseline": None,
               "fresh": None, "ratio": None, "unit": None,
               "lower_is_better": None, "status": "ok", "detail": ""}
        rows.append(row)
        if base is None or "value" not in base:
            row["status"] = "error"
            row["detail"] = "baseline has no value for this config"
            ok = False
            continue
        row["unit"] = base.get("unit")
        row["baseline"] = float(base["value"])
        lib = lower_is_better(base.get("unit"))
        row["lower_is_better"] = lib
        rec = fresh.get(cfg)
        if rec is None:
            row["status"] = "missing"
            row["detail"] = "config absent from fresh snapshot"
            ok = False
            continue
        if "error" in rec or "value" not in rec:
            row["status"] = "error"
            row["detail"] = str(rec.get("error", "record has no value"))
            ok = False
            continue
        row["fresh"] = float(rec["value"])
        if row["baseline"] == 0:
            row["ratio"] = None  # nothing sane to normalise by
            continue
        ratio = row["fresh"] / row["baseline"]
        row["ratio"] = round(ratio, 4)
        if lib:
            regressed = ratio > 1.0 + tol
        else:
            regressed = ratio < 1.0 - tol
        if regressed:
            row["status"] = "regressed"
            row["detail"] = (f"{'grew' if lib else 'fell'} to "
                             f"{100 * ratio:.0f}% of baseline "
                             f"(tolerance {100 * tol:.0f}%)")
            ok = False
    return ok, rows


def check_lint_report(path):
    """``(ok, detail)`` for a ``putpu-lint --out`` JSON report (the
    port's :mod:`~pulsarutils_tpu_torch.cli.lint_main`).

    The perf gate refuses to PASS on a missing, unreadable or non-clean
    report: the static invariants (device-trip attribution, retrace
    hazards, lock discipline, metric-name sync, ...) gate the same way
    perf does — a convention regression is a regression."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except FileNotFoundError:
        return False, (f"lint report {path} missing — generate it with "
                       "`python -m pulsarutils_tpu_torch.cli.lint_main "
                       f"--out {path}`")
    except (OSError, json.JSONDecodeError) as exc:
        return False, f"lint report {path} unreadable: {exc}"
    if doc.get("tool") != "putpu-lint":
        return False, (f"{path} is not a putpu-lint report "
                       f"(tool={doc.get('tool')!r})")
    if doc.get("clean"):
        return True, (f"clean ({doc.get('files')} files, "
                      f"{doc.get('waived')} waived, "
                      f"{doc.get('baselined')} baselined)")
    return False, (f"{doc.get('new')} new lint finding(s) — run "
                   "`python -m pulsarutils_tpu_torch.cli.lint_main` for "
                   "locations")


def unknown_budget_counters(records):
    """Budget-counter keys in snapshot records whose mirrored series
    (``putpu_<key>_total``) the port's :mod:`.names` manifest does not
    declare (``BUDGET_COUNTERS``, ``METRIC_NAMES``,
    ``PORT_METRIC_NAMES``) — a renamed counter whose manifest row was
    left behind would otherwise drift out of the doc/baseline coverage
    guarantee silently."""
    from .names import budget_counter_metric, is_known

    bad = set()
    for rec in records.values():
        for key in (rec.get("counters") or {}):
            if not is_known(budget_counter_metric(key)):
                bad.add(key)
    return sorted(bad)


def format_report(rows):
    """Human-readable gate report (one line per config)."""
    lines = ["perf gate:"]
    for r in rows:
        direction = ("lower" if r["lower_is_better"]
                     else "higher" if r["lower_is_better"] is not None
                     else "?")
        lines.append(
            f"  config {r['config']:>2}  {r['status']:<10}"
            f" baseline={r['baseline']} fresh={r['fresh']}"
            f" ratio={r['ratio']} ({direction}-is-better,"
            f" tol {100 * r['tolerance']:.0f}%)"
            + (f"  {r['detail']}" if r["detail"] else ""))
    return "\n".join(lines)
