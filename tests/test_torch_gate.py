"""The port's perf gate (``pulsarutils_tpu_torch.obs.gate`` and
``cli.gate_main``) against the JAX package's (``pulsarutils_tpu.obs.gate``
and ``tools/perf_gate.py --snapshot``): the same verdicts and rows on the
committed ``BENCH_GATE_cpu.jsonl`` (read only) against itself, and on
doctored, unversioned and cross-lane copies of it in ``tmp_path``."""

import json
import os
import subprocess
import sys

import pytest

from pulsarutils_tpu.obs import gate as jgate
from pulsarutils_tpu_torch.cli import gate_main
from pulsarutils_tpu_torch.obs import gate as tgate
from pulsarutils_tpu_torch.utils import logging_utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "BENCH_GATE_cpu.jsonl")
JAX_TOOL = os.path.join(REPO, "tools", "perf_gate.py")


def _rec(cfg, value, unit):
    return {"config": cfg, "value": value, "unit": unit}


def _jax_cli_defaults():
    """The JAX CLI's default configs and per-config tolerances, read
    from its source (the tool is a script, not a module of the
    package)."""
    import ast

    with open(JAX_TOOL) as f:
        tree = ast.parse(f.read())
    found = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if getattr(t, "id", None) in ("DEFAULT_CONFIGS",
                                              "DEFAULT_PER_CONFIG_TOL"):
                    found[t.id] = ast.literal_eval(node.value)
    return found["DEFAULT_CONFIGS"], found["DEFAULT_PER_CONFIG_TOL"]


def test_constants_equal_the_jax_gate():
    assert tgate.SCHEMA_VERSION == jgate.SCHEMA_VERSION
    assert tgate.LANE_KEYS == jgate.LANE_KEYS
    assert tgate.DEFAULT_REL_TOL == jgate.DEFAULT_REL_TOL
    assert sorted(tgate.__all__) == sorted(jgate.__all__)
    assert (gate_main.DEFAULT_CONFIGS, gate_main.DEFAULT_PER_CONFIG_TOL) \
        == _jax_cli_defaults()


def test_schema_version_has_one_home():
    # the budget footer and the metrics snapshot read the gate's constant
    assert logging_utils.SCHEMA_VERSION is tgate.SCHEMA_VERSION
    acct = logging_utils.BudgetAccountant()
    with acct.chunk(0):
        pass
    j = acct.to_json()
    assert list(j)[0] == "schema_version"
    assert j["schema_version"] == tgate.SCHEMA_VERSION
    src = open(os.path.join(REPO, "pulsarutils_tpu_torch", "utils",
                            "logging_utils.py")).read()
    assert "SCHEMA_VERSION = " not in src


@pytest.mark.parametrize("unit", [
    "DM-trials/sec", "s/chunk (wall, budget-attributed)", "s (wall)",
    "seconds", "canary recall (fraction recovered)", "x (a/b wall)", "",
    None])
def test_lower_is_better_equals_jax(unit):
    assert tgate.lower_is_better(unit) == jgate.lower_is_better(unit)


def _both_compare(base, fresh, **kw):
    t = tgate.compare(base, fresh, **kw)
    j = jgate.compare(base, fresh, **kw)
    assert t == j
    return t


BASE = {1: _rec(1, 100.0, "DM-trials/sec"),
        7: _rec(7, 2.0, "s/chunk (wall, budget-attributed)")}


@pytest.mark.parametrize("fresh,kw,ok", [
    ({1: _rec(1, 90.0, "DM-trials/sec"), 7: _rec(7, 2.5, "s/chunk")},
     {}, True),
    ({1: _rec(1, 10.0, "DM-trials/sec"), 7: _rec(7, 2.0, "s/chunk")},
     {}, False),
    ({1: _rec(1, 100.0, "DM-trials/sec"), 7: _rec(7, 20.0, "s/chunk")},
     {}, False),
    ({1: _rec(1, 100.0, "DM-trials/sec")}, {}, False),
    ({1: _rec(1, 100.0, "DM-trials/sec"),
      7: {"config": 7, "error": "boom"}}, {}, False),
    ({1: _rec(1, 1000.0, "DM-trials/sec"), 7: _rec(7, 0.1, "s/chunk")},
     {}, True),
    ({1: _rec(1, 90.0, "DM-trials/sec"), 7: _rec(7, 2.0, "s/chunk")},
     {"per_config_tol": {1: 0.05}}, False),
    ({1: _rec(1, 90.0, "DM-trials/sec"), 7: _rec(7, 2.0, "s/chunk")},
     {"configs": [1]}, True),
])
def test_compare_rows_equal_jax(fresh, kw, ok):
    got_ok, rows = _both_compare(BASE, fresh, **kw)
    assert got_ok is ok
    assert tgate.format_report(rows) == jgate.format_report(rows)


def test_committed_baseline_against_itself():
    t_base = tgate.load_snapshot(BASELINE,
                                 expect_version=tgate.SCHEMA_VERSION)
    j_base = jgate.load_snapshot(BASELINE,
                                 expect_version=jgate.SCHEMA_VERSION)
    assert t_base == j_base
    assert tgate.load_header(BASELINE) == jgate.load_header(BASELINE)
    ok, rows = _both_compare(t_base, j_base,
                             per_config_tol=gate_main.DEFAULT_PER_CONFIG_TOL,
                             configs=gate_main.DEFAULT_CONFIGS)
    assert ok and all(r["status"] == "ok" for r in rows)
    assert tgate.unknown_budget_counters(t_base) \
        == jgate.unknown_budget_counters(j_base) == []


@pytest.mark.parametrize("records,expected", [
    ({"7": {"counters": {"dispatches": 3, "not_declared": 1}}},
     ["not_declared"]),
    ({"7": {"counters": {"dispatches": 3, "readbacks": 1}}}, []),
    ({"7": {}}, []),
])
def test_unknown_budget_counters_equal_jax(records, expected):
    assert tgate.unknown_budget_counters(records) == expected
    assert jgate.unknown_budget_counters(records) == expected


def _doctor(path, how):
    """A copy of the committed baseline, changed by ``how``."""
    hdr = jgate.load_header(BASELINE)
    records = jgate.load_snapshot(BASELINE)
    lines = [] if how == "unversioned" else [dict(hdr)]
    if how == "drifted":
        lines[0]["schema_version"] = jgate.SCHEMA_VERSION + 1
    if how.startswith("lane:"):
        key, val = how[5:].split("=")
        lines[0][key] = val
    for cfg, rec in records.items():
        rec = dict(rec)
        if how == "slower":
            rec["value"] = rec["value"] * (
                10.0 if jgate.lower_is_better(rec.get("unit")) else 0.1)
        if how == "missing" and cfg == 7:
            continue
        if how == "errored" and cfg == 10:
            rec = {"config": cfg, "error": "boom"}
        if how == "slightly" and cfg == 1:
            rec["value"] = rec["value"] * 0.9
        lines.append(rec)
    with open(path, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    return str(path)


@pytest.mark.parametrize("how", ["slower", "missing", "errored",
                                 "slightly"])
def test_doctored_snapshot_rows_equal_jax(tmp_path, how):
    path = _doctor(tmp_path / f"{how}.jsonl", how)
    base = jgate.load_snapshot(BASELINE)
    fresh_t = tgate.load_snapshot(path, expect_version=tgate.SCHEMA_VERSION)
    fresh_j = jgate.load_snapshot(path, expect_version=jgate.SCHEMA_VERSION)
    assert fresh_t == fresh_j
    ok, rows = _both_compare(base, fresh_t,
                             per_config_tol=gate_main.DEFAULT_PER_CONFIG_TOL,
                             configs=gate_main.DEFAULT_CONFIGS)
    assert ok is (how == "slightly")
    statuses = {r["status"] for r in rows}
    assert statuses == {"slightly": {"ok"}, "slower": {"regressed"},
                        "missing": {"ok", "missing"},
                        "errored": {"ok", "error"}}[how]


@pytest.mark.parametrize("how", ["unversioned", "drifted"])
def test_schema_refusal_equals_jax(tmp_path, how):
    path = _doctor(tmp_path / f"{how}.jsonl", how)
    for mod in (tgate, jgate):
        with pytest.raises(ValueError, match="schema_version"):
            mod.load_snapshot(path, expect_version=mod.SCHEMA_VERSION)
        assert mod.load_snapshot(path)  # the lenient load still reads it


@pytest.mark.parametrize("base,fresh", [
    ({}, {}), ({"backend": "cpu"}, {}),
    ({"backend": "cpu"}, {"backend": "cpu"}),
    ({"backend": "cpu"}, {"backend": "tpu"}),
    ({"backend": "cpu", "precision_policy": "f32"},
     {"backend": "cpu", "precision_policy": "f32_compensated"}),
])
def test_header_mismatch_equals_jax(base, fresh):
    t = tgate.header_mismatch(base, fresh)
    j = jgate.header_mismatch(base, fresh)
    assert (t is None) == (j is None)
    if t is not None:
        assert t.split(":")[0] == j.split(":")[0]


def _run(cmd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True)


def _port_cli(*args):
    return _run([sys.executable, "-m", "pulsarutils_tpu_torch.cli.gate_main",
                 *args])


def _jax_cli(*args):
    return _run([sys.executable, JAX_TOOL, *args])


@pytest.mark.parametrize("how,rc", [
    (None, 0),
    ("slower", 1),
    ("missing", 1),
    ("unversioned", 2),
    ("lane:backend=tpu", 2),
    ("lane:precision_policy=bf16_operand_f32_accum", 2),
])
def test_cli_exit_codes_equal_jax(tmp_path, how, rc):
    snap = BASELINE if how is None else _doctor(
        tmp_path / "snap.jsonl", how)
    port = _port_cli("--snapshot", snap)
    jax = _jax_cli("--snapshot", snap)
    assert port.returncode == jax.returncode == rc, (
        port.stdout + port.stderr, jax.stdout + jax.stderr)
    if rc == 0:
        assert "gate: PASS" in port.stdout
        assert "lint ok" in port.stdout
    if rc == 1:
        # the same report rows, line for line
        rows_p = [ln for ln in port.stdout.splitlines()
                  if ln.startswith("  config")]
        rows_j = [ln for ln in jax.stdout.splitlines()
                  if ln.startswith("  config")]
        assert rows_p == rows_j and rows_p
    if how and how.startswith("lane:"):
        key = how[5:].split("=")[0]
        assert f"{key} mismatch" in port.stderr


def test_cli_lint_report_and_backend_refusals(tmp_path):
    report = tmp_path / "lint.json"
    report.write_text(json.dumps({"tool": "putpu-lint", "clean": False,
                                  "new": 2}))
    res = _port_cli("--snapshot", BASELINE, "--lint-report", str(report))
    assert res.returncode == 1 and "lint FAIL" in res.stdout
    report.write_text(json.dumps({"tool": "putpu-lint", "clean": True,
                                  "files": 1, "waived": 0,
                                  "baselined": 0}))
    res = _port_cli("--snapshot", BASELINE, "--lint-report", str(report))
    assert res.returncode == 0, res.stdout + res.stderr
    # an absent lane baseline, and a baseline of another lane
    res = _port_cli("--backend", "tpu", "--snapshot", BASELINE)
    assert res.returncode == 2 and "BENCH_GATE_tpu.jsonl" in res.stderr
    res = _port_cli("--backend", "tpu", "--baseline", BASELINE,
                    "--snapshot", BASELINE)
    assert res.returncode == 2 and "stamped for backend" in res.stderr


def test_gate_main_in_process(capsys):
    assert gate_main.main(["--snapshot", BASELINE]) == 0
    out = capsys.readouterr().out
    assert out.count("  config") == len(gate_main.DEFAULT_CONFIGS)
