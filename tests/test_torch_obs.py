"""The port's accounting layer on the CPU, held against the JAX package.

The names manifest, the metrics registry and its exporters, the budget
accountant and its ``BUDGET_JSON`` record (a frozen clock drives both
packages through one scripted sequence), the span tracer and the span
JSON both drivers write for one small file, the survey report's
markdown, the roofline work models (the bounds ``chip_smoke.py`` prints)
and their records at the kernel wrappers, the device trace, the memory
watermark and the CLI's flags.  Every test resets what it touched in the
port's process-wide registry, tracer and roofline state.
"""
import ast
import json
import logging
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pulsarutils_tpu.cli import search_main as jax_cli
from pulsarutils_tpu.obs import metrics as jax_metrics
from pulsarutils_tpu.obs import names as jax_names
from pulsarutils_tpu.obs import report as jax_report
from pulsarutils_tpu.obs import trace as jax_trace
from pulsarutils_tpu.pipeline.search_pipeline import \
    search_by_chunks as jax_search_by_chunks
from pulsarutils_tpu.utils import logging_utils as jax_logging

from pulsarutils_tpu_torch.cli import search_main
from pulsarutils_tpu_torch.io.sigproc import write_simulated_filterbank
from pulsarutils_tpu_torch.models.simulate import simulate_test_data
from pulsarutils_tpu_torch.obs import memory, metrics, names, report, roofline
from pulsarutils_tpu_torch.obs import trace
from pulsarutils_tpu_torch.ops.dedisperse_cuda import dedisperse_plane
from pulsarutils_tpu_torch.ops.score_cuda import score_plane
from pulsarutils_tpu_torch.pipeline.search_pipeline import search_by_chunks
from pulsarutils_tpu_torch.utils import logging_utils, nvcc

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SEARCH = dict(dmmin=100.0, dmmax=200.0, chunk_length=1.024,
              snr_threshold=6.0)


@pytest.fixture
def clean_state():
    """The port's process-wide observability state, reset after a test."""
    yield
    trace.stop_tracing()
    roofline.disable()
    roofline.reset()
    metrics.REGISTRY.reset()


@pytest.fixture(scope="module")
def pulse_file(tmp_path_factory):
    array, header = simulate_test_data(150.0, nsamples=16384, nchan=32,
                                       signal=10.0, noise=4.0, rng=7)
    path = tmp_path_factory.mktemp("obs") / "pulse.fil"
    write_simulated_filterbank(str(path), array + 20.0, header,
                               descending=True, nbits=8)
    return str(path)


# -- the names manifest ------------------------------------------------------

def test_names_manifest_equals_jax():
    assert names.METRIC_NAMES == jax_names.METRIC_NAMES
    # the port's own budget counters: the launches of B1 and B4, and the
    # beam sweeps run as the direct sweep
    launches = {"b1_launches", "b4_launches", "beam_direct"}
    assert names.BUDGET_COUNTERS == jax_names.BUDGET_COUNTERS | launches
    for name in launches:
        assert names.meaning(names.budget_counter_metric(name))
    for name in ("putpu_hits_total", "putpu_dispatches_total",
                 "putpu_nope_total", "other"):
        assert names.is_known(name) == jax_names.is_known(name)
        assert (names.budget_counter_metric(name)
                == jax_names.budget_counter_metric(name))


def _emitted_names():
    """Every ``putpu_*`` literal the port passes to a registry facade."""
    out = set()
    for path in (REPO / "pulsarutils_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and node.args[0].value.startswith("putpu_")
                    and getattr(node.func, "attr", getattr(
                        node.func, "id", "")) in ("counter", "gauge",
                                                  "histogram")):
                out.add((path.name, node.args[0].value))
    return sorted(out)


def test_every_emitted_name_is_declared():
    emitted = _emitted_names()
    assert len(emitted) > 40
    unknown = [(f, n) for f, n in emitted if not names.is_known(n)]
    assert not unknown


# -- the metrics registry ----------------------------------------------------

def _drive_registry(mod):
    """One sequence of operations on a fresh registry of ``mod``."""
    reg = mod.MetricsRegistry()
    reg.counter("putpu_esc_total", help="has \\ and\nnewline",
                reason='du"p\nli\\c').inc(2)
    reg.counter("putpu_hits_total").inc()
    reg.counter("putpu_hits_total").inc(4)
    reg.counter("putpu_oom_events_total", surface="chunk_search").inc()
    reg.counter("putpu_oom_events_total", surface="direct_sweep").inc(3)
    g = reg.gauge("putpu_device_bytes_peak")
    g.set(5.0)
    g.set_max(3.0)
    g.set_max(7.5)
    reg.gauge("putpu_canary_recall", beam="2").set(0.75)
    reg.gauge("putpu_chunks_per_s").add(1.25)
    h = reg.histogram("putpu_h", help="hist", edges=(0.5, 1.0), kernel="k")
    for v in (0.25, 2.0, 1.0):
        h.observe(v)
    h2 = reg.histogram("putpu_chunk_wall_seconds",
                       edges=(0.05, 0.1, 0.25, 0.5, 1.0))
    for v in (0.01, 0.07, 0.3, 9.0):
        h2.observe(v)
    return reg


def test_registry_text_and_jsonl_equal_jax(tmp_path):
    ours, theirs = _drive_registry(metrics), _drive_registry(jax_metrics)
    assert ours.prometheus_text() == theirs.prometheus_text()
    assert (ours.prometheus_text(manifest_help=True)
            == theirs.prometheus_text(manifest_help=True))
    assert ours.snapshot() == theirs.snapshot()
    for version in (None, 3):
        a, b = tmp_path / f"ours{version}", tmp_path / f"theirs{version}"
        assert (ours.write_jsonl(str(a), schema_version=version)
                == theirs.write_jsonl(str(b), schema_version=version))
        assert a.read_bytes() == b.read_bytes()
    ours.write_prometheus(str(tmp_path / "ours.prom"))
    theirs.write_prometheus(str(tmp_path / "theirs.prom"))
    assert ((tmp_path / "ours.prom").read_bytes()
            == (tmp_path / "theirs.prom").read_bytes())
    with pytest.raises(TypeError):
        ours.gauge("putpu_hits_total")
    with pytest.raises(ValueError):
        ours.counter("putpu_hits_total").inc(-1)


def test_registry_facades_warn_on_undeclared_names(caplog, clean_state):
    with caplog.at_level(logging.WARNING, logger="pulsarutils_tpu_torch"):
        metrics.counter("putpu_not_declared_anywhere_total").inc()
        metrics.counter("putpu_not_declared_anywhere_total").inc()
    assert sum("not declared" in r.getMessage()
               for r in caplog.records) == 1


# -- the budget accountant ---------------------------------------------------

def _scripted_budget(mod):
    """The JAX package's golden sequence, then a third chunk with a
    nested sub-bucket and async work, on a fresh accountant of ``mod``
    under a frozen clock (the caller patches ``time.perf_counter``)."""
    acct = mod.BudgetAccountant(rtt_s=0.015625)
    acct.begin_stream()
    for label in (0, 32768, 65536):
        with acct.chunk(label):
            with acct.bucket("read"):
                pass
            with acct.bucket("search"):
                with mod.budget_bucket("search/dispatch"):
                    pass
                mod.budget_count("dispatches")
                with mod.budget_bucket("search/readback"):
                    pass
                mod.budget_count("readbacks")
            mod.budget_count("readbacks")
            if label == 65536:
                with acct.bucket("persist"):
                    pass
                mod.budget_count("prefetch_uploads", 2)
    acct.add_async("persist", 0.25)
    acct.add_async("read_decode", 0.125)
    with acct.bucket("persist_drain"):
        pass
    return acct


@pytest.mark.parametrize("tracing", [False, True])
def test_budget_json_equals_jax(monkeypatch, clean_state, tracing):
    docs = []
    for mod, tr in ((logging_utils, trace), (jax_logging, jax_trace)):
        ticks = iter(1000.0 + 0.0625 * i for i in range(1, 1000))
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        if tracing:
            tr.start_tracing()
        try:
            acct = _scripted_budget(mod)
        finally:
            if tracing:
                tr.stop_tracing()
        monkeypatch.undo()
        docs.append((acct, acct.to_json(), acct.to_json(max_per_chunk=2)))
    (ours, j, j2), (theirs, jj, jj2) = docs
    assert set(j) == set(jj)
    assert json.dumps(j) == json.dumps(jj)
    assert json.dumps(j2) == json.dumps(jj2)
    assert j["unattributed_s"] == jj["unattributed_s"] > 0
    assert ours.totals == theirs.totals
    assert ours.async_totals == theirs.async_totals
    assert ours.trips() == theirs.trips() == 9
    assert ours.stage_seconds()["persist"] == (
        theirs.totals["persist"] + theirs.async_totals["persist"])


def test_budget_counters_mirror_into_the_registry(clean_state):
    acct = logging_utils.BudgetAccountant()
    with acct.chunk(0):
        logging_utils.budget_count("dispatches", 3)
    logging_utils.budget_count("dispatches")  # no chunk open: a no-op
    assert metrics.REGISTRY.counter("putpu_dispatches_total").value == 3
    assert metrics.REGISTRY.counter("putpu_chunks_total").value == 1
    snap = {m["name"]: m for m in metrics.REGISTRY.snapshot()}
    assert snap["putpu_chunk_wall_seconds"]["count"] == 1


def test_kernel_builds_after_the_first_chunk_are_retraces(monkeypatch,
                                                          clean_state):
    def build():
        with nvcc.COMPILES_LOCK:
            nvcc.COMPILES["count"] += 1
            nvcc.COMPILES["secs"] += 0.5

    acct = logging_utils.BudgetAccountant()
    acct.begin_stream()
    with acct.chunk(0):
        build()                      # a first use: no retrace
    with acct.chunk(1):
        pass
    with acct.chunk(2):
        build()
    assert acct.chunks[0]["counters"]["compiles"] == 1
    assert "retrace" not in acct.chunks[0]
    assert "compiles" not in acct.chunks[1]["counters"]
    assert acct.chunks[2]["retrace"] is True
    assert metrics.REGISTRY.counter("putpu_retraces_total").value == 1
    acct.begin_stream()              # a new stream: its first chunk may build
    with acct.chunk(3):
        build()
    assert "retrace" not in acct.chunks[3]


def test_measure_device_rtt_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU contract does not apply")
    assert logging_utils.measure_device_rtt() is None


# -- spans and the trace JSON ------------------------------------------------

def _span_names(doc):
    return {e["name"] for e in doc["traceEvents"] if e["ph"] in ("X", "b")}


def _schema(doc):
    return ({(e["ph"], tuple(sorted(k for k in e if k != "args")))
             for e in doc["traceEvents"]}, sorted(doc), sorted(doc["putpu"]))


def _traced_pair(pulse_file, tmp_path, **kw):
    """The port's and the JAX driver's trace JSON of one search of
    ``pulse_file`` each, with the loop knobs ``kw``."""
    ours_path, theirs_path = tmp_path / "ours.json", tmp_path / "theirs.json"
    with trace.trace_session(str(ours_path)):
        search_by_chunks(pulse_file, device="cpu", make_plots=False,
                         output_dir=str(tmp_path / "ours"), **SEARCH, **kw)
    with jax_trace.trace_session(str(theirs_path)):
        jax_search_by_chunks(pulse_file, backend="jax", kernel="pallas",
                             make_plots=False, progress=False,
                             output_dir=str(tmp_path / "theirs"), **SEARCH,
                             **kw)
    return (json.loads(ours_path.read_text()),
            json.loads(theirs_path.read_text()))


def _tracks(doc):
    return [e["args"]["name"] for e in doc["traceEvents"]
            if e["name"] == "thread_name"]


def test_span_json_schema_and_names_equal_jax_driver(pulse_file, tmp_path,
                                                     clean_state):
    # the serial loop: every span it opens is a function of the file
    # alone (an overlapped persist worker adds persist_backpressure only
    # when it falls two tasks behind, which depends on the host's load)
    ours, theirs = _traced_pair(pulse_file, tmp_path, overlap_persist=False)
    assert _schema(ours) == _schema(theirs)
    assert _tracks(ours) == _tracks(theirs)
    # the port gates the frames on the card, on the main thread (the JAX
    # package on its reader thread, off the chunk's budget): one span more
    assert _span_names(ours) == _span_names(theirs) | {"gate"}
    persists = [e["ph"] for e in ours["traceEvents"]
                if e["name"] == "persist"]
    assert "X" in persists and "b" not in persists


def test_overlapped_persist_spans_equal_jax_driver(pulse_file, tmp_path,
                                                   clean_state):
    # the overlapped loop (the default): the persist worker's balanced
    # async persist spans on the chunks' tracks, the schema, and the span
    # names up to the load-dependent persist_backpressure
    ours, theirs = _traced_pair(pulse_file, tmp_path)
    assert _schema(ours) == _schema(theirs)
    assert _tracks(ours) == _tracks(theirs)
    load = {"persist_backpressure"}
    assert _span_names(ours) - load == (_span_names(theirs) - load) | {"gate"}
    persists = [e["ph"] for e in ours["traceEvents"]
                if e["name"] == "persist"]
    assert persists.count("b") == persists.count("e") > 0


def test_dispatch_retry_is_a_span(pulse_file, tmp_path, clean_state):
    from pulsarutils_tpu_torch.faults import FaultPlan, FaultSpec

    plan = FaultPlan([FaultSpec(site="dispatch", chunks=(2048,),
                                times=1)])
    path = tmp_path / "trace.json"
    with plan.armed(), trace.trace_session(str(path)):
        search_by_chunks(pulse_file, device="cpu", make_plots=False,
                         output_dir=str(tmp_path / "out"), **SEARCH)
    retries = [e for e in json.loads(path.read_text())["traceEvents"]
               if e["name"] == "dispatch_retry"]
    assert len(retries) == 1
    assert retries[0]["args"] == {"chunk": 2048, "attempt": 1,
                                  "device": "device"}


def test_trace_session_writes_the_device_trace(tmp_path, clean_state):
    out = tmp_path / "run.json"
    acct = logging_utils.BudgetAccountant()
    with trace.trace_session(str(out), device_trace_dir=str(out) + "_device"):
        with acct.chunk(0):
            with acct.bucket("search"):
                torch.ones(64, 64).sum()
    assert "search" in _span_names(json.loads(out.read_text()))
    dev = json.loads((Path(str(out) + "_device")
                      / trace.DEVICE_TRACE_FILE).read_text())
    ranges = {e["name"] for e in dev["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert {"chunk", "search"} <= ranges
    assert trace._RECORD is None          # the session is closed


# -- the survey report -------------------------------------------------------

def _sections():
    acct = logging_utils.BudgetAccountant(rtt_s=0.01)
    with acct.chunk(0):
        with acct.bucket("search"):
            pass
    reg = metrics.MetricsRegistry()
    reg.counter("putpu_hits_total").inc(2)
    reg.counter("putpu_oom_events_total", surface="chunk_search").inc()
    return dict(
        meta={"root": "pulse", "fname": "/data/pulse.fil",
              "fingerprint": "abc", "chunks_processed": 7, "hits": 2,
              "certified": 0, "backend": "torch", "kernel": "auto",
              "snr_threshold": 6.0},
        budget=acct.to_json(max_per_chunk=0),
        roofline=[{"kernel": "dedisperse_direct_sweep", "calls": 8,
                   "wall_s": 0.75, "gflops_total": 1.5,
                   "gbytes_total": 0.25, "achieved_gflops": 2.0,
                   "achieved_gbytes_per_s": 0.33, "frac_of_ideal": 0.2,
                   "uncosted_calls": 0}],
        health={"status": "DEGRADED", "reasons": [
            {"kind": "slow_chunk", "severity": "DEGRADED", "detail": "x"}],
            "updates": 3, "incidents": [
                {"chunk": 2, "kind": "slow_chunk", "severity": "DEGRADED",
                 "event": "raised", "detail": "x", "t": 1.0}],
            "transitions": [{"chunk": 2, "from": "OK", "to": "DEGRADED",
                             "reasons": ["slow_chunk"]}]},
        canary={"rate": 1.0, "dm": 150.0, "target_snr": 12.0,
                "width_samples": 2, "injected": 3, "recovered": 2,
                "discarded": 0, "recall": 0.6667, "window": 20,
                "window_recall": 0.6667, "snr_ratio_mean": 0.9,
                "dm_error_mean": 0.1, "dm_error_rms": 0.2,
                "curve": [[0, 1, 1.0], [2048, 2, 1.0], [4096, 3, 0.6667]]},
        quarantine=[{"chunk": 4096, "end": 8192, "reason": "read_error",
                     "stats": {"error": "x"}}],
        sift={"in": 4, "out": 2},
        metrics=reg.snapshot(),
        lineage={"candidates": 2, "latency": {"n": 2, "p50": 0.5,
                                              "p95": 0.7, "max": 0.7},
                 "stages": {"read": {"n": 2, "p50": 0.1, "p95": 0.2,
                                     "max": 0.2}}},
        push={"subscribers": 1, "published": 2, "delivered": 2,
              "dropped": 0, "dead_lettered": 0, "filtered": 0,
              "queued": 0})


def test_report_markdown_and_html_equal_jax(tmp_path):
    sections = _sections()
    ours = report.build_report(**sections)
    theirs = jax_report.build_report(**sections)
    ours["generated"] = theirs["generated"]
    assert ours == theirs
    assert report.render_markdown(ours) == jax_report.render_markdown(theirs)
    assert report.render_html(ours) == jax_report.render_html(theirs)
    md, html = report.write_report(str(tmp_path / "r.md"), **sections)
    assert md.endswith("r.md") and html.endswith("r.html")
    report.amend_report(str(tmp_path / "r"), sift={"in": 9, "out": 1})
    rec = json.loads((tmp_path / "r.json").read_text())
    assert rec["sift"] == {"in": 9, "out": 1}


# -- roofline ----------------------------------------------------------------

def test_work_models_give_the_smoke_bounds():
    # the formulas chip_smoke.py printed before they moved here
    ndm, nchan, t = 514, 1024, 1 << 20
    ms, by = roofline.sweep_bound_ms(ndm, nchan, t)
    assert ms == 1e3 * max(ndm * nchan * t / 33.5e12,
                           4 * (nchan * t + ndm * t + ndm * nchan) / 3.35e12)
    assert by == "operations"
    rows, nbins, depths = 512, 524289, (1, 2, 4, 8, 16)
    adds = rows * sum(-(-nbins // j) for j in range(1, 17))
    nbytes = 4 * rows * nbins + 8 * rows * len(depths)
    assert roofline.b6_bound_ms(rows, nbins, depths, "f32") == \
        roofline.bound_ms(adds, nbytes)
    assert roofline.b6_work(rows, nbins, depths, "f32_compensated") == (
        7 * adds + rows * nbins * len(depths), nbytes)
    assert roofline.b6_work(rows, nbins, depths,
                            "bf16_operand_f32_accum") == (
        adds + 2 * rows * nbins, nbytes)
    assert roofline.score_work(512, t, 6 * 512) == (
        16 * 512 * t, 4 * 512 * t + 8 * 6 * 512)
    assert roofline.fdd_work(1024, t // 2 + 1, 64, 78) == (
        (6 * 64 + 78) * 1024 * (t // 2 + 1),
        8 * 1024 * (t // 2 + 1) + 28 * 1024 + 8 * 64 * (t // 2 + 1))
    assert roofline.CARD_PEAKS == {"NVIDIA H100 80GB HBM3": (33.5e12,
                                                             3.35e12)}


def test_roofline_records_at_the_wrappers(clean_state):
    data = torch.randn(16, 256)
    offsets = np.arange(8)[:, None] * np.arange(16)[None, :] % 256
    assert roofline.begin(data.device) is None   # disabled: free
    dedisperse_plane(data, offsets)
    assert roofline.table() == []
    roofline.enable()
    plane = dedisperse_plane(data, offsets)
    score_plane(plane)
    score_plane(plane, with_cert=True)
    rows = {r["kernel"]: r for r in roofline.table()}
    sweep = rows["dedisperse_direct_sweep"]
    assert sweep["calls"] == 1 and sweep["wall_s"] > 0
    ops, nbytes = roofline.sweep_work(8, 16, 256)
    assert sweep["gflops_total"] == round(ops / 1e9, 3)
    assert sweep["gbytes_total"] == round(nbytes / 1e9, 3)
    assert sweep["frac_of_ideal"] is None      # the CPU has no peaks
    assert rows["one_pass_scorer"]["calls"] == 2
    assert metrics.REGISTRY.gauge("putpu_roofline_gbytes_per_s",
                                  kernel="one_pass_scorer").value > 0


def test_roofline_measure_is_free_when_off_and_skips_a_failure(clean_state):
    calls = []

    def work():
        calls.append(1)
        return (10, 20)

    with roofline.measure("cpu", "k", work):
        pass
    assert calls == [] and roofline.table() == []
    roofline.enable()
    with pytest.raises(RuntimeError):
        with roofline.measure("cpu", "k", work):
            raise RuntimeError("launch failed")
    assert calls == [] and roofline.table() == []
    with roofline.measure("cpu", "k", work):
        pass
    (row,) = roofline.table()
    assert calls == [1] and row["kernel"] == "k" and row["calls"] == 1


def test_memory_watermark_on_the_cpu_records_nothing(clean_state):
    assert memory.record_watermark("cpu") is None
    assert memory.device_memory_snapshot("cpu") is None
    assert not [m for m in metrics.REGISTRY.snapshot()
                if m["name"].startswith("putpu_device_bytes")]


# -- the driver's record -----------------------------------------------------

def test_driver_fills_stage_seconds_from_the_accountant(pulse_file, tmp_path,
                                                        caplog, clean_state):
    acct = logging_utils.BudgetAccountant()
    stages, summary = {}, {}
    with caplog.at_level(logging.INFO, logger="pulsarutils_tpu_torch"):
        search_by_chunks(pulse_file, device="cpu", make_plots=False,
                         budget=acct, stage_seconds=stages, summary=summary,
                         output_dir=str(tmp_path), **SEARCH)
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("BUDGET_JSON ")]
    assert len(lines) == 1
    doc = json.loads(lines[0][len("BUDGET_JSON "):])
    assert doc == json.loads(json.dumps(acct.to_json()))
    assert doc["chunks"] == summary["searched"] == 7
    assert stages == acct.stage_seconds()
    assert {"badchans", "read", "upload_wait", "gate", "clean", "search",
            "persist", "persist_drain", "read_decode"} <= set(stages)
    assert doc["counters"]["dispatches"] == 3 * 7   # clean, sweep, scorer


# -- the CLI -----------------------------------------------------------------

def _options(parser):
    return {a.dest: a for a in parser._actions if a.option_strings}


def test_cli_takes_every_jax_flag_with_its_default():
    ours = _options(search_main.build_parser())
    theirs = _options(jax_cli.build_parser())
    assert set(theirs) - set(ours) == {"backend"}
    assert set(ours) - set(theirs) == {"device"}
    for dest, action in theirs.items():
        if dest == "backend":
            continue
        mine = ours[dest]
        assert mine.option_strings == action.option_strings, dest
        assert mine.default == action.default, dest
        assert mine.choices == action.choices, dest
        assert type(mine).__name__ == type(action).__name__, dest
    assert ours["plots"].default == "hits"


def test_cli_writes_metrics_trace_and_report(pulse_file, tmp_path,
                                             clean_state):
    out = tmp_path / "out"
    rc = search_main.main([
        pulse_file, "--dmmin", "100", "--dmmax", "200", "--chunk-length",
        "1.024", "--snr-threshold", "6", "--output-dir", str(out),
        "--device", "cpu", "--plots", "none", "--trace",
        str(tmp_path / "t.json"), "--metrics-out", str(tmp_path / "m.prom"),
        "--report-out", str(tmp_path / "report")])
    assert rc == 0
    prom = (tmp_path / "m.prom").read_text()
    assert "putpu_chunks_total" in prom and "# TYPE" in prom
    assert "search" in _span_names(json.loads(
        (tmp_path / "t.json").read_text()))
    assert (tmp_path / "t.json_device" / trace.DEVICE_TRACE_FILE).is_file()
    md = (tmp_path / "report.md").read_text()
    assert "Wall-clock budget" in md and "sift" in md.lower()
    assert "dedisperse_direct_sweep" in md     # --trace: roofline on
    assert not list(out.glob("*.jpg"))
    rc = search_main.main([
        pulse_file, "--dmmin", "100", "--dmmax", "200", "--chunk-length",
        "1.024", "--output-dir", str(tmp_path / "jsonl"), "--device", "cpu",
        "--plots", "none", "--metrics-out", str(tmp_path / "m.jsonl")])
    assert rc == 0
    first = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[0])
    assert first == {"schema_version": logging_utils.SCHEMA_VERSION}
    assert os.path.getsize(tmp_path / "m.jsonl") > 100


# -- the series the sift, the periodicity grid and the OOM ladder emit -------

def _family(registry, prefix):
    """``{(name, labels): sample}`` of a registry's series under
    ``prefix``."""
    return {(m["name"], tuple(sorted(m["labels"].items()))):
            {k: v for k, v in m.items()
             if k not in ("name", "labels", "type")}
            for m in registry.snapshot() if m["name"].startswith(prefix)}


class _Table:
    """A minimal hit table for ``hit_fields`` (both packages)."""

    colnames = ("peak",)

    def __init__(self, dm, snr, rebin=1):
        self._row = {"DM": dm, "snr": snr, "rebin": rebin, "peak": 100}

    def best_row(self):
        return self._row

    def __getitem__(self, k):
        return [self._row[k]]


class _Info:
    pulse_freq = 1.0 / (1000 * 0.001)
    nbin = 1000

    def __init__(self, t0=0.0):
        self.t0 = t0


#: a duplicate, a width and a DM-radius absorption, and three kept
#: candidates whose S/N and DM fall in different histogram buckets
SIFT_HITS = [(0, 1000, _Info(), _Table(300.0, 20.0)),
             (500, 1500, _Info(), _Table(300.2, 15.0)),
             (500, 1500, _Info(), _Table(305.0, 11.0)),
             (2000, 3000, _Info(2.0), _Table(300.0, 12.0, rebin=1000)),
             (9000, 10000, _Info(500.0), _Table(640.0, 9.0)),
             (9000, 10000, _Info(500.0), _Table(900.0, 6.2))]


def test_sift_series_equal_jax(clean_state):
    """The in/kept totals, the rejected counts by reason and the S/N and
    DM histograms of one sift equal the JAX package's."""
    from pulsarutils_tpu.pipeline.sift import sift_hits as jax_sift_hits
    from pulsarutils_tpu_torch.pipeline import sift

    jax_metrics.REGISTRY.reset()
    jax_stats, stats = {}, {}
    jax_kept = jax_sift_hits(SIFT_HITS, stats=jax_stats)
    kept = sift.sift_hits(SIFT_HITS, stats=stats)
    assert stats == jax_stats and len(kept) == len(jax_kept) == 3
    assert stats["rejected"] == {"duplicate": 1, "width": 1,
                                 "dm_radius": 1}
    ours = _family(metrics.REGISTRY, "putpu_sift_")
    assert ours == _family(jax_metrics.REGISTRY, "putpu_sift_")
    assert {name for name, _ in ours} == {
        "putpu_sift_candidates_in_total", "putpu_sift_candidates_kept_total",
        "putpu_sift_rejected_total", "putpu_sift_snr", "putpu_sift_dm"}
    assert ours[("putpu_sift_candidates_in_total", ())] == {"value": 6}
    from pulsarutils_tpu.pipeline import sift as jax_sift

    assert (sift.SNR_EDGES, sift.DM_EDGES) == (jax_sift.SNR_EDGES,
                                              jax_sift.DM_EDGES)
    jax_metrics.REGISTRY.reset()


def test_search_with_hits_then_sift_series_equal_jax(pulse_file, tmp_path,
                                                     clean_state):
    """A search with hits, then ``sift_hits``, in each package: the sift
    series' counts equal (the S/N sums within the scorers' tolerance)."""
    from pulsarutils_tpu.pipeline.sift import sift_hits as jax_sift_hits
    from pulsarutils_tpu_torch.pipeline.sift import sift_hits

    jax_metrics.REGISTRY.reset()
    ref_hits, _ = jax_search_by_chunks(
        pulse_file, backend="jax", kernel="pallas", make_plots=False,
        progress=False, output_dir=str(tmp_path / "jax"), **SEARCH)
    hits, _ = search_by_chunks(pulse_file, device="cpu", make_plots=False,
                               output_dir=str(tmp_path / "port"), **SEARCH)
    assert len(hits) == len(ref_hits) >= 2
    jax_sift_hits(ref_hits)
    sift_hits(hits)
    ours = _family(metrics.REGISTRY, "putpu_sift_")
    theirs = _family(jax_metrics.REGISTRY, "putpu_sift_")
    assert ours.keys() == theirs.keys() and len(ours) >= 4
    for key, sample in ours.items():
        ref = theirs[key]
        assert sample.keys() == ref.keys()
        for k in sample:
            if k == "sum":
                assert sample[k] == pytest.approx(ref[k], rel=1e-4)
            else:
                assert sample[k] == ref[k], (key, k)
    jax_metrics.REGISTRY.reset()


@pytest.mark.parametrize("axis", ["accel", "jerk"])
def test_capped_grid_series_equal_jax(clean_state, axis):
    from pulsarutils_tpu.periodicity import accel as jax_accel
    from pulsarutils_tpu_torch.periodicity import accel

    grid_fn = f"{axis}_grid"
    jax_metrics.REGISTRY.reset()
    with pytest.warns(UserWarning, match="max_trials"):
        ours = getattr(accel, grid_fn)(1.0e9, 0.001, 1 << 16, max_trials=11)
    with pytest.warns(UserWarning, match="max_trials"):
        theirs = getattr(jax_accel, grid_fn)(1.0e9, 0.001, 1 << 16,
                                             max_trials=11)
    np.testing.assert_array_equal(ours, theirs)
    # an uncapped grid ticks nothing
    getattr(accel, grid_fn)(1.0, 0.001, 1 << 16, max_trials=1025)
    getattr(jax_accel, grid_fn)(1.0, 0.001, 1 << 16, max_trials=1025)
    family = _family(metrics.REGISTRY, "putpu_period_grid_capped")
    assert family == _family(jax_metrics.REGISTRY,
                             "putpu_period_grid_capped")
    assert family == {("putpu_period_grid_capped_total",
                       (("axis", axis),)): {"value": 1}}
    jax_metrics.REGISTRY.reset()


@pytest.mark.parametrize("headroom,limit", [(12345, None),
                                            (None, "3000000"),
                                            (None, None)])
def test_oom_event_headroom_gauge_equals_jax(monkeypatch, clean_state,
                                             headroom, limit):
    """``oom_event(surface, headroom=None)`` as in JAX: the given
    headroom, else the budget's (``PUTPU_MEM_LIMIT`` on the host), else
    no gauge."""
    from pulsarutils_tpu.resilience import ladder as jax_ladder
    from pulsarutils_tpu_torch.resilience import ladder

    if limit is None:
        monkeypatch.delenv("PUTPU_MEM_LIMIT", raising=False)
    else:
        monkeypatch.setenv("PUTPU_MEM_LIMIT", limit)
    # the JAX host backend reports its live arrays as in use; the port's
    # host reports none: hold both to an empty device
    monkeypatch.setattr("pulsarutils_tpu.obs.memory.device_memory_snapshot",
                        lambda *a, **k: None)
    jax_metrics.REGISTRY.reset()
    ladder.oom_event("chunk_search", headroom=headroom)
    jax_ladder.oom_event("chunk_search", headroom=headroom)
    ours = _family(metrics.REGISTRY, "putpu_oom_")
    assert ours == _family(jax_metrics.REGISTRY, "putpu_oom_")
    gauge = ours.get(("putpu_oom_headroom_at_failure_bytes", ()))
    expect = headroom if headroom is not None else (
        int(limit) if limit else None)
    assert (gauge or {}).get("value") == expect
    jax_metrics.REGISTRY.reset()
