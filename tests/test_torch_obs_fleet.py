"""The port's fleet observability (``obs/{capacity,timeseries,slo,
collector}.py``, ``push_tracer`` in ``obs/trace.py``, the ``/fleet``,
``/metrics/history`` and ``/alerts`` routes) against the JAX package's
classes, on the CPU.

* capacity: the utilization accountant, the EWMA, the saturation
  detector and the capacity model fed the same inputs (fake clocks,
  synthetic load curves) give the JAX classes' documents, states and
  advice; the coordinator's lease-wait histogram and throughput model
  fed off ``complete``; the worker's idle backoff; ``/fleet/capacity``,
  the report's "Capacity & scaling" section, and a capacity-on 2-worker
  fleet writing the capacity-off fleet's and the single-process run's
  bytes;
* time series: ``series_key`` and ``histogram_quantile`` as JAX's, and a
  sampler over the port's registry giving the JAX sampler's points for
  the same metric updates at the same fake times;
* SLOs: the burn-rate engine's alerts, status rows and footer the JAX
  engine's on the same points, the health feed and its resolution, the
  spec validation messages;
* the collector: ``clock_offset`` and the merged Chrome trace of the
  same payloads as JAX's; ``merge_trace_files``;
* tracing in the fleet: ``push_tracer`` isolating in-process workers,
  the incremental drain, the trace context over the wire, a resent
  completion not ingested twice, a malformed lease context running its
  unit untraced, the clock offset's refresh, a failed completion keeping
  its spans, and a traced 2-worker fleet with time series and SLOs armed
  writing the single-process run's bytes and one merged trace;
* the routes' bodies the JAX server's for the same objects, and 404 when
  nothing is wired.

Sockets bind port 0; every server is closed in a ``with`` or a
``finally``; every wait has a timeout.
"""
import glob
import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pulsarutils_tpu.obs import capacity as jcapacity
from pulsarutils_tpu.obs import collector as jcollector
from pulsarutils_tpu.obs import metrics as jmetrics
from pulsarutils_tpu.obs import slo as jslo
from pulsarutils_tpu.obs import timeseries as jtimeseries
from pulsarutils_tpu.obs.health import HealthEngine as JHealthEngine
from pulsarutils_tpu.obs.server import start_obs_server as jstart_obs_server

from pulsarutils_tpu_torch.fleet import protocol
from pulsarutils_tpu_torch.fleet.coordinator import FleetCoordinator
from pulsarutils_tpu_torch.fleet.worker import FleetWorker
from pulsarutils_tpu_torch.io.candidates import CandidateStore
from pulsarutils_tpu_torch.io.sigproc import write_simulated_filterbank
from pulsarutils_tpu_torch.models.simulate import disperse_array
from pulsarutils_tpu_torch.obs import capacity, collector, metrics, slo
from pulsarutils_tpu_torch.obs import timeseries, trace
from pulsarutils_tpu_torch.obs.health import HealthEngine
from pulsarutils_tpu_torch.obs.report import build_report, render_markdown
from pulsarutils_tpu_torch.obs.server import start_obs_server
from pulsarutils_tpu_torch.pipeline.search_pipeline import search_by_chunks
from pulsarutils_tpu_torch.resilience import ladder

torch.set_num_threads(1)

TSAMP = 0.0005
NCHAN = 64
NSAMPLES = 24576
CONFIG = dict(dmmin=100, dmmax=200, chunk_length=8192 * TSAMP,
              snr_threshold=6.5)
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _static(monkeypatch):
    monkeypatch.setenv("PUTPU_AUTOTUNE", "off")
    monkeypatch.delenv("PUTPU_PRECISION", raising=False)
    monkeypatch.delenv("PUTPU_MEM_LIMIT", raising=False)
    ladder.reset()
    yield
    ladder.reset()


def write_file(path, seed=0, pulse=False):
    rng = np.random.default_rng(seed)
    arr = np.abs(rng.normal(0, 0.5, (NCHAN, NSAMPLES))) + 20.0
    if pulse:
        arr[:, (3 * NSAMPLES) // 4] += 4.0
        arr = disperse_array(arr, 150.0, 1200., 200., TSAMP)
    header = {"bandwidth": 200., "fbottom": 1200., "nchans": NCHAN,
              "nsamples": NSAMPLES, "tsamp": TSAMP,
              "foff": 200. / NCHAN}
    write_simulated_filterbank(str(path), arr, header, descending=True)
    return str(path)


def snapshot_dir(outdir):
    out = {}
    for path in sorted(glob.glob(os.path.join(str(outdir), "*"))):
        name = os.path.basename(path)
        if name.startswith("progress_") and name.endswith(".json"):
            with open(path, "rb") as f:
                out[name] = f.read()
        elif name.endswith(".npz"):
            with np.load(path, allow_pickle=False) as z:
                out[name] = {k: (str(z[k].dtype), z[k].shape,
                                 z[k].tobytes()) for k in z.files}
    return out


def get_json(url):
    try:
        with urllib.request.urlopen(url, timeout=10.0) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, None


def histogram_count(name):
    return sum(m.get("count", 0) for m in metrics.REGISTRY.snapshot()
               if m.get("name") == name)


# -- capacity: the same inputs through both packages' classes ------------------

def _utilization(mod):
    util = mod.UtilizationAccountant()
    out = [util.busy_fraction(), util.duty_cycle()]
    for kind, dt in (("busy", 6.0), ("idle", 2.0), ("busy", 2.0),
                     ("device", 4.0), ("idle", -5.0), ("device", 9.0)):
        getattr(util, f"note_{kind}")(dt)
        out.append(util.doc())
    return out


def _ewma(mod):
    tp = mod.EwmaThroughput(alpha=0.5)
    out = [tp.eta_s(10)]
    for chunks, wall in ((1, 1.0), (1, 0.25), (1, 0.0), (1, -3.0),
                         (3, 0.5), (0, 1.0)):
        tp.note(chunks, wall)
        out.append((tp.rate, tp.n, tp.eta_s(5)))
    return out


DETECTOR_CURVES = {
    "worker_bound": [(1, 0.9), (3, 0.9), (5, 0.9), (7, 0.95)],
    "decay": [(1, 0.9), (3, 0.9), (5, 0.9), (5, 0.5), (4, 0.5),
              (3, 0.5), (3, 0.5)],
    "starved": [(0, 0.1), (0, 0.1), (0, 0.2)],
    "unknown_util": [(0, None), (0, None), (2, None), (4, None)],
    "noisy": [(1, 0.9), (4, 0.9), (2, 0.4), (3, 0.4)],
    "draining": [(7, 0.9, True), (7, 0.9, True), (1, 0.9)],
}


def _detector(mod, curve):
    det = mod.SaturationDetector(confirm=2, decay=3, window=4)
    states = []
    for i, sample in enumerate(curve):
        depth, util = sample[:2]
        draining = len(sample) > 2 and sample[2]
        states.append(det.observe(depth, util, draining=draining, now=i))
    return states, det.doc()


ADVICE_CASES = {
    "no_evidence": ([], [(10, 2, "worker-bound")]),
    "saturated": ([("w1", 1, 10.0), ("w2", 1, 10.0)] * 4,
                  [(100, 2, "worker-bound"), (100, 2, "healthy")]),
    "starved": ([("w1", 1, 0.5)] * 8,
                [(3, 4, "starved"), (3, 1, "starved")]),
    "draining": ([("w1", 1, 10.0)], [(500, 2, "draining")]),
    "two_rates": ([("w1", 2, 1.0), ("w2", 1, 1.0)],
                  [(12, 4, "healthy"), (12, 0, "worker-bound")]),
}


def _advice(mod, case, **kw):
    notes, asks = ADVICE_CASES[case]
    model = mod.CapacityModel(**kw)
    for note in notes:
        model.note_unit(*note)
    return ([model.advise(*ask).doc() for ask in asks], model.doc(),
            [model.eta_s(b, n) for b, n, _ in asks], model.fleet_rate())


def test_utilization_accountant_as_jax():
    ours = _utilization(capacity)
    assert ours == _utilization(jcapacity)
    assert ours[:2] == [None, None]
    assert ours[4]["busy_fraction"] == pytest.approx(0.8)
    assert ours[5]["busy_fraction"] == pytest.approx(0.8)
    assert ours[-1]["duty_cycle"] == 1.0


def test_ewma_throughput_as_jax():
    ours = _ewma(capacity)
    assert ours == _ewma(jcapacity)
    assert ours[2][0] == pytest.approx(2.5) and ours[4][1] == 2


@pytest.mark.parametrize("curve", sorted(DETECTOR_CURVES))
def test_saturation_detector_as_jax(curve):
    ours = _detector(capacity, DETECTOR_CURVES[curve])
    assert ours == _detector(jcapacity, DETECTOR_CURVES[curve])
    states = ours[0]
    assert states[-1] == {"worker_bound": "worker-bound",
                          "decay": "healthy", "starved": "starved",
                          "unknown_util": "worker-bound",
                          "noisy": "healthy",
                          "draining": "draining"}[curve]


@pytest.mark.parametrize("case", sorted(ADVICE_CASES))
@pytest.mark.parametrize("kw", [{}, {"target_drain_s": 100.0},
                                {"target_drain_s": 10.0, "max_workers": 3}])
def test_capacity_model_advice_as_jax(case, kw):
    ours = _advice(capacity, case, **kw)
    assert ours == _advice(jcapacity, case, **kw)
    if case == "saturated" and kw == {"target_drain_s": 100.0}:
        assert ours[0][0]["direction"] == "up"
        assert ours[0][0]["desired_workers"] == 10
    if case == "no_evidence":
        assert ours[0][0]["confidence"] == 0.0


def test_complete_feeds_lease_wait_histogram_and_model(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=5)
    out = tmp_path / "fleet"
    with FleetCoordinator(str(out), auto_sweep=False,
                          capacity=True) as coordinator:
        coordinator.add_survey([fname], **CONFIG)
        fingerprint = coordinator.progress_doc()["files"][0]["fingerprint"]
        w = coordinator.register({})["worker"]
        store = CandidateStore(str(out), fingerprint)
        lease = coordinator.lease({"worker": w, "max_units": 1})["leases"][0]
        for c in lease["chunks"]:
            store.mark_done(c)
        before = histogram_count("putpu_lease_wait_seconds")
        resp = coordinator.complete({
            "worker": w, "lease": lease["lease"], "unit": lease["unit"],
            "error": None, "unit_wall_s": 0.01})
        assert resp["unit_done"] is True
        assert histogram_count("putpu_lease_wait_seconds") == before + 1
        assert coordinator.capacity_model.observations() == 1
        lease2 = coordinator.lease({"worker": w,
                                    "max_units": 1})["leases"][0]
        for c in lease2["chunks"]:
            store.mark_done(c)
        coordinator.complete({"worker": w, "lease": lease2["lease"],
                              "unit": lease2["unit"], "error": None})
        assert histogram_count("putpu_lease_wait_seconds") == before + 1
        assert coordinator.capacity_model.observations() == 1
        coordinator.sweep()
        coordinator.sweep()     # a state change needs two observations
        doc = coordinator.capacity_doc()
        assert doc["enabled"] is True and doc["state"] == "draining"
        assert doc["advice"]["direction"] == "hold"


def test_idle_wait_backoff_grows_capped_and_accounts_idle():
    w = FleetWorker.__new__(FleetWorker)
    w.poll_s = 0.01
    w.idle_backoff_cap_s = 0.04
    w._idle_streak = 0
    w._drain = threading.Event()
    w.util = capacity.UtilizationAccountant()
    walls = []
    for _ in range(5):
        t0 = time.monotonic()
        assert w._idle_wait() is False
        walls.append(time.monotonic() - t0)
    assert walls[0] < 0.035
    assert all(0.03 <= x <= 0.2 for x in walls[3:])
    assert w._idle_streak == 5
    assert w.util.idle_s == pytest.approx(sum(walls), rel=0.2)
    assert w.util.busy_fraction() == 0.0
    w._drain.set()
    assert w._idle_wait() is True


def _fleet_run(outdir, fnames, *, capacity_on, health=None):
    coordinator = FleetCoordinator(str(outdir), lease_ttl_s=60.0,
                                   probe_interval_s=0.2,
                                   capacity=capacity_on, health=health)
    server = start_obs_server(0, fleet=coordinator)
    url = f"http://127.0.0.1:{server.port}"
    try:
        coordinator.add_survey(fnames, **CONFIG)
        fleet = [FleetWorker(url, http_port=None, **CPU) for _ in range(2)]
        threads = [threading.Thread(target=w.run,
                                    kwargs={"max_idle_s": 60.0})
                   for w in fleet]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
        coordinator.sweep()
        _, doc = get_json(url + "/fleet/capacity")
        progress = coordinator.progress_doc()
        summary = coordinator.summary()
    finally:
        server.close()
        coordinator.close()
    return doc, progress, summary


def test_fleet_capacity_endpoint_report_and_byte_inertness(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=7, pulse=True)
    search_by_chunks(fname, output_dir=str(tmp_path / "ref"),
                     make_plots=False, progress=False, **CPU, **CONFIG)
    off_doc, off_prog, off_sum = _fleet_run(tmp_path / "off", [fname],
                                            capacity_on=False)
    on_doc, on_prog, on_sum = _fleet_run(tmp_path / "on", [fname],
                                         capacity_on=True,
                                         health=HealthEngine())
    ref = snapshot_dir(tmp_path / "ref")
    assert snapshot_dir(tmp_path / "off") == ref
    assert snapshot_dir(tmp_path / "on") == ref
    assert off_doc["enabled"] is False and "capacity" in off_doc["reason"]
    assert "capacity" not in off_sum
    assert on_doc["enabled"] is True
    assert on_doc["state"] in capacity.SaturationDetector.STATES
    assert on_doc["throughput"]["observations"] >= 2
    assert on_doc["advice"]["direction"] in ("up", "down", "hold")
    assert on_sum["capacity"]["enabled"] is True
    assert "eta_s" in off_prog and "eta_s" in on_prog
    fracs = [m for m in metrics.REGISTRY.snapshot()
             if m.get("name") == "putpu_worker_busy_fraction"]
    assert fracs and all((m.get("labels") or {}).get("worker")
                         for m in fracs)
    md = render_markdown(build_report(meta={"root": "test"}, fleet=on_sum,
                                      capacity=on_sum["capacity"]))
    assert "## Capacity & scaling" in md and "Saturation state" in md
    md_off = render_markdown(build_report(meta={"root": "test"},
                                          fleet=off_sum))
    assert "Capacity observability was off" in md_off


# -- the time series -----------------------------------------------------------

@pytest.mark.parametrize("q, edges, counts", [
    (0.5, (1.0, 2.0), [0, 4, 0]), (0.99, (1.0, 2.0), [0, 0, 3]),
    (0.5, (1.0, 2.0), [0, 0, 0]), (0.95, (0.1, 1.0, 10.0), [3, 5, 1, 1]),
    (0.0, (1.0,), [2, 0]), (1.0, (0.5, 1.0), [1, 1, 0]),
])
def test_histogram_quantile_as_jax(q, edges, counts):
    assert timeseries.histogram_quantile(q, edges, counts) \
        == jtimeseries.histogram_quantile(q, edges, counts)


@pytest.mark.parametrize("labels", [None, {}, {"worker": "w1"},
                                    {"b": "2", "a": "1"}])
def test_series_key_as_jax(labels):
    assert timeseries.series_key("putpu_x", labels) \
        == jtimeseries.series_key("putpu_x", labels)


def _sampled(mets, ts, spill):
    reg = mets.MetricsRegistry()
    sampler = ts.TimeSeriesSampler(registry=reg, interval_s=1.0,
                                   capacity=4, spill_path=spill)
    c = reg.counter("putpu_chunks_total")
    g = reg.gauge("putpu_chunks_per_s")
    h = reg.histogram("putpu_chunk_wall_seconds", edges=(1.0, 2.0))
    labelled = reg.counter("putpu_fleet_leases_granted_total")
    sampler.sample(now=1000.0)
    c.inc(10)
    g.set(2.5)
    for v in (1.5, 1.5, 0.5, 3.0):
        h.observe(v)
    labelled.inc(2)
    sampler.sample(now=1002.0)
    for i in range(6):
        c.inc(i)
        sampler.sample(now=1003.0 + i)
    return sampler.history_doc(), sampler.points(last=0), \
        sampler.points(last=2)


def test_sampler_points_as_jax(tmp_path):
    ours = _sampled(metrics, timeseries, str(tmp_path / "port.jsonl"))
    assert ours == _sampled(jmetrics, jtimeseries,
                            str(tmp_path / "jax.jsonl"))
    doc = ours[0]
    assert doc["schema_version"] == 1 and len(doc["samples"]) == 4
    assert ours[1] == [] and len(ours[2]) == 2
    lines = (tmp_path / "port.jsonl").read_text().splitlines()
    assert lines == (tmp_path / "jax.jsonl").read_text().splitlines()
    assert len(lines) == 8
    assert json.loads(lines[1])["series"]["putpu_chunks_total"]["rate"] \
        == 5.0


def test_sampler_thread_starts_stops_and_hooks():
    reg = metrics.MetricsRegistry()
    seen = []

    def hook(point):
        seen.append(point["t"])
        raise RuntimeError("a hook must not kill the sampler")

    sampler = timeseries.TimeSeriesSampler(registry=reg, interval_s=0.05,
                                           on_sample=hook)
    with sampler:
        assert sampler.start() is sampler
        assert wait_until(lambda: len(seen) >= 2, 10.0)
    n = len(sampler.points())
    assert n >= 3 and len(seen) == n


def wait_until(cond, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


# -- SLOs ----------------------------------------------------------------------

def _ratio_points(bad_rates, t0=1000.0):
    return [{"t": t0 + i,
             "series": {"bad": {"rate": r, "total": 0.0},
                        "total": {"rate": 10.0, "total": 0.0}}}
            for i, r in enumerate(bad_rates)]


class _FakeSeries:
    def __init__(self, points):
        self._points = points

    def points(self, last=None):
        return list(self._points)


def _threshold_points(values, t0=1000.0):
    return [{"t": t0 + i,
             "series": {"putpu_canary_window_recall": {"value": v}}}
            for i, v in enumerate(values)]


SLO_SCENARIOS = {
    "ratio_step": (lambda m: [m.SLOSpec(
        "x", objective=0.9, kind="ratio", bad="bad", total="total",
        windows=((2.0, 8.0, 5.0, "page"),), budget_window_s=20.0)],
        [(_ratio_points([0.0] * 10 + [8.0] * 10), 1011.0),
         (_ratio_points([0.0] * 10 + [8.0] * 10), 1019.0),
         (_ratio_points([0.0] * 10 + [8.0] * 10 + [0.0] * 10), 1029.0)]),
    "threshold": (lambda m: [m.SLOSpec(
        "recall", objective=0.8, kind="threshold",
        series="putpu_canary_window_recall", field="value", bound=0.7,
        op=">=", windows=((2.0, 4.0, 2.0, "page"),
                          (2.0, 4.0, 1.0, "ticket")),
        budget_window_s=10.0)],
        [(_threshold_points([0.2] * 6), 1005.0),
         (_threshold_points([0.2] * 6 + [1.0] * 6), 1011.0)]),
    "defaults_no_evidence": (lambda m: m.default_slos(),
                             [([{"t": 1000.0, "series": {}}], None)]),
}


def _slo_run(mod, health_cls, scenario):
    make_specs, steps = SLO_SCENARIOS[scenario]
    health = health_cls()
    engine = mod.SLOEngine(make_specs(mod), health=health)
    out = [engine.alerts_doc()]
    for points, now in steps:
        alerts = engine.evaluate(_FakeSeries(points), now=now)
        out.append(([a.doc() for a in alerts], engine.alerts_doc(),
                    engine.to_json(), health.verdict,
                    sorted(health.reasons())))
    return out


@pytest.mark.parametrize("scenario", sorted(SLO_SCENARIOS))
def test_slo_engine_as_jax(scenario):
    ours = _slo_run(slo, HealthEngine, scenario)
    assert ours == _slo_run(jslo, JHealthEngine, scenario)
    if scenario == "ratio_step":
        assert ours[1][0] == [] and [a["slo"] for a in ours[2][0]] == ["x"]
        assert ours[2][1]["alerts_fired_total"] == 1
        assert ours[3][0] == [] and ours[3][1]["alerts"] == []
    if scenario == "threshold":
        assert ours[1][3] == "CRITICAL" and ours[2][3] == "OK"


def test_default_slos_as_jax():
    ours = [(s.name, s.kind, s.objective, s.bad, s.total, s.series,
             s.field, s.bound, s.op, s.windows) for s in slo.default_slos()]
    assert ours == [(s.name, s.kind, s.objective, s.bad, s.total, s.series,
                     s.field, s.bound, s.op, s.windows)
                    for s in jslo.default_slos()]


@pytest.mark.parametrize("kwargs", [
    dict(objective=0.9, kind="nope"),
    dict(objective=1.5, kind="ratio", bad="b", total="t"),
    dict(objective=0.9, kind="ratio"),
    dict(objective=0.9, kind="threshold"),
    dict(objective=0.9, kind="threshold", series="s", bound=1.0, op="<"),
])
def test_slo_spec_validation_as_jax(kwargs):
    with pytest.raises(ValueError) as ours:
        slo.SLOSpec("x", **kwargs)
    with pytest.raises(ValueError) as theirs:
        jslo.SLOSpec("x", **kwargs)
    assert str(ours.value) == str(theirs.value)


def test_slo_footer_is_one_alerts_json_line():
    records = []

    class _Cap(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    log = logging.getLogger("test-torch-alerts")
    log.addHandler(_Cap())
    log.setLevel(logging.INFO)
    engine = slo.SLOEngine(SLO_SCENARIOS["threshold"][0](slo))
    engine.evaluate(_FakeSeries(_threshold_points([0.2] * 6)), now=1005.0)
    engine.footer(log=log)
    line = [m for m in records if m.startswith("ALERTS_JSON ")][0]
    assert json.loads(line[len("ALERTS_JSON "):])["alerts_fired_total"] == 1


# -- the collector ---------------------------------------------------------------

PAYLOADS = [
    ("a", {"events": [{"name": "x", "ph": "X", "pid": 1, "tid": 1,
                       "ts": 1000.0, "dur": 5}], "tracks": {"main": 1},
           "epoch_unix": 100.0, "clock_offset_s": 0.0}),
    ("b", {"events": [{"name": "y", "ph": "X", "pid": 1, "tid": 1,
                       "ts": 1000.0, "dur": 5},
                      {"name": "lease", "ph": "b", "cat": "async",
                       "id": 3, "pid": 1, "tid": 2, "ts": 1.0},
                      {"name": "lease", "ph": "e", "cat": "async",
                       "id": 3, "pid": 1, "tid": 2, "ts": 9.0}],
           "tracks": {"main": 1, "worker w1": 2},
           "epoch_unix": 105.0, "clock_offset_s": -5.0}),
    ("w", None), ("w", {"no_events": True}), ("w", {"events": "nope"}),
    ("a", {"events": [{"name": "z", "ph": "X", "pid": 1, "tid": 1,
                       "ts": 2000.0, "dur": 1}], "tracks": {"main": 1},
           "epoch_unix": 100.5, "clock_offset_s": 0.25}),
]


def _collected(mod):
    coll = mod.TraceCollector()
    counts = [coll.ingest(name, doc) for name, doc in PAYLOADS]
    return counts, coll.processes(), coll.to_chrome()


def test_collector_merge_as_jax():
    ours = _collected(collector)
    assert ours == _collected(jcollector)
    counts, procs, doc = ours
    assert counts == [1, 2, 0, 0, 0, 1]
    assert procs == {"a": 2, "b": 3}
    # the same instant on two skewed clocks lands on one timestamp
    two = collector.TraceCollector()
    for name, payload in PAYLOADS[:2]:
        two.ingest(name, payload)
    spans = {e["name"]: e for e in two.to_chrome()["traceEvents"]
             if e.get("ph") == "X" and e["name"] in ("x", "y")}
    assert abs(spans["x"]["ts"] - spans["y"]["ts"]) < 1e-6
    assert spans["x"]["pid"] != spans["y"]["pid"]


@pytest.mark.parametrize("t0, t1, server", [(10.0, 12.0, 16.0),
                                            (10.0, 12.0, 6.0),
                                            (10.0, 10.0, 10.0)])
def test_clock_offset_as_jax(t0, t1, server):
    assert collector.clock_offset(t0, t1, server) \
        == jcollector.clock_offset(t0, t1, server)


def test_merge_trace_files_as_jax(tmp_path):
    paths = []
    for name in ("coordinator", "worker1"):
        tracer = trace.Tracer()
        token = trace.push_tracer(tracer)
        try:
            with trace.trace_context("feed01"):
                with trace.span(f"{name}-span"):
                    pass
        finally:
            trace.pop_tracer(token)
        path = str(tmp_path / f"{name}.json")
        tracer.export(path, extra_meta={"clock_offset_s": 0.25}
                      if name == "worker1" else None)
        paths.append(path)
    ours = collector.merge_trace_files(paths)
    assert set(ours.processes()) == {"coordinator", "worker1"}
    assert ours.to_chrome() == jcollector.merge_trace_files(paths).to_chrome()
    merged = str(tmp_path / "merged.json")
    assert ours.export(merged) == 4     # two spans, two clock_sync
    with open(merged) as f:
        doc = json.load(f)
    ids = {e["args"]["trace_id"] for e in doc["traceEvents"]
           if e.get("ph") == "X" and "trace_id" in e.get("args", {})}
    assert ids == {"feed01"}


# -- tracing in the fleet --------------------------------------------------------

def test_push_tracer_isolates_in_process_workers():
    global_tracer = trace.start_tracing()
    tracers = {}
    try:
        def work(name):
            mine = trace.Tracer()
            tracers[name] = mine
            token = trace.push_tracer(mine)
            try:
                assert trace.active_tracer() is mine and trace.is_tracing()
                with trace.span(f"unit-{name}"):
                    pass
                trace.begin_span(f"async-{name}").end()
            finally:
                trace.pop_tracer(token)

        threads = [threading.Thread(target=work, args=(n,))
                   for n in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
    finally:
        trace.stop_tracing()
    for name in ("a", "b"):
        events, _ = tracers[name].events_since(0)
        assert [e["name"] for e in events] == [f"unit-{name}",
                                               f"async-{name}",
                                               f"async-{name}"]
    names = {e["name"] for e in global_tracer.events_since(0)[0]}
    assert not names & {"unit-a", "unit-b", "async-a", "async-b"}
    assert not trace.is_tracing()


def test_events_since_incremental_drain_and_export_meta(tmp_path):
    tracer = trace.Tracer()
    token = trace.push_tracer(tracer)
    try:
        with trace.span("one"):
            pass
        events, mark = tracer.events_since(0)
        assert [e["name"] for e in events] == ["one"]
        with trace.span("two"):
            pass
        events, mark = tracer.events_since(mark)
        assert [e["name"] for e in events] == ["two"] and mark == 2
        assert len(tracer.events_since(0)[0]) == 2
        assert tracer.tracks() == {"main": 1}
    finally:
        trace.pop_tracer(token)
    tracer.export(str(tmp_path / "t.json"), extra_meta={"clock_offset_s": 1})
    doc = json.loads((tmp_path / "t.json").read_text())
    assert doc["putpu"]["clock_offset_s"] == 1
    assert doc["putpu"]["epoch_unix"] == tracer.epoch_unix


def test_trace_context_wire_roundtrip_and_old_worker_backcompat(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=21)
    coll = collector.TraceCollector()
    with FleetCoordinator(str(tmp_path / "fleet"), auto_sweep=False,
                          collector=coll) as coordinator:
        with start_obs_server(0, fleet=coordinator) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            coordinator.add_survey([fname], **CONFIG)
            reg = protocol.post_json(base + "/fleet/register",
                                     {"healthz_url": None})
            assert isinstance(reg["server_time"], float)
            resp = protocol.post_json(base + "/fleet/lease",
                                      {"worker": reg["worker"],
                                       "max_units": 2})
            assert isinstance(resp["server_time"], float)
            leases = resp["leases"]
            for lease in leases:
                assert len(protocol.clean_trace_context(
                    lease["trace"])["trace_id"]) == 16
            assert leases[0]["trace"]["trace_id"] \
                != leases[1]["trace"]["trace_id"]
            old = protocol.post_json(base + "/fleet/complete", {
                "worker": reg["worker"], "lease": leases[0]["lease"],
                "unit": leases[0]["unit"], "error": None})
            assert old["ok"] is True and coll.processes() == {}
            protocol.post_json(base + "/fleet/complete", {
                "worker": reg["worker"], "lease": leases[1]["lease"],
                "unit": leases[1]["unit"], "error": None,
                "trace": {"events": [
                    {"name": "unit", "ph": "X", "pid": 1, "tid": 1,
                     "ts": 0.0, "dur": 10.0,
                     "args": {"trace_id": leases[1]["trace"]["trace_id"]}}],
                    "tracks": {"main": 1}, "epoch_unix": 50.0,
                    "clock_offset_s": 0.125}})
            assert coll.processes() == {f"worker {reg['worker']}": 1}
    with FleetCoordinator(str(tmp_path / "fleet2"),
                          auto_sweep=False) as c2:
        c2.add_survey([fname], **CONFIG)
        w = c2.register({})["worker"]
        lease = c2.lease({"worker": w, "max_units": 1})["leases"][0]
        c2.sweep(now=time.monotonic() + 120.0)
        again = c2.lease({"worker": w, "max_units": 1})["leases"][0]
        assert again["unit"] == lease["unit"]
        assert again["trace"]["trace_id"] == lease["trace"]["trace_id"]


def test_resent_complete_does_not_double_ingest_spans(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=22)
    coll = collector.TraceCollector()
    with FleetCoordinator(str(tmp_path / "fleet"), auto_sweep=False,
                          collector=coll) as coordinator:
        coordinator.add_survey([fname], **CONFIG)
        w = coordinator.register({})["worker"]
        leases = coordinator.lease({"worker": w, "max_units": 2})["leases"]

        def complete_doc(lease, seq):
            return {"worker": w, "lease": lease["lease"],
                    "unit": lease["unit"], "error": None,
                    "trace": {"events": [
                        {"name": "unit", "ph": "X", "pid": 1, "tid": 1,
                         "ts": float(seq), "dur": 1.0}],
                        "tracks": {"main": 1}, "epoch_unix": 0.0,
                        "clock_offset_s": 0.0, "seq": seq}}

        coordinator.complete(complete_doc(leases[0], 1))
        coordinator.complete(complete_doc(leases[0], 1))
        assert coll.processes() == {f"worker {w}": 1}
        coordinator.complete(complete_doc(leases[1], 2))
        assert coll.processes() == {f"worker {w}": 2}
        doc = complete_doc(leases[1], 3)
        del doc["trace"]["seq"]
        coordinator.complete(doc)
        assert coll.processes() == {f"worker {w}": 3}


def test_malformed_lease_trace_runs_unit_untraced(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=23)
    with FleetCoordinator(str(tmp_path / "fleet"),
                          auto_sweep=False) as coordinator:
        with start_obs_server(0, fleet=coordinator) as srv:
            coordinator.add_survey([fname], **CONFIG)
            worker = FleetWorker(f"http://127.0.0.1:{srv.port}",
                                 http_port=None, **CPU)
            orig = worker._post

            def poison(path, doc, **kw):
                resp = orig(path, doc, **kw)
                for lease in (resp.get("leases") or []):
                    lease["trace"] = {"trace_id": "x" * 16,
                                      "future_key": 1}
                return resp

            worker._post = poison
            worker.run(max_idle_s=30.0)
            assert worker.units_done == 2 and coordinator.survey_done


def test_clock_offset_refreshes_on_lease_and_skips_retry_windows():
    worker = FleetWorker("http://127.0.0.1:9", http_port=None, **CPU)
    worker._update_clock_offset({"t0": 10.0, "t1": 12.0},
                                {"server_time": 16.0})
    assert worker.clock_offset_s == 5.0
    worker._update_clock_offset({"t0": 100.0, "t1": 100.0},
                                {"server_time": 101.0})
    assert worker.clock_offset_s == 1.0
    worker._update_clock_offset({}, {"server_time": 999.0})
    worker._update_clock_offset({"t0": 0.0, "t1": 0.0}, {})
    assert worker.clock_offset_s == 1.0


def test_failed_complete_keeps_spans_for_the_next_drain():
    worker = FleetWorker("http://127.0.0.1:9", http_port=None, trace=True,
                         **CPU)
    worker.worker_id = "w1"
    worker.tracer = trace.Tracer()
    token = trace.push_tracer(worker.tracer)
    try:
        with trace.span("unit"):
            pass
    finally:
        trace.pop_tracer(token)
    lease = {"lease": "L1", "unit": "u1"}
    calls = []

    def failing_post(path, doc, **kw):
        calls.append(doc)
        raise OSError("coordinator gone")

    worker._post = failing_post
    with pytest.raises(OSError):
        worker._complete(lease, None)
    assert len(calls[0]["trace"]["events"]) == 1
    assert worker._trace_mark == 0 and worker._trace_seq == 0

    def ok_post(path, doc, **kw):
        calls.append(doc)
        return {"ok": True}

    worker._post = ok_post
    worker._complete(lease, None)
    assert calls[1]["trace"]["events"] == calls[0]["trace"]["events"]
    assert calls[1]["trace"]["seq"] == calls[0]["trace"]["seq"] == 1
    assert worker._trace_mark == 1 and worker._trace_seq == 1


def test_two_worker_fleet_traced_byte_identical_one_merged_trace(tmp_path):
    """Tracing, time series and SLOs armed on a 2-worker fleet: the
    single-process run's bytes, and one merged trace where a lease's
    coordinator span and its worker's unit span share a trace id."""
    fnames = [write_file(tmp_path / "a.fil", seed=0, pulse=True),
              write_file(tmp_path / "b.fil", seed=1)]
    for fname in fnames:
        search_by_chunks(fname, output_dir=str(tmp_path / "single"),
                         make_plots=False, progress=False, **CPU, **CONFIG)
    coll = collector.TraceCollector()
    tracer = trace.start_tracing()
    engine = slo.SLOEngine()
    sampler = timeseries.TimeSeriesSampler(
        interval_s=0.2, on_sample=lambda _p: engine.evaluate(sampler))
    sampler.start()
    out = tmp_path / "fleet"
    try:
        with FleetCoordinator(str(out), lease_ttl_s=120.0,
                              probe_interval_s=0.3,
                              collector=coll) as coordinator:
            with start_obs_server(0, fleet=coordinator, timeseries=sampler,
                                  slo=engine) as srv:
                url = f"http://127.0.0.1:{srv.port}"
                coordinator.add_survey(fnames, **CONFIG)
                workers = [FleetWorker(url, http_port=0, trace=True,
                                       history_interval_s=0.2, **CPU)
                           for _ in range(2)]
                threads = [threading.Thread(target=w.run,
                                            kwargs={"max_idle_s": 60.0})
                           for w in workers]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=300.0)
                assert coordinator.survey_done
                coordinator.sweep()
                summary = coordinator.summary()
    finally:
        sampler.stop()
        trace.stop_tracing()
    coll.ingest_tracer("coordinator", tracer)
    assert snapshot_dir(tmp_path / "single") == snapshot_dir(out)
    merged = str(tmp_path / "merged.json")
    assert coll.export(merged) > 0
    with open(merged) as f:
        doc = json.load(f)
    pid_names = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
                 if e.get("ph") == "M" and e["name"] == "process_name"}
    lease_spans = [e for e in doc["traceEvents"]
                   if e.get("ph") == "b" and e["name"] == "lease"]
    unit_spans = [e for e in doc["traceEvents"]
                  if e.get("ph") == "X" and e["name"] == "unit"]
    shared = 0
    for lease_ev in lease_spans:
        for unit_ev in unit_spans:
            if unit_ev["args"]["trace_id"] == lease_ev["args"]["trace_id"]:
                assert pid_names[lease_ev["pid"]] == "coordinator"
                assert pid_names[unit_ev["pid"]].startswith("worker ")
                shared += 1
    assert shared == len(unit_spans) == 4
    chunk_spans = [e for e in doc["traceEvents"]
                   if e.get("ph") == "X" and e["name"] == "chunk"]
    assert chunk_spans and all("trace_id" in e["args"]
                               for e in chunk_spans)
    assert engine.alerts_doc()["evaluations"] > 0
    assert set(summary.get("history") or {}) == {w.worker_id
                                                 for w in workers}


# -- the routes ------------------------------------------------------------------

def _routes(mets, ts, slo_mod, start):
    reg = mets.MetricsRegistry()
    sampler = ts.TimeSeriesSampler(registry=reg, interval_s=1.0)
    reg.counter("putpu_chunks_total").inc(3)
    sampler.sample(now=1.0)
    reg.counter("putpu_chunks_total").inc(3)
    sampler.sample(now=2.0)
    engine = slo_mod.SLOEngine(slo_mod.default_slos())
    engine.evaluate(sampler)
    with start(0, timeseries=sampler, slo=engine) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        return [get_json(base + p) for p in
                ("/metrics/history", "/metrics/history?last=1",
                 "/metrics/history?last=0", "/alerts")]


def test_history_and_alerts_bodies_as_jax():
    ours = _routes(metrics, timeseries, slo, start_obs_server)
    assert ours == _routes(jmetrics, jtimeseries, jslo, jstart_obs_server)
    assert [s for s, _ in ours] == [200] * 4
    assert len(ours[0][1]["samples"]) == 2
    assert len(ours[1][1]["samples"]) == 1
    assert ours[3][1]["evaluations"] == 1 and ours[3][1]["alerts"] == []


@pytest.mark.parametrize("path", ["/metrics/history", "/alerts",
                                  "/fleet/capacity"])
def test_observability_routes_404_unwired(path):
    with start_obs_server(0) as srv:
        status, _ = get_json(f"http://127.0.0.1:{srv.port}{path}")
    assert status == 404
