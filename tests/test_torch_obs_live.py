"""The port's live surface on the CPU, held against the JAX package.

The health engine's verdicts on the same update sequences; the HTTP
surface (``/metrics``, ``/healthz``, ``/progress``, ``/status``,
``/subscribers``) on an ephemeral port, scraped while a search runs; the
lineage docs of both drivers on one file (times and trace ids masked);
push to a webhook served on 127.0.0.1 by the test (no other host is
contacted).  Every test joins the threads it starts, closes its servers
in a ``finally`` and leaves the port's registry and tracer reset.
"""
import http.server
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pulsarutils_tpu.obs import health as jax_health
from pulsarutils_tpu.obs import lineage as jax_lineage
from pulsarutils_tpu.obs import push as jax_push
from pulsarutils_tpu.obs.server import start_obs_server as jax_server
from pulsarutils_tpu.pipeline.search_pipeline import \
    search_by_chunks as jax_search_by_chunks

from pulsarutils_tpu_torch.io.sigproc import write_simulated_filterbank
from pulsarutils_tpu_torch.models.simulate import disperse_array
from pulsarutils_tpu_torch.obs import health, lineage, metrics, push, trace
from pulsarutils_tpu_torch.obs.server import start_obs_server
from pulsarutils_tpu_torch.pipeline.search_pipeline import search_by_chunks

torch.set_num_threads(1)

TSAMP = 0.0005
SEARCH = dict(dmmin=100.0, dmmax=200.0, chunk_length=4096 * TSAMP,
              snr_threshold=6.5)
JAX_KW = dict(backend="jax", kernel="pallas", make_plots=False,
              progress=False)


@pytest.fixture(autouse=True)
def clean_state():
    yield
    trace.stop_tracing()
    metrics.REGISTRY.reset()


def _get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=5.0) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode() or "{}")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Sink:
    """A webhook on 127.0.0.1 recording every JSON body posted to it."""

    def __init__(self):
        received = self.received = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length") or 0)
                received.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):
                pass

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever)
        self._thread.start()
        self.url = f"http://127.0.0.1:{self._httpd.server_address[1]}/hook"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()


@pytest.fixture
def sink():
    s = _Sink()
    try:
        yield s
    finally:
        s.close()


@pytest.fixture(scope="module")
def survey_file(tmp_path_factory):
    """64 channels, 24,576 samples, a DM-150 pulse at sample 13,000."""
    tmp = tmp_path_factory.mktemp("live")
    rng = np.random.default_rng(5)
    nchan, nsamples = 64, 24576
    array = np.abs(rng.normal(0, 0.5, (nchan, nsamples))) + 20.0
    array[:, 13000] += 4.0
    array = disperse_array(array, 150, 1200., 200., TSAMP)
    header = {"bandwidth": 200., "fbottom": 1200., "nchans": nchan,
              "nsamples": nsamples, "tsamp": TSAMP, "foff": 200. / nchan}
    path = str(tmp / "survey.fil")
    write_simulated_filterbank(path, array, header, descending=True, nbits=8)
    return path


# -- the health engine -------------------------------------------------------

def _scenarios():
    rng = np.random.default_rng(21)
    canary = {"injected": 12, "window": 20}
    storm = [dict(wall_s=0.1, candidates=c) for c in
             (1, 2, 1, 200, 1, 1, 300, 250, 400, 1, 1, 1)]
    walls = [dict(wall_s=w) for w in (0.1, 0.1, 0.1, 0.9, 0.1, 0.1, 0.1)]
    events = [dict(wall_s=0.1, quarantined=True),
              dict(wall_s=0.1, dead_letter=True, retraces=2),
              dict(wall_s=0.1, dispatch_retries=3, retraces=1),
              dict(wall_s=0.1, headroom_frac=0.05),
              dict(wall_s=0.1, headroom_frac=0.01, oom_events=2),
              dict(wall_s=0.1, quarantined=True, oom_floor=True),
              dict(wall_s=0.1, quarantined=True),
              dict(wall_s=0.1, fallback=True), dict(wall_s=0.1),
              dict(wall_s=0.1), dict(wall_s=0.1)]
    recall = [dict(wall_s=0.1, canary={**canary, "window_recall": r})
              for r in (0.9, 0.6, 0.5, 0.8, 0.95, 0.95, 0.95)]
    feed = [dict(ingest_gap_frac=g, ingest_overrun=o, ingest_disconnects=d)
            for g, o, d in ((0.0, 0, 0), (0.01, 1, 0), (0.0, 1, 1),
                            (0.0, 2, 0), (0.0, 0, 0), (0.0, 0, 0),
                            (0.0, 0, 0))]
    noisy = [dict(wall_s=float(rng.uniform(0.05, 0.6)),
                  candidates=int(rng.integers(0, 60)),
                  quarantined=bool(rng.random() < 0.1),
                  dispatch_retries=int(rng.random() < 0.2),
                  headroom_frac=float(rng.uniform(0.0, 0.4)))
             for _ in range(40)]
    return {"storm": storm, "walls": walls, "events": events,
            "recall": recall, "feed": feed, "noisy": noisy}


def _strip_times(snap):
    """``snap`` without the wall-clock stamp ``t`` of each incident: two
    engines updated one after the other stamp their incidents a
    millisecond apart whenever a millisecond boundary falls between
    them, every other field equal."""
    for inc in snap["incidents"]:
        inc.pop("t")
    return snap


def _get_healthz(base):
    """``GET /healthz`` as ``(status, document)``, the incidents' stamps
    dropped (:func:`_strip_times`)."""
    status, body = _get(base + "/healthz")
    return status, _strip_times(json.loads(body))


@pytest.mark.parametrize("name", sorted(_scenarios()))
def test_health_verdicts_equal_jax(name):
    updates = _scenarios()[name]
    ours, theirs = health.HealthEngine(), jax_health.HealthEngine()
    for i, kw in enumerate(updates):
        assert ours.update(i, **kw) == theirs.update(i, **kw), (i, kw)
        assert ours.reasons() == theirs.reasons()
        if i == len(updates) // 2:
            for eng in (ours, theirs):
                eng.note_alert("push", health.DEGRADED, "slow webhook",
                               chunk="push")
        if i == len(updates) // 2 + 2:
            for eng in (ours, theirs):
                eng.resolve_alert("push", chunk="push")
    assert ours.transitions == theirs.transitions
    assert _strip_times(ours.snapshot()) == _strip_times(theirs.snapshot())


# -- the HTTP surface --------------------------------------------------------

def test_surface_answers_as_the_jax_server(sink):
    progress = {"fname": "x.fil", "chunks_done": 2, "chunks_total": 5}
    eng, jeng = health.HealthEngine(), jax_health.HealthEngine()
    broker = push.AlertBroker([sink.url])
    metrics.counter("putpu_chunks_total").inc(3)
    ours = start_obs_server(0, health=eng, progress_fn=lambda: progress,
                            push=broker)
    theirs = jax_server(0, health=jeng, progress_fn=lambda: progress)
    try:
        base = f"http://127.0.0.1:{ours.port}"
        jbase = f"http://127.0.0.1:{theirs.port}"
        status, text = _get(base + "/metrics")
        assert status == 200 and "putpu_chunks_total 3" in text
        assert "# HELP putpu_chunks_total" in text
        assert _get_healthz(base) == _get_healthz(jbase)
        assert _get(base + "/progress") == _get(jbase + "/progress")
        assert _get(base + "/status") == _get(base + "/progress")
        for eng_ in (eng, jeng):
            for i in range(3):
                eng_.update(i, quarantined=True)
        status, body = _get(base + "/healthz")
        assert status == 503 and json.loads(body)["status"] == "CRITICAL"
        assert _get_healthz(base) == _get_healthz(jbase)
        assert _post(base + "/subscribe", {"url": "ftp://x"})[0] == 400
        status, doc = _post(base + "/subscribe",
                            {"url": sink.url, "name": "second",
                             "min_snr": 8.0})
        assert status == 201 and doc["name"] == "second"
        status, body = _get(base + "/subscribers")
        assert status == 200 and len(json.loads(body)["subscribers"]) == 2
        assert _get(base + "/nope")[0] == 404
    finally:
        ours.close()
        theirs.close()
        broker.close()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{ours.port}/healthz",
                               timeout=1.0)


def test_surface_is_scraped_while_the_loop_runs(survey_file, tmp_path):
    port = _free_port()
    engine = health.HealthEngine()
    result = {}

    def run():
        result["out"] = search_by_chunks(
            survey_file, device="cpu", make_plots=False, health=engine,
            http_port=port, canary=1.0, output_dir=str(tmp_path),
            report_out=str(tmp_path / "report"), **SEARCH)

    worker = threading.Thread(target=run)
    worker.start()
    scraped = {}
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while time.time() < deadline and worker.is_alive():
            try:
                status, body = _get(base + "/progress", timeout=2.0)
            except OSError:
                time.sleep(0.02)
                continue
            doc = json.loads(body)
            if doc.get("chunks_done", 0) >= 1:
                scraped["progress"] = doc
                scraped["metrics"] = _get(base + "/metrics")[1]
                scraped["healthz"] = json.loads(_get(base + "/healthz")[1])
                break
            time.sleep(0.02)
    finally:
        worker.join(timeout=300)
    assert not worker.is_alive()
    assert scraped, "the run ended before a scrape landed"
    assert scraped["progress"]["chunks_total"] == 5
    assert "canary" in scraped["progress"]
    assert scraped["healthz"]["status"] in ("OK", "DEGRADED")
    assert "putpu_canary_injected_total" in scraped["metrics"]
    assert "putpu_chunks_total" in scraped["metrics"]
    hits, _ = result["out"]
    assert hits
    md = (tmp_path / "report.md").read_text()
    assert "Canary injection-recovery" in md and "## Health" in md
    with pytest.raises(OSError):
        urllib.request.urlopen(base + "/healthz", timeout=1.0)


# -- lineage -----------------------------------------------------------------

def test_lineage_recorder_docs_equal_jax(monkeypatch):
    docs = []
    for mod in (lineage, jax_lineage):
        ticks = iter(500.0 + 0.125 * i for i in range(1, 100))
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        monkeypatch.setattr(time, "time", lambda: 1.7e9)
        rec = mod.LineageRecorder(fingerprint="fp", source="search_by_chunks")
        for stage in ("read", "dispatch", "read", "ready"):
            rec.mark(4096, stage)
        written = []
        cl = rec.candidate(4096, 8192, name="survey_4096-8192", dm=150.0,
                           snr=9.5, width=0.001)
        rec.persisted(cl, writer=written.append)
        rec.delivered(cl, "hook")
        rec.discard(4096)
        monkeypatch.undo()
        for doc in written:
            doc.pop("trace_id")
        docs.append((written, rec.summary()))
    assert docs[0] == docs[1]
    assert docs[0][0][-1]["delivered_to"] == ["hook"]


def test_lineage_docs_of_both_drivers_equal(survey_file, tmp_path):
    for label, search, kw in (
            ("ours", search_by_chunks, dict(device="cpu", make_plots=False)),
            ("theirs", jax_search_by_chunks, JAX_KW)):
        hits, _ = search(survey_file, output_dir=str(tmp_path / label),
                         lineage=True, **SEARCH, **kw)
        assert hits
    ours = sorted((tmp_path / "ours").glob("*.lineage.json"))
    theirs = sorted((tmp_path / "theirs").glob("*.lineage.json"))
    assert [p.name for p in ours] == [p.name for p in theirs]
    assert ours

    def masked(path):
        doc = json.loads(path.read_text())
        assert len(doc.pop("trace_id")) == 16
        stages = doc.pop("stages")
        # monotone where the stages are causal
        seq = [stages[s] for s in ("read", "dispatch", "ready", "sift",
                                   "persist") if s in stages]
        assert seq == sorted(seq)
        doc["stages"] = sorted(stages)
        for key in ("t0_unix", "fingerprint"):   # the run's, each package's
            doc.pop(key)
        return doc

    for a, b in zip(ours, theirs):
        da, db = masked(a), masked(b)
        assert da.keys() == db.keys()
        assert da.pop("snr") == pytest.approx(db.pop("snr"), rel=1e-5)
        assert da == db
        assert a.read_text().endswith("}\n")


# -- push ---------------------------------------------------------------------

def test_broker_delivers_filters_and_dead_letters_as_jax(sink, tmp_path):
    dead = _free_port()           # nothing listens there
    stats = []
    for mod in (push, jax_push):
        received = len(sink.received)
        broker = mod.AlertBroker(
            [sink.url, {"url": sink.url, "name": "picky", "min_snr": 10.0},
             f"http://127.0.0.1:{dead}/hook"],
            retries=0, timeout_s=2.0,
            dead_letter_path=str(tmp_path / f"{mod.__name__}.jsonl"))
        try:
            for snr in (7.0, 12.0):
                assert broker.publish({"kind": "candidate", "snr": snr,
                                       "dm": 150.0})
        finally:
            stats.append(broker.close(timeout_s=10.0))
        assert len(sink.received) - received == 3
        lines = (tmp_path / f"{mod.__name__}.jsonl").read_text().splitlines()
        assert len(lines) == 2
        assert {json.loads(x)["alert"]["snr"] for x in lines} == {7.0, 12.0}
    assert stats[0] == stats[1]
    assert stats[0]["delivered"] == 3 and stats[0]["filtered"] == 1
    assert stats[0]["dead_lettered"] == 2


def test_drivers_push_the_same_alerts(survey_file, tmp_path, sink):
    alerts = {}
    for label, search, kw in (
            ("ours", search_by_chunks, dict(device="cpu", make_plots=False)),
            ("theirs", jax_search_by_chunks, JAX_KW)):
        start = len(sink.received)
        hits, _ = search(survey_file, output_dir=str(tmp_path / label),
                         push=[{"url": sink.url, "min_snr": 6.0}],
                         lineage=True, **SEARCH, **kw)
        alerts[label] = sorted(sink.received[start:],
                               key=lambda a: a["chunk"])
        assert len(alerts[label]) == len(hits) > 0
        docs = sorted((tmp_path / label).glob("*.lineage.json"))
        assert all(json.loads(p.read_text())["delivered_to"] for p in docs)
    for a, b in zip(alerts["ours"], alerts["theirs"]):
        assert a.pop("snr") == pytest.approx(b.pop("snr"), rel=1e-5)
        a.pop("fingerprint"), b.pop("fingerprint")
        assert a == b
