"""The port's job service (``beams/service.py``, the ``/jobs`` routes of
``obs/server.py``, ``PUmultibeam --serve``), the chunk loop's
``cancel_cb``, the periodicity driver's service hooks and the ledger
merge of ``CandidateStore``, against the JAX package's, on the CPU.

* the ledger: two stores on one directory and fingerprint, marking
  chunks {0, 2} and {1} in turn, end with the file two JAX stores write
  for the same sequence, byte for byte (a store that rewrites the file
  from memory alone keeps only the last writer's chunks);
* the eight contracts of the JAX package's ``test_job_api.py`` on the
  port's service with ``device="cpu"``: the lifecycle over HTTP, bad
  specs answered 400 with the JAX error strings, two tenants co-batched
  (their job documents the JAX service's, wall-clock fields, trace ids
  and directories dropped, floats within :data:`RTOL`), a queued job
  cancelled, a cancelled job resumed from its ledger (each chunk searched
  once over the two runs, the final ledger the uninterrupted run's), the
  503 of ``/healthz`` beside the service, 404 without a service, and a
  failing job that leaves the worker alive;
* a ``workload="periodicity"`` job: its document and candidates those of
  the JAX service's job;
* ``search_by_chunks(cancel_cb=)`` stops before the chunk the JAX driver
  stops before and leaves its ledger (the fingerprints differ: the
  ``done`` list and the candidate files are compared);
  ``periodicity_search`` under ``health=``, ``report_out=`` and
  ``cancel_cb=`` against the JAX driver, ``http_port=``, and
  ``PUperiod --http-port --report-out``;
* the tuner: a one-beam batch after a search of its geometry gets the
  batcher's static kernel, and the search's winner stands;
* ``python -m pulsarutils_tpu_torch.cli.beams_main --serve --http-port 0
  --device cpu`` answers ``POST /jobs`` and stops on SIGINT.

Sockets bind port 0; every server and service is closed in a ``finally``
or a ``with``; every wait has a timeout.
"""
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from pulsarutils_tpu.beams import service as jservice
from pulsarutils_tpu.io.candidates import CandidateStore as JCandidateStore
from pulsarutils_tpu.obs.health import HealthEngine as JHealthEngine
from pulsarutils_tpu.periodicity.driver import \
    periodicity_search as jax_periodicity_search
from pulsarutils_tpu.pipeline.search_pipeline import \
    search_by_chunks as jax_search_by_chunks

from pulsarutils_tpu_torch.beams.service import (CANCELLED, DONE, FAILED,
                                                 QUEUED, SurveyService,
                                                 validate_spec)
from pulsarutils_tpu_torch.io.candidates import CandidateStore
from pulsarutils_tpu_torch.io.sigproc import write_simulated_filterbank
from pulsarutils_tpu_torch.obs import metrics as obs_metrics
from pulsarutils_tpu_torch.obs.health import HealthEngine
from pulsarutils_tpu_torch.obs.server import start_obs_server
from pulsarutils_tpu_torch.periodicity.driver import periodicity_search
from pulsarutils_tpu_torch.pipeline.search_pipeline import search_by_chunks
from pulsarutils_tpu_torch.resilience import ladder

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
#: the port's scorer against the JAX package's (the f32 policy's
#: ``score_rtol``): the coincidence groups carry their S/N
RTOL = 1e-4
#: wall-clock, random and path fields of a job document
VOLATILE = ("submitted_at", "started_at", "finished_at", "trace_id",
            "output_dir", "id", "batch_group")


@pytest.fixture(autouse=True)
def _static(monkeypatch):
    monkeypatch.setenv("PUTPU_AUTOTUNE", "off")
    monkeypatch.delenv("PUTPU_PRECISION", raising=False)
    monkeypatch.delenv("PUTPU_MEM_LIMIT", raising=False)
    ladder.reset()
    yield
    ladder.reset()


# -- the ledger merge ---------------------------------------------------------

@pytest.mark.parametrize("reason", [None, "feed_gap"])
def test_two_stores_ledger_bytes_equal_jax(tmp_path, reason):
    def run(cls, root):
        a = cls(str(root), "cafe0123")
        b = cls(str(root), "cafe0123")
        a.mark_done(0)
        b.mark_done(1, reason=reason)
        a.mark_done(2)
        return (root / "progress_cafe0123.json").read_bytes(), a, b

    ours, a, b = run(CandidateStore, tmp_path / "port")
    theirs, _, _ = run(JCandidateStore, tmp_path / "jax")
    assert ours == theirs
    assert json.loads(ours)["done"] == [0, 1, 2]
    assert a.done_chunks == [0, 1, 2]
    if reason is not None:
        assert json.loads(ours)["quarantined"] == {"1": reason}
    # the store that wrote last reads nothing back while the file is its
    # own; another store's write is merged on its next mark
    b.mark_done(3)
    assert json.loads((tmp_path / "port" / "progress_cafe0123.json")
                      .read_text())["done"] == [0, 1, 2, 3]


def test_ledger_merge_skips_the_read_of_its_own_write(tmp_path,
                                                      monkeypatch):
    store = CandidateStore(str(tmp_path), "beef")
    store.mark_done(0)
    opened = []
    real_open = open

    def spy(path, *args, **kwargs):
        opened.append(str(path))
        return real_open(path, *args, **kwargs)

    monkeypatch.setattr("builtins.open", spy)
    store.mark_done(1)
    assert not any(p.endswith("progress_beef.json") for p in opened)


# -- the job service ------------------------------------------------------------

def write_file(path, nchan=64, nsamples=4096, seed=0, level=10.0):
    rng = np.random.default_rng(seed)
    arr = np.abs(rng.normal(0, 0.5, (nchan, nsamples))) + level
    header = {"bandwidth": 200.0, "fbottom": 1200.0, "nchans": nchan,
              "nsamples": nsamples, "tsamp": 0.0005,
              "foff": 200.0 / nchan}
    write_simulated_filterbank(path, arr, header, descending=True)
    return path


def http_get(base, path):
    try:
        resp = urllib.request.urlopen(base + path, timeout=10.0)
        return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def http_post(base, path, body=None):
    req = urllib.request.Request(
        base + path, method="POST",
        data=json.dumps(body if body is not None else {}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        resp = urllib.request.urlopen(req, timeout=10.0)
        return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def wait_for(predicate, timeout=120.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def spec_for(fname, **kw):
    return {"fname": fname, "dmmin": 100, "dmmax": 200,
            "snr_threshold": 7.0, **kw}


def _close(ours, theirs, path="doc"):
    """Equal documents, floats within :data:`RTOL`."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and set(ours) == set(theirs), path
        for k in theirs:
            _close(ours[k], theirs[k], f"{path}.{k}")
    elif isinstance(theirs, (list, tuple)):
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _close(a, b, f"{path}[{i}]")
    elif isinstance(theirs, float) and not isinstance(theirs, bool):
        assert ours == pytest.approx(theirs, rel=RTOL), path
    else:
        assert ours == theirs, path


def _stable(doc):
    """A job document without its volatile fields; its health keeps the
    reasons that do not read the wall clock (``slow_chunk`` compares
    each chunk's wall time with the run's own baseline)."""
    out = {k: v for k, v in doc.items() if k not in VOLATILE}
    out["health"] = [r for r in doc["health"]["reasons"]
                     if not str(r).startswith("slow_chunk")]
    return out


def test_job_lifecycle_over_http(tmp_path):
    fname = write_file(str(tmp_path / "a.fil"))
    with SurveyService(str(tmp_path / "svc"), batch_window_s=0.0,
                       device="cpu") as svc:
        with start_obs_server(0, service=svc) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            status, doc = http_post(base, "/jobs", spec_for(fname))
            assert status == 201
            job_id = doc["job_id"]
            assert wait_for(lambda: http_get(
                base, f"/jobs/{job_id}")[1]["state"] == DONE)
            status, doc = http_get(base, f"/jobs/{job_id}")
            assert status == 200 and doc["state"] == DONE
            assert doc["chunks_done"] > 0
            assert doc["chunks_total"] == doc["chunks_done"]
            assert doc["error"] is None
            assert doc["started_at"] >= doc["submitted_at"]
            assert doc["finished_at"] >= doc["started_at"]
            assert doc["health"]["status"] in ("OK", "DEGRADED")
            status, listing = http_get(base, "/jobs")
            assert status == 200
            assert [j["id"] for j in listing["jobs"]] == [job_id]


def _bad_specs(fname):
    return [{"fname": "/nope.fil", "dmmin": 1, "dmmax": 2},
            {"dmmin": 1}, "not an object",
            {"fname": fname, "dmmin": 300, "dmmax": 100},
            {"fname": fname, "dmmin": 1, "dmmax": 2, "workload": "fold"},
            {"fname": fname, "dmmin": 1, "dmmax": 2,
             "workload": "periodicity", "canary_rate": 0.1},
            {"fname": fname, "dmmin": 1, "dmmax": 2,
             "workload": "periodicity", "accel_max": -1},
            {"fname": fname, "dmmin": 1, "dmmax": 2,
             "workload": "periodicity", "jerk_max": -1},
            {"fname": fname, "dmmin": 1, "dmmax": 2,
             "workload": "periodicity", "accel_backend": "gpu"},
            {"fname": fname, "dmmin": 1, "dmmax": 2, "n_accel": 3}]


def test_bad_submissions_are_400_with_the_jax_errors(tmp_path):
    fname = write_file(str(tmp_path / "a.fil"))
    for spec in _bad_specs(fname):
        with pytest.raises(ValueError) as ours:
            validate_spec(spec)
        with pytest.raises(ValueError) as theirs:
            jservice.validate_spec(spec)
        assert str(ours.value) == str(theirs.value)
    good = spec_for(fname, workload="single_pulse", max_chunks=2)
    assert validate_spec(good) == jservice.validate_spec(good)
    with SurveyService(str(tmp_path / "svc"), device="cpu") as svc:
        with start_obs_server(0, service=svc) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            for spec in _bad_specs(fname):
                status, body = http_post(base, "/jobs", spec)
                assert status == 400
                with pytest.raises(ValueError) as theirs:
                    jservice.validate_spec(spec)
                assert json.loads(body) == {"error": str(theirs.value)}
            assert http_get(base, "/jobs/job-999")[0] == 404
            assert http_post(base, "/jobs/job-999/cancel")[0] == 404
            assert http_post(base, "/nope")[0] == 404


def _cobatch(cls, out, files, **kw):
    with cls(out, batch_window_s=0.3, **kw) as svc:
        ids = [svc.submit(spec_for(f)) for f in files]
        assert wait_for(lambda: all(svc.get(j)["state"] == DONE
                                    for j in ids))
        return ids, [svc.get(j) for j in ids]


def test_two_tenant_jobs_cobatched_equal_jax(tmp_path):
    files = [write_file(str(tmp_path / f"t{i}.fil"), seed=i)
             for i in (1, 2)]
    ids, docs = _cobatch(SurveyService, str(tmp_path / "svc"), files,
                         device="cpu")
    jids, jdocs = _cobatch(jservice.SurveyService, str(tmp_path / "jsvc"),
                           files)
    d1, d2 = docs
    assert set(d1["batch_group"]) == set(ids) == set(d2["batch_group"])
    assert d1["chunks_done"] == d2["chunks_done"] > 0
    snap = obs_metrics.REGISTRY.snapshot()
    per_job = {r["labels"]["job"]: r["value"] for r in snap
               if r["name"] == "putpu_job_chunks_done_total"
               and r["labels"].get("job") in ids}
    assert per_job[ids[0]] >= d1["chunks_done"]
    assert per_job[ids[1]] >= d2["chunks_done"]
    assert d1["coincidence"]["stats"]["nbeams"] == 2
    # the JAX service's documents, job for job in submission order
    for ours, theirs in zip(docs, jdocs):
        _close(_stable(ours), _stable(theirs))
    assert [d["batch_group"] for d in docs] \
        == [[ids[jids.index(j)] for j in d["batch_group"]] for d in jdocs]


def test_cancel_queued_job_immediately(tmp_path):
    fname = write_file(str(tmp_path / "a.fil"))
    svc = SurveyService(str(tmp_path / "svc"), batch_window_s=5.0,
                        device="cpu")
    try:
        job_id = svc.submit(spec_for(fname))
        doc = svc.cancel(job_id)
        assert doc["state"] in (QUEUED, CANCELLED)
        assert wait_for(lambda: svc.get(job_id)["state"] == CANCELLED,
                        timeout=10.0)
        assert svc.get(job_id)["chunks_done"] == 0
        assert svc.get(job_id)["started_at"] is None
    finally:
        svc.close()


def _cancel_after(svc, job_id, n):
    """Cancel ``job_id`` from its own progress hook once ``n`` chunks are
    through: deterministic, whatever the machine's speed."""
    with svc._lock:
        job = svc._jobs[job_id]
    real = job.health.update

    def update(*args, **kwargs):
        out = real(*args, **kwargs)
        if job.chunks_done >= n:
            svc.cancel(job_id)
        return out

    job.health.update = update


def test_killed_job_resumes_exactly_from_ledger(tmp_path):
    fname = write_file(str(tmp_path / "a.fil"), nsamples=16384, seed=3)
    out = str(tmp_path / "svc")
    with SurveyService(out, batch_window_s=0.5, device="cpu") as svc:
        job_id = svc.submit(spec_for(fname))
        _cancel_after(svc, job_id, 2)
        assert wait_for(lambda: svc.get(job_id)["state"]
                        in (CANCELLED, DONE, FAILED))
        first = svc.get(job_id)
    assert first["state"] == CANCELLED and first["chunks_done"] == 2
    with SurveyService(out, batch_window_s=0.0, device="cpu") as svc2:
        job2 = svc2.submit(spec_for(fname))
        assert wait_for(lambda: svc2.get(job2)["state"] == DONE)
        second = svc2.get(job2)
    assert second["chunks_done"] == second["chunks_total"] - 2
    assert second["chunks_total"] > second["chunks_done"]
    # the uninterrupted run's ledger, byte for byte
    ref = str(tmp_path / "ref")
    with SurveyService(ref, batch_window_s=0.0, device="cpu") as svc3:
        job3 = svc3.submit(spec_for(fname))
        assert wait_for(lambda: svc3.get(job3)["state"] == DONE)
        assert svc3.get(job3)["chunks_done"] == second["chunks_total"]
    ledgers = sorted(p for p in os.listdir(out) if p.startswith("progress"))
    assert ledgers == sorted(p for p in os.listdir(ref)
                             if p.startswith("progress"))
    for name in ledgers:
        assert Path(out, name).read_bytes() == Path(ref, name).read_bytes()


def test_healthz_503_on_critical_unchanged_with_service(tmp_path):
    engine = HealthEngine(recall_min_injected=1, recall_floor=0.9)
    engine.update(0, canary={"injected": 5, "window_recall": 0.0,
                             "window": 5})
    with SurveyService(str(tmp_path / "svc"), device="cpu") as svc:
        with start_obs_server(0, health=engine, service=svc) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            assert http_get(base, "/healthz")[0] == 503
            assert http_get(base, "/jobs")[0] == 200


def test_jobs_endpoint_404_without_service():
    with start_obs_server(0) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        assert http_get(base, "/jobs")[0] == 404
        assert http_get(base, "/jobs/job-1")[0] == 404
        assert http_post(base, "/jobs", {"fname": "x", "dmmin": 1,
                                         "dmmax": 2})[0] == 404
        assert http_post(base, "/jobs/job-1/cancel")[0] == 404
        assert http_get(base, "/healthz")[0] == 200


def test_service_worker_survives_failed_batch(tmp_path):
    good = write_file(str(tmp_path / "good.fil"))
    bad = write_file(str(tmp_path / "bad.fil"), seed=9)
    failed = obs_metrics.counter("putpu_jobs_finished_total",
                                 status=FAILED).value
    with SurveyService(str(tmp_path / "svc"), batch_window_s=0.5,
                       device="cpu") as svc:
        jb = svc.submit(spec_for(bad))
        with open(bad, "r+b") as f:
            f.truncate(200)  # the header survives, the data are gone
        assert wait_for(lambda: svc.get(jb)["state"] not in (QUEUED,
                                                               "running"))
        doc = svc.get(jb)
        assert doc["state"] == FAILED and doc["error"].startswith(
            ("ValueError(", "OSError(", "IndexError(", "RuntimeError("))
        jg = svc.submit(spec_for(good))
        assert wait_for(lambda: svc.get(jg)["state"] == DONE)
    assert obs_metrics.counter("putpu_jobs_finished_total",
                               status=FAILED).value == failed + 1


def test_admission_cap_is_none_on_the_host(tmp_path):
    fname = write_file(str(tmp_path / "a.fil"))
    with SurveyService(str(tmp_path / "svc"), batch_window_s=5.0,
                       device="cpu") as svc:
        job_id = svc.submit(spec_for(fname))
        with svc._lock:
            job = svc._jobs[job_id]
        assert svc._admission_cap(job) is None
        svc.cancel(job_id)


@pytest.mark.parametrize("memo", [True, False])
def test_single_beam_job_after_a_search_keeps_the_search_winner(
        monkeypatch, tmp_path, memo):
    """The beam batcher's single-beam key is the single-chunk search's
    (``batch=1`` adds no suffix): a service running a periodicity job
    (a search of the geometry, tuned to the direct sweep) and then a
    one-file single-pulse job must give the batcher its own candidates'
    static choice and leave the search's winner in memory and on disk."""
    from pulsarutils_tpu_torch.beams.batcher import BeamBatcher
    from pulsarutils_tpu_torch.tuning import autotune as tat
    from pulsarutils_tpu_torch.tuning.cache import TuneCache
    from pulsarutils_tpu_torch.tuning.geometry import geometry_key

    monkeypatch.delenv("PUTPU_AUTOTUNE", raising=False)
    cache = TuneCache(str(tmp_path / "tune.json"))
    key = geometry_key("cpu", 16, 1024, 12, "float32")
    cache.store(key, "pallas")
    tuner = tat.KernelTuner(cache=cache, mode="on", min_elements=0,
                            probe_trials=8,
                            measurer=lambda k, run, reps: 0.01)
    prev = tat.set_tuner(tuner)
    try:
        dms = np.linspace(100, 200, 12)
        geom = (1200.0, 200.0, 0.0005, dms)
        if memo:
            assert tat.resolve_search_kernel(
                16, 1024, 12, None, False, *geom, device="cpu") == "pallas"
        assert tat.resolve_batched_kernel(16, 1024, 12, 1, *geom,
                                          device="cpu") == "roll"
        assert BeamBatcher(16, 1024, dms, *geom[:3], batch_hint=1,
                           device="cpu").kernel == "roll"
        assert tat.resolve_search_kernel(
            16, 1024, 12, None, False, *geom, device="cpu") == "pallas"
        assert TuneCache(str(tmp_path / "tune.json")).lookup(key)[
            "kernel"] == "pallas"
    finally:
        tat.set_tuner(prev)


# -- the periodicity job and the driver's hooks ---------------------------------

PSR_TSAMP, PSR_NCHAN, PSR_NSAMPLES = 0.0005, 32, 16384
PSR_DM, PSR_F0, PSR_ACCEL = 150.0, 492 / (16384 * 0.0005), 9.0e5
JOB = dict(dmmin=130.0, dmmax=170.0, accel_max=1.8e6, n_accel=9,
           sigma_threshold=8.0, chunk_length=4096 * PSR_TSAMP,
           snr_threshold=8.0)


@pytest.fixture(scope="module")
def pulsar_file(tmp_path_factory):
    from pulsarutils_tpu_torch.models.simulate import \
        simulate_accel_pulsar_data

    arr, hdr = simulate_accel_pulsar_data(
        freq=PSR_F0, dm=PSR_DM, accel=PSR_ACCEL, tsamp=PSR_TSAMP,
        nsamples=PSR_NSAMPLES, nchan=PSR_NCHAN, rng=13)
    path = tmp_path_factory.mktemp("psr") / "binary.fil"
    write_simulated_filterbank(str(path), arr, hdr, descending=True)
    return str(path)


def _cands(res):
    return [(c["dm"], c["accel"], c["freq_bin"], c["nharm"])
            for c in res["candidates"]]


def _period_job(cls, out, fname, **kw):
    spec = {"fname": fname, "dmmin": JOB["dmmin"], "dmmax": JOB["dmmax"],
            "workload": "periodicity", "accel_max": JOB["accel_max"],
            "n_accel": JOB["n_accel"], "chunk_length": JOB["chunk_length"],
            "snr_threshold": JOB["snr_threshold"],
            "period_sigma_threshold": JOB["sigma_threshold"]}
    with cls(out, batch_window_s=0.0, **kw) as svc:
        job_id = svc.submit(spec)
        assert wait_for(lambda: svc.get(job_id)["state"]
                        in (DONE, FAILED, CANCELLED), timeout=300)
        return svc.get(job_id)


def test_periodicity_job_equals_jax_service(pulsar_file, tmp_path):
    ours = _period_job(SurveyService, str(tmp_path / "svc"), pulsar_file,
                       device="cpu")
    theirs = _period_job(jservice.SurveyService, str(tmp_path / "jsvc"),
                         pulsar_file)
    assert ours["state"] == DONE and ours["error"] is None
    assert ours["chunks_total"] == ours["chunks_done"] > 0
    period, jperiod = ours["period"], theirs["period"]
    assert period["complete"] and period["kept"] == jperiod["kept"] > 0
    assert period["sift"] == jperiod["sift"]
    for c, j in zip(period["top"], jperiod["top"]):
        assert (c["dm"], c["accel"], c["nharm"]) \
            == (j["dm"], j["accel"], j["nharm"])
        assert c["freq"] == pytest.approx(j["freq"], rel=1e-12)
        assert c["sigma"] == pytest.approx(j["sigma"], rel=RTOL)
    assert abs(period["top"][0]["accel"] - PSR_ACCEL) < 1.0
    _close({k: v for k, v in _stable(ours).items() if k != "period"},
           {k: v for k, v in _stable(theirs).items() if k != "period"})
    from pulsarutils_tpu.periodicity.candidates import load_candidates

    mine, _ = load_candidates(period["candidates_path"])
    ref, _ = load_candidates(jperiod["candidates_path"])
    assert [(c["dm"], c["accel"], c["freq_bin"], c["nharm"]) for c in mine] \
        == [(c["dm"], c["accel"], c["freq_bin"], c["nharm"]) for c in ref]


def _calls_after(n):
    calls = [0]

    def cancel():
        calls[0] += 1
        return calls[0] > n

    return cancel


def _ledger_without_fingerprint(store):
    doc = json.loads(Path(store._ledger_path).read_text())
    doc.pop("fingerprint")
    return doc


def test_search_by_chunks_cancel_cb_equals_jax(pulsar_file, tmp_path):
    kw = dict(dmmin=130.0, dmmax=170.0, chunk_length=1.024,
              snr_threshold=6.0, make_plots=False)
    _, store = search_by_chunks(pulsar_file, device="cpu",
                                output_dir=str(tmp_path / "t"),
                                cancel_cb=_calls_after(3), **kw)
    _, jstore = jax_search_by_chunks(pulsar_file, backend="jax",
                                     kernel="pallas",
                                     output_dir=str(tmp_path / "j"),
                                     cancel_cb=_calls_after(3), **kw)
    assert store.done_chunks == jstore.done_chunks and \
        len(store.done_chunks) == 3
    assert _ledger_without_fingerprint(store) \
        == _ledger_without_fingerprint(jstore)
    assert sorted(p for p in os.listdir(tmp_path / "t")
                  if not p.startswith("progress")) \
        == sorted(p for p in os.listdir(tmp_path / "j")
                  if not p.startswith("progress"))
    # a resumed session searches the rest: the uninterrupted run's ledger
    _, store = search_by_chunks(pulsar_file, device="cpu",
                                output_dir=str(tmp_path / "t"), **kw)
    _, ref = search_by_chunks(pulsar_file, device="cpu",
                              output_dir=str(tmp_path / "ref"), **kw)
    assert Path(store._ledger_path).read_bytes() \
        == Path(ref._ledger_path).read_bytes()
    # cancelled before the first chunk: nothing marked
    _, empty = search_by_chunks(pulsar_file, device="cpu",
                                output_dir=str(tmp_path / "none"),
                                cancel_cb=lambda: True, **kw)
    assert empty.done_chunks == []


def test_periodicity_cancel_cb_equals_jax_and_resumes(pulsar_file,
                                                      tmp_path):
    res = periodicity_search(pulsar_file, output_dir=str(tmp_path / "t"),
                             device="cpu", cancel_cb=_calls_after(2), **JOB)
    ref = jax_periodicity_search(pulsar_file,
                                 output_dir=str(tmp_path / "j"),
                                 progress=False,
                                 cancel_cb=_calls_after(2), **JOB)
    assert res["complete"] is False and ref["complete"] is False
    assert res["candidates"] is None and res["candidates_path"] is None
    assert res["store"].done_chunks == ref["store"].done_chunks
    assert len(res["store"].done_chunks) == 2
    assert _ledger_without_fingerprint(res["store"]) \
        == _ledger_without_fingerprint(ref["store"])
    # resumed: only the missing chunks stream, and the answer is the
    # uninterrupted job's
    calls = []
    again = periodicity_search(pulsar_file, output_dir=str(tmp_path / "t"),
                               device="cpu", chunk_cb=calls.append, **JOB)
    full = jax_periodicity_search(pulsar_file,
                                  output_dir=str(tmp_path / "j2"),
                                  progress=False, **JOB)
    assert again["complete"]
    assert len(calls) == len(again["store"].done_chunks) - 2 > 0
    assert _cands(again) == _cands(full)


def test_periodicity_health_and_report_equal_jax(pulsar_file, tmp_path):
    health, jhealth = HealthEngine(), JHealthEngine()
    res = periodicity_search(pulsar_file, output_dir=str(tmp_path / "t"),
                             device="cpu", canary=True, health=health,
                             report_out=str(tmp_path / "t" / "report"),
                             **JOB)
    ref = jax_periodicity_search(pulsar_file,
                                 output_dir=str(tmp_path / "j"),
                                 progress=False, canary=True,
                                 health=jhealth,
                                 report_out=str(tmp_path / "j" / "report"),
                                 **JOB)
    assert res["canary"]["recovered"] and ref["canary"]["recovered"]
    assert _cands(res) == _cands(ref)
    # the same updates (each chunk, the drain and the canary) and the
    # same reasons, less the wall-clock one
    assert health.snapshot()["updates"] == jhealth.snapshot()["updates"]
    assert [r for r in health.reasons() if r != "slow_chunk"] \
        == [r for r in jhealth.reasons() if r != "slow_chunk"]
    assert obs_metrics.REGISTRY.gauge("putpu_period_canary_recall").value \
        == 1.0
    ours = json.loads((tmp_path / "t" / "report.json").read_text())
    theirs = json.loads((tmp_path / "j" / "report.json").read_text())
    period, jperiod = ours["periodicity"], theirs["periodicity"]
    assert period is not None and set(period) == set(jperiod)
    for key in ("n_dm", "n_accel", "n_jerk", "accel_backend", "nout",
                "rebin", "tsamp", "t_obs_s", "raw_candidates", "kept",
                "rejected"):
        assert period[key] == jperiod[key], key
    assert [(c["dm"], c["accel"], c["nharm"]) for c in period["candidates"]] \
        == [(c["dm"], c["accel"], c["nharm"])
            for c in jperiod["candidates"]]
    md = (tmp_path / "t" / "report.md").read_text()
    assert "## Periodicity search" in md and "(tmp_path" not in md


def test_periodicity_http_port_serves_the_accumulation(pulsar_file,
                                                       tmp_path,
                                                       monkeypatch):
    from pulsarutils_tpu_torch.pipeline import search_pipeline

    seen = {}
    real = search_pipeline.start_obs_server

    def start(port, **kwargs):
        srv = real(port, **kwargs)
        seen["status"] = http_get(f"http://127.0.0.1:{srv.port}",
                                  "/progress")[0]
        seen["healthz"] = http_get(f"http://127.0.0.1:{srv.port}",
                                   "/healthz")[0]
        return srv

    monkeypatch.setattr(search_pipeline, "start_obs_server", start)
    res = periodicity_search(pulsar_file, output_dir=str(tmp_path),
                             device="cpu", http_port=0, **JOB)
    assert res["complete"] and seen == {"status": 200, "healthz": 200}


def test_period_cli_takes_the_report_and_http_flags(pulsar_file, tmp_path,
                                                    monkeypatch):
    from pulsarutils_tpu_torch.cli import period_main
    from pulsarutils_tpu_torch.pipeline import search_pipeline

    served = []
    real = search_pipeline.start_obs_server

    def start(port, **kwargs):
        served.append(port)
        return real(port, **kwargs)

    monkeypatch.setattr(search_pipeline, "start_obs_server", start)
    report = tmp_path / "report"
    assert period_main.main([
        pulsar_file, "--dmmin", "130", "--dmmax", "170", "--accel-max",
        "1.8e6", "--n-accel", "9", "--chunk-length", "2.048",
        "--snr-threshold", "8", "--output-dir", str(tmp_path),
        "--http-port", "0", "--report-out", str(report), "--json",
        "--device", "cpu"]) == 0
    assert served == [0]
    assert "## Periodicity search" in (tmp_path / "report.md").read_text()


# -- PUmultibeam --serve ----------------------------------------------------------

def test_serve_cli_answers_jobs_and_stops_on_sigint(tmp_path):
    fname = write_file(str(tmp_path / "a.fil"))
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               PUTPU_AUTOTUNE="off")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pulsarutils_tpu_torch.cli.beams_main",
         "--serve", "--http-port", "0", "--device", "cpu",
         "--output-dir", str(tmp_path / "out")],
        stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp_path))
    try:
        port = None
        deadline = time.time() + 120
        while port is None and time.time() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            m = re.search(r"job service on http://[\d.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
        assert port, "the service never logged its port"
        base = f"http://127.0.0.1:{port}"
        status, doc = http_post(base, "/jobs", spec_for(fname))
        assert status == 201
        assert wait_for(lambda: http_get(
            base, f"/jobs/{doc['job_id']}")[1]["state"] == DONE)
        assert http_get(base, "/healthz")[0] == 200
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()
