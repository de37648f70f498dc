"""The port's fleet (``fleet/{protocol,coordinator,worker}.py``,
``cli/fleet_main.py``, the ``/fleet`` routes) against the JAX package's,
on the CPU (``device="cpu"``).

* the wire: the lease whitelist is the JAX package's less ``"backend"``,
  and a rejected config, trace context or job spec reads as the JAX
  package's message (its allowed list less ``"backend"``);
* planning: the port's fingerprint is the JAX ``plan_survey``'s with
  ``backend="torch"``, and the port coordinator's unit ids, chunk lists
  and fingerprints are the JAX coordinator's on the same files and
  config (single pulse, two chunks a unit, periodicity);
* the JAX ``test_fleet.py`` contracts on the port: ledger-backed
  sharding and completion, expiry and steal with a duplicate completion,
  a DEGRADED worker starved and recovered, a dead worker's leases
  revoked, drain, the ``chunks=``/``cancel_cb=`` seams, the HTTP surface
  and 404 when unwired, the job handoff, the report section, and
  re-registration after a coordinator restart;
* **a 2-worker port fleet (threads) byte for byte the single-process port
  run**, its ledgers the JAX fleet's bytes (fingerprints aside) and its
  candidate tables within :data:`RTOL` of the JAX tables;
* a SIGKILLed ``fleet_main worker --device cpu`` subprocess holding a
  lease: expiry, a rescue, the single-process run's bytes;
* budget-sized grants and the ``too_large`` reshard as in JAX;
* the device: ``worker`` without a card raises, and the coordinator
  makes no CUDA call (``torch.cuda`` patched to raise).

Sockets bind port 0; every server is closed in a ``finally`` or a
``with``; every wait has a timeout.
"""
import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from pulsarutils_tpu.fleet import protocol as jprotocol
from pulsarutils_tpu.fleet.coordinator import \
    FleetCoordinator as JFleetCoordinator
from pulsarutils_tpu.fleet.worker import FleetWorker as JFleetWorker
from pulsarutils_tpu.obs.server import start_obs_server as jstart_obs_server
from pulsarutils_tpu.pipeline.search_pipeline import \
    plan_survey as jax_plan_survey

from pulsarutils_tpu_torch.fleet import protocol
from pulsarutils_tpu_torch.fleet.coordinator import FleetCoordinator
from pulsarutils_tpu_torch.fleet.worker import FleetWorker
from pulsarutils_tpu_torch.io.candidates import CandidateStore
from pulsarutils_tpu_torch.io.sigproc import write_simulated_filterbank
from pulsarutils_tpu_torch.models.simulate import disperse_array
from pulsarutils_tpu_torch.obs import metrics as obs_metrics
from pulsarutils_tpu_torch.obs.health import HealthEngine
from pulsarutils_tpu_torch.obs.server import start_obs_server
from pulsarutils_tpu_torch.pipeline.search_pipeline import (plan_survey,
                                                            search_by_chunks)
from pulsarutils_tpu_torch.resilience import ladder
from pulsarutils_tpu_torch.utils.table import ResultTable

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TSAMP = 0.0005
NCHAN = 64
#: 24576 samples at chunk_length 8192 * TSAMP: chunks 0 and 8192
NSAMPLES = 24576
CONFIG = dict(dmmin=100, dmmax=200, chunk_length=8192 * TSAMP,
              snr_threshold=6.5)
CPU = {"device": "cpu"}
#: the port's scorer against the JAX package's (the f32 policy's
#: ``score_rtol``)
RTOL = 1e-4


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


def reference_run(fnames, outdir):
    for fname in fnames:
        search_by_chunks(fname, output_dir=str(outdir), make_plots=False,
                         progress=False, **CPU, **CONFIG)


def snapshot_dir(outdir):
    """{name: bytes or npz members} over ledgers and candidates."""
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


def mark_chunks_done(outdir, fingerprint, chunks):
    store = CandidateStore(str(outdir), fingerprint)
    for c in chunks:
        store.mark_done(c)


def counter_value(name):
    return obs_metrics.counter(name).value


def wait_for(cond, timeout=60.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def run_fleet(coordinator, start, make_worker, fnames, n=2, **config):
    """Serve ``coordinator``, shard ``fnames`` and run ``n`` workers in
    threads until the survey is done; returns the workers."""
    with start(0, fleet=coordinator) as srv:
        url = f"http://127.0.0.1:{srv.port}"
        coordinator.add_survey(fnames, **config)
        workers = [make_worker(url) for _ in range(n)]
        threads = [threading.Thread(target=w.run,
                                    kwargs={"max_idle_s": 60.0})
                   for w in workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
        assert coordinator.survey_done
    return workers


def _post_raw(url, doc):
    req = urllib.request.Request(
        url, method="POST", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10.0) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _get_status(url):
    try:
        with urllib.request.urlopen(url, timeout=10.0) as resp:
            return resp.status
    except urllib.error.HTTPError as exc:
        return exc.code


# -- the wire -------------------------------------------------------------------

def test_search_keys_are_jax_less_backend():
    assert tuple(k for k in jprotocol.SEARCH_KEYS if k != "backend") \
        == protocol.SEARCH_KEYS
    assert protocol.TRACE_KEYS == jprotocol.TRACE_KEYS
    assert protocol.PROTOCOL_VERSION == jprotocol.PROTOCOL_VERSION


def _error_text(fn, arg):
    try:
        fn(arg)
    except ValueError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("config", [
    {"output_dir": "/tmp/x"},
    {"dmax": 200},
    {"backend": "jax"},
    {"dmmin": 100, "device": "cuda"},
    ["dmmin"],
])
def test_search_config_rejections_read_as_jax(config):
    ours = _error_text(protocol.clean_search_config, config)
    assert ours is not None
    if isinstance(config, dict) and "backend" in config:
        # the JAX wire carries it; the port's rejects it as unknown
        assert "['backend'] are not leaseable" in ours
        return
    theirs = _error_text(jprotocol.clean_search_config, config)
    assert ours == theirs.replace("'backend', ", "")


def test_search_config_whitelist_passes():
    cfg = protocol.clean_search_config(dict(CONFIG, kernel="hybrid"))
    assert cfg == jprotocol.clean_search_config(dict(CONFIG,
                                                     kernel="hybrid"))
    assert cfg["dmmin"] == 100 and cfg["kernel"] == "hybrid"


@pytest.mark.parametrize("ctx", [
    None, {"trace_id": "a" * 16}, {"trace_id": "a" * 16,
                                   "parent_span_id": "7"},
    {"trace_id": "a" * 16, "parent_span_id": None}, "x", {},
    {"trace_id": ""}, {"trace_id": "a", "future": 1},
    {"trace_id": "a", "parent_span_id": 7},
])
def test_clean_trace_context_as_jax(ctx):
    def run(fn):
        try:
            return ("ok", fn(ctx))
        except ValueError as exc:
            return ("error", str(exc))

    assert run(protocol.clean_trace_context) \
        == run(jprotocol.clean_trace_context)


# -- planning -------------------------------------------------------------------

PLAN_CONFIGS = {
    "single_pulse": dict(CONFIG),
    "floats": dict(dmmin=100.0, dmmax=200.0, chunk_length=4.096,
                   snr_threshold=6.5),
    "hybrid_certifiable": dict(CONFIG, kernel="hybrid",
                               snr_threshold="certifiable"),
    "zero_dm_strict": dict(CONFIG, zero_dm=True,
                           quarantine_policy="strict"),
}


@pytest.mark.parametrize("label", sorted(PLAN_CONFIGS))
def test_plan_fingerprint_is_jax_with_backend_torch(tmp_path, label):
    fname = write_file(tmp_path / "a.fil", seed=3)
    config = PLAN_CONFIGS[label]
    ours = plan_survey(fname, **config)
    theirs = jax_plan_survey(fname, backend="torch", **config)
    assert ours["fingerprint"] == theirs["fingerprint"]
    assert ours["chunk_starts"] == theirs["chunk_starts"]


def test_plan_survey_matches_driver_fingerprint(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=3)
    sp = plan_survey(fname, **CONFIG)
    assert sp["chunk_starts"] == [0, 8192]
    _, store = search_by_chunks(fname, output_dir=str(tmp_path / "out"),
                                make_plots=False, progress=False,
                                max_chunks=1, **CPU, **CONFIG)
    assert store.fingerprint == sp["fingerprint"]
    assert store.done_chunks == sp["chunk_starts"][:1]


SURVEYS = {
    "one_chunk_units": ({}, dict(CONFIG)),
    "two_chunk_units": ({"chunks_per_unit": 2}, dict(CONFIG)),
    "periodicity": ({}, dict(CONFIG, workload="periodicity",
                             accel_max=100.0, n_accel=3)),
}


@pytest.mark.parametrize("label", sorted(SURVEYS))
def test_coordinator_units_equal_jax(tmp_path, label):
    kwargs, config = SURVEYS[label]
    fnames = [write_file(tmp_path / "a.fil", seed=4),
              write_file(tmp_path / "b.fil", seed=5)]
    with FleetCoordinator(str(tmp_path / "port"), auto_sweep=False,
                          **kwargs) as ours, \
            JFleetCoordinator(str(tmp_path / "jax"), auto_sweep=False,
                              **kwargs) as theirs:
        ids = ours.add_survey(fnames, **config)
        jids = theirs.add_survey(fnames, backend="torch", **config)
        assert ids == jids
        assert [u.doc() | {"trace_id": None}
                for u in ours._units.values()] \
            == [u.doc() | {"trace_id": None}
                for u in theirs._units.values()]
        mine, ref = ours.progress_doc(), theirs.progress_doc()
        assert [(f["fname"], f["fingerprint"], f["chunks_total"])
                for f in mine["files"]] \
            == [(f["fname"], f["fingerprint"], f["chunks_total"])
                for f in ref["files"]]
        for fname in fnames:
            a, b = dict(ours._files[fname]), dict(theirs._files[fname])
            for rec in (a, b):
                rec.pop("config")
                if rec["artifact"] is not None:
                    rec["artifact"] = os.path.basename(rec["artifact"])
            assert a == b


# -- the coordinator ------------------------------------------------------------

def test_coordinator_shards_and_skips_ledger_done(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=4)
    out = tmp_path / "fleet"
    with FleetCoordinator(str(out), auto_sweep=False) as coordinator:
        assert len(coordinator.add_survey([fname], **CONFIG)) == 2
        fingerprint = plan_survey(fname, **CONFIG)["fingerprint"]
    mark_chunks_done(out, fingerprint, [0])
    with FleetCoordinator(str(out), auto_sweep=False) as c2:
        assert len(c2.add_survey([fname], **CONFIG)) == 1
        assert c2.progress_doc()["chunks_done"] == 1


def test_lease_complete_lifecycle_resolved_by_ledger(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=5)
    out = tmp_path / "fleet"
    with FleetCoordinator(str(out), auto_sweep=False) as coordinator:
        coordinator.add_survey([fname], **CONFIG)
        fingerprint = coordinator.progress_doc()["files"][0]["fingerprint"]
        w = coordinator.register({"healthz_url": None})["worker"]
        resp = coordinator.lease({"worker": w, "max_units": 2})
        assert len(resp["leases"]) == 2
        lease = resp["leases"][0]
        assert lease["config"]["dmmin"] == 100
        assert lease["output_dir"] == str(out)
        resp2 = coordinator.complete({"worker": w, "lease": lease["lease"],
                                      "unit": lease["unit"],
                                      "error": None})
        assert resp2["unit_done"] is False
        assert resp2["requeued"] == lease["chunks"]
        got = coordinator.lease({"worker": w, "max_units": 1})["leases"][0]
        mark_chunks_done(out, fingerprint, got["chunks"])
        resp3 = coordinator.complete({"worker": w, "lease": got["lease"],
                                      "unit": got["unit"], "error": None})
        assert resp3["unit_done"] is True


def test_lease_expiry_steal_duplicate_completion_idempotent(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=6)
    out = tmp_path / "fleet"
    before = {k: counter_value(f"putpu_fleet_{k}_total")
              for k in ("leases_expired", "duplicate_completions")}
    with FleetCoordinator(str(out), auto_sweep=False,
                          lease_ttl_s=5.0) as coordinator:
        coordinator.add_survey([fname], **CONFIG)
        fingerprint = coordinator.progress_doc()["files"][0]["fingerprint"]
        w1 = coordinator.register({})["worker"]
        w2 = coordinator.register({})["worker"]
        lease1 = coordinator.lease({"worker": w1,
                                    "max_units": 1})["leases"][0]
        swept = coordinator.sweep(now=time.monotonic() + 10.0)
        assert swept["expired"] == [lease1["lease"]]
        assert counter_value("putpu_fleet_leases_expired_total") \
            == before["leases_expired"] + 1
        lease2 = coordinator.lease({"worker": w2,
                                    "max_units": 1})["leases"][0]
        assert (lease2["unit"], lease2["chunks"]) \
            == (lease1["unit"], lease1["chunks"])
        mark_chunks_done(out, fingerprint, lease2["chunks"])
        done = coordinator.complete({"worker": w2, "lease": lease2["lease"],
                                     "unit": lease2["unit"], "error": None})
        assert done["unit_done"] is True
        ledger = snapshot_dir(out)[f"progress_{fingerprint}.json"]
        late = coordinator.complete({"worker": w1, "lease": lease1["lease"],
                                     "unit": lease1["unit"], "error": None})
        assert late["unit_done"] is True and late["requeued"] == []
        assert counter_value("putpu_fleet_duplicate_completions_total") \
            == before["duplicate_completions"] + 1
        assert snapshot_dir(out)[f"progress_{fingerprint}.json"] == ledger


def test_degraded_worker_lease_starvation_and_recovery(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=7)
    sick_engine = HealthEngine()
    sick_engine.update(0, quarantined=True)
    assert sick_engine.verdict == "DEGRADED"
    with start_obs_server(0, health=sick_engine) as sick_srv, \
            start_obs_server(0, health=HealthEngine()) as ok_srv, \
            FleetCoordinator(str(tmp_path / "fleet"), auto_sweep=False,
                             file_affinity=False) as coordinator:
        coordinator.add_survey([fname], **CONFIG)
        sick = coordinator.register(
            {"healthz_url":
             f"http://127.0.0.1:{sick_srv.port}/healthz"})["worker"]
        ok = coordinator.register(
            {"healthz_url":
             f"http://127.0.0.1:{ok_srv.port}/healthz"})["worker"]
        assert coordinator.sweep()["probed"] == {sick: "DEGRADED",
                                                 ok: "OK"}
        denied = coordinator.lease({"worker": sick, "max_units": 1})
        assert denied["leases"] == [] and denied["denied"] == "DEGRADED"
        assert len(coordinator.lease({"worker": ok,
                                      "max_units": 1})["leases"]) == 1
        sick_engine.update(1)
        sick_engine.update(2)
        assert sick_engine.verdict == "OK"
        coordinator.sweep()
        assert len(coordinator.lease({"worker": sick,
                                      "max_units": 1})["leases"]) == 1


def test_dead_worker_probe_revokes_and_requeues(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=8)
    with FleetCoordinator(str(tmp_path / "fleet"), auto_sweep=False,
                          dead_after=2) as coordinator:
        coordinator.add_survey([fname], **CONFIG)
        dead = coordinator.register(
            {"healthz_url": "http://127.0.0.1:9/healthz"})["worker"]
        lease = coordinator.lease({"worker": dead,
                                   "max_units": 1})["leases"][0]
        assert coordinator.sweep()["revoked"] == []
        assert coordinator.sweep()["revoked"] == [lease["lease"]]
        assert coordinator.workers_doc()["workers"][0]["alive"] is False
        alive = coordinator.register({})["worker"]
        again = coordinator.lease({"worker": alive,
                                   "max_units": 1})["leases"]
        assert [le["unit"] for le in again] == [lease["unit"]]


def _budget_sequence(cls, out, fname, config):
    with cls(str(out), auto_sweep=False, chunks_per_unit=2,
             file_affinity=False) as c:
        c.add_survey([fname], **config)
        per = c._files[os.path.abspath(fname)]["chunk_est_bytes"]
        small = c.register({"mem_budget_bytes": int(1.5 * per)})["worker"]
        first = c.lease({"worker": small, "max_units": 1})["leases"]
        big = c.register({})["worker"]
        rest = c.lease({"worker": big, "max_units": 2})["leases"]
        c.release({"worker": big, "leases": [rest[0]["lease"]],
                   "reason": "too_large"})
        units = sorted((u.id, u.chunks, u.attempts, u.state)
                       for u in c._units.values())
        return ([(le["unit"], le["chunks"]) for le in first + rest], units,
                c.workers_doc()["workers"][1]["draining"])


def test_budget_sized_grants_and_too_large_reshard_as_jax(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=9)
    ours = _budget_sequence(FleetCoordinator, tmp_path / "port", fname,
                            CONFIG)
    theirs = _budget_sequence(JFleetCoordinator, tmp_path / "jax", fname,
                              dict(CONFIG, backend="torch"))
    assert ours == theirs
    grants, units, draining = ours
    assert grants[0] == ("u1", [0])          # sized to the small budget
    assert draining is False                 # too_large does not drain


@pytest.mark.parametrize("full_header", [False, True])
def test_unit_fits_preflights_the_workers_budget(tmp_path, monkeypatch,
                                                 full_header):
    """The admission preflight as JAX's: with no budget every unit fits;
    under ``PUTPU_MEM_LIMIT`` a unit is refused as ``too_large`` when its
    header holds the derived keys (``nsamples``, ``fbottom``, ``ftop``:
    the reader's header), and admitted on the ``KeyError`` of the raw
    SIGPROC header, which lacks them, in both packages."""
    import pulsarutils_tpu.io.sigproc as jsigproc

    import pulsarutils_tpu_torch.io.sigproc as sigproc

    fname = write_file(tmp_path / "a.fil", seed=9)
    if full_header:
        for mod in (sigproc, jsigproc):
            header = dict(mod.FilterbankReader(fname).header)
            monkeypatch.setattr(mod, "read_header",
                                lambda path, h=header: (dict(h), None))
    lease = {"fname": fname, "config": dict(CONFIG), "unit": "u1"}
    assert FleetWorker("http://127.0.0.1:9", http_port=None,
                       **CPU)._unit_fits(lease)
    monkeypatch.setenv("PUTPU_MEM_LIMIT", "1000")
    ours = FleetWorker("http://127.0.0.1:9", http_port=None,
                       **CPU)._unit_fits(lease)
    theirs = JFleetWorker("http://127.0.0.1:9",
                          http_port=None)._unit_fits(lease)
    assert ours is theirs is (not full_header)


# -- whole fleets -----------------------------------------------------------------

def _table_cols(path):
    return ResultTable.from_npz(path)


def test_two_worker_fleet_byte_identical_and_as_jax_fleet(tmp_path):
    """A 2-worker port fleet (threads, the real HTTP wire, real
    searches) over a 2-file survey: ledgers and candidates byte for byte
    the single-process port run's; ledgers the JAX fleet's bytes with
    the fingerprint swapped; candidate tables within RTOL of JAX's."""
    fnames = [write_file(tmp_path / "a.fil", seed=0, pulse=True),
              write_file(tmp_path / "b.fil", seed=1)]
    reference_run(fnames, tmp_path / "single")
    out = tmp_path / "fleet"
    with FleetCoordinator(str(out), lease_ttl_s=120.0,
                          probe_interval_s=0.5) as coordinator:
        workers = run_fleet(coordinator, start_obs_server,
                            lambda url: FleetWorker(url, http_port=None,
                                                    **CPU),
                            fnames, **CONFIG)
        assert sum(w.units_done for w in workers) == 4
        fps = {f["fname"]: f["fingerprint"]
               for f in coordinator.progress_doc()["files"]}
    ours = snapshot_dir(out)
    assert snapshot_dir(tmp_path / "single") == ours

    jout = tmp_path / "jax_fleet"
    with JFleetCoordinator(str(jout), lease_ttl_s=120.0,
                           probe_interval_s=0.5) as jc:
        run_fleet(jc, jstart_obs_server,
                  lambda url: JFleetWorker(url, http_port=None),
                  fnames, **CONFIG)
        jfps = {f["fname"]: f["fingerprint"]
                for f in jc.progress_doc()["files"]}
    for fname in fnames:
        mine = (out / f"progress_{fps[fname]}.json").read_bytes()
        theirs = (jout / f"progress_{jfps[fname]}.json").read_bytes()
        assert mine == theirs.replace(jfps[fname].encode(),
                                      fps[fname].encode())
    cands = sorted(p.name for p in out.glob("*.table.npz"))
    assert cands and cands == sorted(p.name
                                     for p in jout.glob("*.table.npz"))
    for name in cands:
        t, j = _table_cols(out / name), _table_cols(jout / name)
        assert list(t.colnames) == list(j.colnames)
        for col in t.colnames:
            a, b = np.asarray(t[col]), np.asarray(j[col])
            if np.issubdtype(a.dtype, np.floating) and col != "DM":
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6)
            else:
                np.testing.assert_array_equal(a, b)


def test_killed_worker_sigkill_mid_lease_byte_identity(tmp_path):
    """SIGKILL a ``fleet_main worker --device cpu`` process wedged at the
    ``fleet`` fault seam while it holds a lease: the lease expires, the
    chunks requeue off the ledger, a rescuer finishes, and the outputs
    are the single-process run's."""
    from pulsarutils_tpu_torch.faults.inject import FaultPlan, FaultSpec

    fname = write_file(tmp_path / "a.fil", seed=0, pulse=True)
    reference_run([fname], tmp_path / "single")
    out = tmp_path / "fleet"
    coordinator = FleetCoordinator(str(out), lease_ttl_s=4.0,
                                   probe_interval_s=0.3)
    srv = start_obs_server(0, fleet=coordinator)
    url = f"http://127.0.0.1:{srv.port}"
    coordinator.add_survey([fname], **CONFIG)
    env = dict(os.environ,
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               PUTPU_FAULT_PLAN=FaultPlan(
                   [FaultSpec(site="fleet", kind="hang", seconds=300.0,
                              times=1)]).to_json())
    victim = subprocess.Popen(
        [sys.executable, "-m", "pulsarutils_tpu_torch.cli.fleet_main",
         "worker", "--coordinator", url, "--worker-id", "victim",
         "--max-idle", "60", "--device", "cpu"],
        env=env, cwd=str(REPO), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        assert wait_for(lambda: coordinator.leases_doc()["leases"],
                        timeout=120.0), "victim never obtained a lease"
        assert coordinator.leases_doc()["leases"][0]["worker"] == "victim"
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=30)
        FleetWorker(url, http_port=None, **CPU).run(max_idle_s=60.0)
        assert coordinator.survey_done
        stats = coordinator.progress_doc()["stats"]
        assert stats["expired"] + stats["revoked"] >= 1
    finally:
        if victim.poll() is None:
            victim.kill()
            victim.wait(timeout=30)
        srv.close()
        coordinator.close()
    assert snapshot_dir(tmp_path / "single") == snapshot_dir(out)


def test_worker_graceful_drain_returns_unstarted_leases(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=9)
    before = counter_value("putpu_fleet_drains_total")
    with FleetCoordinator(str(tmp_path / "fleet"),
                          auto_sweep=False) as coordinator:
        with start_obs_server(0, fleet=coordinator) as srv:
            url = f"http://127.0.0.1:{srv.port}"
            coordinator.add_survey([fname], **CONFIG)
            worker = FleetWorker(url, http_port=None, max_units=2, **CPU)
            orig_run_unit = worker._run_unit

            def drain_after_first(lease):
                result = orig_run_unit(lease)
                worker.drain()
                return result

            worker._run_unit = drain_after_first
            worker.run()
            assert worker.drained is True and worker.units_done == 1
            assert counter_value("putpu_fleet_drains_total") == before + 1
            progress = coordinator.progress_doc()
            assert progress["chunks_done"] == 1
            assert progress["units"] == {"done": 1, "pending": 1}
            assert coordinator.leases_doc()["leases"] == []
            assert all(u.attempts == 0
                       for u in coordinator._units.values())
            denied = coordinator.lease({"worker": worker.worker_id,
                                        "max_units": 1})
            assert denied["denied"] == "draining"
            FleetWorker(url, http_port=None, **CPU).run(max_idle_s=30.0)
            assert coordinator.survey_done


def test_unit_error_is_reported_and_requeued_not_retried(tmp_path,
                                                         monkeypatch):
    """A failing unit's error string reaches the coordinator, which
    requeues it up to ``max_attempts``; the worker stays alive and never
    retries the unit itself."""
    from pulsarutils_tpu_torch.pipeline import search_pipeline

    fname = write_file(tmp_path / "a.fil", seed=10)
    calls = []

    def failing(*a, **kw):
        calls.append(kw.get("device"))
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(search_pipeline, "search_by_chunks", failing)
    with FleetCoordinator(str(tmp_path / "fleet"), auto_sweep=False,
                          max_attempts=2) as coordinator:
        with start_obs_server(0, fleet=coordinator) as srv:
            coordinator.add_survey([fname], **CONFIG)
            worker = FleetWorker(f"http://127.0.0.1:{srv.port}",
                                 http_port=None, poll_s=0.05, **CPU)
            worker.run(max_idle_s=5.0)
        progress = coordinator.progress_doc()
    assert progress["units"] == {"failed": 2}
    assert progress["stats"]["failed"] == 2
    assert worker.units_done == 0
    assert len(calls) == 4 and set(calls) == {torch.device("cpu")}


def test_chunks_and_cancel_cb_driver_seams(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=10)
    out = str(tmp_path / "out")
    _, store = search_by_chunks(fname, output_dir=out, make_plots=False,
                                progress=False, chunks=[8192], **CPU,
                                **CONFIG)
    assert store.done_chunks == [8192]
    _, store2 = search_by_chunks(fname, output_dir=out, make_plots=False,
                                 progress=False, cancel_cb=lambda: True,
                                 **CPU, **CONFIG)
    assert store2.done_chunks == [8192]


def test_fleet_http_surface(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=11)
    with FleetCoordinator(str(tmp_path / "fleet"),
                          auto_sweep=False) as coordinator:
        with start_obs_server(0, fleet=coordinator) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            coordinator.add_survey([fname], **CONFIG)
            reg = protocol.post_json(base + "/fleet/register",
                                     {"healthz_url": None})
            assert reg["protocol_version"] == protocol.PROTOCOL_VERSION
            lease = protocol.post_json(
                base + "/fleet/lease",
                {"worker": reg["worker"], "max_units": 1})["leases"][0]
            mark_chunks_done(tmp_path / "fleet",
                             coordinator.progress_doc()["files"][0]
                             ["fingerprint"], lease["chunks"])
            protocol.post_json(base + "/fleet/complete", {
                "worker": reg["worker"], "lease": lease["lease"],
                "unit": lease["unit"], "error": None,
                "metrics": [{"name": "putpu_chunks_total",
                             "type": "counter", "labels": {},
                             "value": 1}],
                "health": {"status": "OK", "reasons": []}})
            for path in ("/fleet/workers", "/fleet/leases",
                         "/fleet/progress", "/fleet/capacity",
                         "/fleet/history"):
                with urllib.request.urlopen(base + path,
                                            timeout=10.0) as resp:
                    assert resp.status == 200
                    json.loads(resp.read().decode())
            with urllib.request.urlopen(base + "/fleet/metrics",
                                        timeout=10.0) as resp:
                text = resp.read().decode()
            assert ('putpu_chunks_total{worker="%s"} 1'
                    % reg["worker"]) in text
            status, body = _post_raw(base + "/fleet/lease",
                                     {"worker": "nope"})
            assert status == 400 and "unknown worker" in body
            assert json.loads(body)["code"] == "unknown_worker"
            status, body = _post_raw(
                base + "/fleet/complete",
                {"worker": reg["worker"], "lease": "L99",
                 "unit": "u99", "error": None})
            assert status == 400 and "unknown unit" in body
            assert _get_status(base + "/fleet/nothing") == 404
            with urllib.request.urlopen(base + "/", timeout=10.0) as resp:
                index = resp.read().decode()
            for route in ("/metrics/history", "/alerts", "/fleet",
                          "/jobs", "/healthz"):
                assert route in index


@pytest.mark.parametrize("method, path", [
    ("GET", "/fleet/progress"), ("GET", "/fleet/workers"),
    ("GET", "/fleet/leases"), ("GET", "/fleet/capacity"),
    ("GET", "/fleet/history"), ("GET", "/fleet/metrics"),
    ("POST", "/fleet/lease"), ("POST", "/fleet/register"),
])
def test_fleet_endpoints_404_unwired(method, path):
    with start_obs_server(0) as srv:
        url = f"http://127.0.0.1:{srv.port}{path}"
        status = (_get_status(url) if method == "GET"
                  else _post_raw(url, {"worker": "w"})[0])
        assert status == 404


@pytest.mark.parametrize("spec", [
    {"fname": "A", "dmmin": 100, "dmmax": 200, "snr_threshold": 6.5},
    {"fname": "A"},
    {"fname": "A", "dmmin": 100, "dmmax": 200, "canary_rate": 0.5},
    {"fname": "A", "dmmin": 100, "dmmax": 200, "workload": "nope"},
    {"fname": "A", "dmmin": 100, "dmmax": 200, "accel_max": 5.0},
])
def test_add_job_handoff_as_jax(tmp_path, spec):
    fname = write_file(tmp_path / "a.fil", seed=12)
    spec = dict(spec, fname=fname)

    def run(cls, sub):
        with cls(str(tmp_path / sub), auto_sweep=False) as c:
            try:
                return ("ok", c.add_job(spec))
            except ValueError as exc:
                return ("error", str(exc))

    assert run(FleetCoordinator, "port") == run(JFleetCoordinator, "jax")


def test_add_survey_rejections(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=12)
    with FleetCoordinator(str(tmp_path / "fleet"),
                          auto_sweep=False) as coordinator:
        coordinator.add_survey([fname], **CONFIG)
        with pytest.raises(ValueError, match="different search config"):
            coordinator.add_survey([fname], dmmin=100, dmmax=300)
        with pytest.raises(ValueError, match="not leaseable"):
            coordinator.add_survey([fname], backend="jax", **CONFIG)


def test_fleet_report_section(tmp_path):
    from pulsarutils_tpu_torch.obs.report import (render_markdown,
                                                  write_report)

    fname = write_file(tmp_path / "a.fil", seed=13)
    with FleetCoordinator(str(tmp_path / "fleet"),
                          auto_sweep=False) as coordinator:
        coordinator.add_survey([fname], **CONFIG)
        summary = coordinator.summary()
    write_report(str(tmp_path / "report"), meta={"root": "fleet"},
                 fleet=summary)
    with open(str(tmp_path / "report") + ".json") as f:
        md = render_markdown(json.load(f))
    assert "## Fleet" in md
    assert "0/2 chunks completed across the fleet" in md
    write_report(str(tmp_path / "r2"), meta={"root": "solo"})
    with open(str(tmp_path / "r2") + ".json") as f:
        assert "no fleet coordinator" in render_markdown(json.load(f))


def test_worker_reregisters_after_coordinator_restart(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=14)
    first = FleetCoordinator(str(tmp_path / "old"), auto_sweep=False)
    second = None
    try:
        with start_obs_server(0, fleet=first) as srv:
            url = f"http://127.0.0.1:{srv.port}"
            worker = FleetWorker(url, http_port=None, poll_s=0.1, **CPU)
            thread = threading.Thread(target=worker.run,
                                      kwargs={"max_idle_s": 60.0})
            thread.start()
            assert wait_for(lambda: worker.worker_id is not None, 30.0)
            second = FleetCoordinator(str(tmp_path / "fleet"),
                                      auto_sweep=False)
            second.add_survey([fname], **CONFIG)
            srv.fleet = second
            thread.join(timeout=120.0)
            assert not thread.is_alive()
            assert worker.units_done == 2 and second.survey_done
    finally:
        first.close()
        if second is not None:
            second.close()


# -- the device -----------------------------------------------------------------

def test_worker_without_a_card_raises(monkeypatch):
    from pulsarutils_tpu_torch.cli import fleet_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    with pytest.raises(RuntimeError, match="is_available"):
        FleetWorker("http://127.0.0.1:9", http_port=None)
    with pytest.raises(RuntimeError, match="is_available"):
        fleet_main.main(["worker", "--coordinator", "http://127.0.0.1:9"])
    opts = fleet_main.build_parser().parse_args(
        ["worker", "--coordinator", "http://x"])
    assert opts.device == "cuda"
    assert not hasattr(fleet_main.build_parser().parse_args(
        ["coordinator", "--output-dir", "o", "--http-port", "0"]),
        "device")


def test_coordinator_makes_no_cuda_call(tmp_path, monkeypatch):
    """Planning, sharding, leasing, completing and the docs of a
    coordinator touch no ``torch.cuda`` function."""
    fname = write_file(tmp_path / "a.fil", seed=15)

    def forbidden(*a, **kw):
        raise AssertionError("the coordinator called torch.cuda")

    for name in ("is_available", "mem_get_info", "current_device",
                 "device_count", "synchronize", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, forbidden)
    with FleetCoordinator(str(tmp_path / "fleet"), auto_sweep=False,
                          capacity=True) as coordinator:
        coordinator.add_survey([fname], **CONFIG)
        coordinator.add_survey(
            [write_file(tmp_path / "p.fil", seed=16)], workload="periodicity",
            accel_max=100.0, n_accel=3, **CONFIG)
        w = coordinator.register({"mem_budget_bytes": 1 << 40})["worker"]
        lease = coordinator.lease({"worker": w, "max_units": 1})["leases"][0]
        coordinator.complete({"worker": w, "lease": lease["lease"],
                              "unit": lease["unit"], "error": None,
                              "unit_wall_s": 0.1})
        coordinator.sweep()
        for doc in (coordinator.progress_doc(), coordinator.capacity_doc(),
                    coordinator.summary(), coordinator.workers_doc()):
            json.dumps(doc)
