"""The port's fleet journal, coordinator recovery, lease epochs, the
artifact fence and the ``wire`` fault site, against the JAX package's, on
the CPU.

* the journal: append and replay, the torn-tail and version rules, the
  inert ``path=None`` journal;
* the state carried across packages: the records a port coordinator
  journals for a sequence of messages are the JAX coordinator's for the
  same sequence (unit trace ids, random by design, dropped; the JAX
  file record's ``backend`` key dropped), and each package's
  ``recover()`` rebuilds the other's journal to the same units,
  attempts, epochs and id sequences;
* recovery: in-flight units re-stolen at a bumped epoch, a SIGKILLed
  coordinator's survey finished byte for byte as an uninterrupted run,
  the ledgers alone when the journal is gone, and the real CLI:
  ``fleet_main coordinator`` SIGKILLed mid-survey and relaunched with
  ``--recover`` on its port, a ``--device cpu`` worker re-registering;
* epochs: stale ``complete`` and ``release`` rejected idempotently, and
  a partitioned zombie fenced end to end over the wire;
* the fence: a lower epoch refused, ``fence=None`` writing no fence
  file, the fence map's bytes the JAX store's for one sequence of
  writes, and each package's store honouring the other's map;
  ``periodicity_search(fence=)`` writes its candidates through it;
* the ``unknown_worker`` code, ``needs_reregister``, and the ``wire``
  site's drop, duplicate and delay; the ``period`` site propagates.

Sockets bind port 0 (the CLI run takes a free port first); every server
is closed in a ``finally`` or a ``with``; every wait has a timeout.
"""
import glob
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from pulsarutils_tpu.fleet.coordinator import \
    FleetCoordinator as JFleetCoordinator
from pulsarutils_tpu.io.candidates import CandidateStore as JCandidateStore
from pulsarutils_tpu.pipeline.pulse_info import PulseInfo as JPulseInfo
from pulsarutils_tpu.utils.table import ResultTable as JResultTable

from pulsarutils_tpu_torch.faults.inject import FaultPlan, FaultSpec
from pulsarutils_tpu_torch.fleet import protocol
from pulsarutils_tpu_torch.fleet.coordinator import FleetCoordinator
from pulsarutils_tpu_torch.fleet.journal import (JOURNAL_NAME,
                                                 JOURNAL_SCHEMA_VERSION,
                                                 FleetJournal)
from pulsarutils_tpu_torch.fleet.worker import FleetWorker, needs_reregister
from pulsarutils_tpu_torch.io.candidates import CandidateStore
from pulsarutils_tpu_torch.io.sigproc import write_simulated_filterbank
from pulsarutils_tpu_torch.models.simulate import disperse_array
from pulsarutils_tpu_torch.obs import metrics as obs_metrics
from pulsarutils_tpu_torch.obs.server import start_obs_server
from pulsarutils_tpu_torch.pipeline.pulse_info import PulseInfo
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


def reference_run(fname, outdir, **config):
    search_by_chunks(fname, output_dir=str(outdir), make_plots=False,
                     progress=False, **CPU, **(config or CONFIG))


def snapshot_dir(outdir):
    """Ledger bytes and npz members; the fence and journal files are not
    part of the science outputs."""
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


# -- the journal ----------------------------------------------------------------

def test_journal_append_replay_roundtrip(tmp_path):
    journal = FleetJournal.in_dir(tmp_path)
    journal.append("file", fname="/a.fil", fingerprint="f" * 16)
    journal.append("unit", unit="u1", fname="/a.fil", chunks=[0, 8192])
    records = FleetJournal.in_dir(tmp_path).replay()
    assert [r["kind"] for r in records] == ["file", "unit"]
    assert records[1]["chunks"] == [0, 8192]
    with open(journal.path) as f:
        first = json.loads(f.readline())
    assert first == {"kind": "header",
                     "schema_version": JOURNAL_SCHEMA_VERSION}


def test_journal_bytes_equal_jax(tmp_path):
    from pulsarutils_tpu.fleet.journal import FleetJournal as JFleetJournal

    for cls, sub in ((FleetJournal, "port"), (JFleetJournal, "jax")):
        j = cls.in_dir(tmp_path / sub)
        j.append("file", fname="/a.fil", fingerprint="f" * 16,
                 config={"dmmin": 100.0}, chunk_starts=[0, 8192])
        j.append("requeue", unit="u1", attempts=1, epoch=2, why="x")
        j.close()
    assert (tmp_path / "port" / JOURNAL_NAME).read_bytes() \
        == (tmp_path / "jax" / JOURNAL_NAME).read_bytes()


def test_journal_none_path_is_inert(tmp_path):
    journal = FleetJournal(None)
    journal.append("unit", unit="u1")
    assert journal.replay() == []
    assert list(tmp_path.iterdir()) == []


def test_torn_journal_tail_truncated_to_corrupt(tmp_path):
    journal = FleetJournal.in_dir(tmp_path)
    journal.append("unit", unit="u1", chunks=[0])
    journal.append("unit", unit="u2", chunks=[8192])
    blob = Path(journal.path).read_bytes()
    Path(journal.path).write_bytes(blob[: len(blob) - 9])
    records = FleetJournal.in_dir(tmp_path).replay()
    assert [r["unit"] for r in records] == ["u1"]
    assert os.path.exists(journal.path + ".corrupt")
    journal2 = FleetJournal.in_dir(tmp_path)
    journal2.append("unit", unit="u3", chunks=[16384])
    assert [r["unit"] for r in FleetJournal.in_dir(tmp_path).replay()] \
        == ["u1", "u3"]


def test_unterminated_final_line_is_torn(tmp_path):
    journal = FleetJournal.in_dir(tmp_path)
    journal.append("unit", unit="u1")
    with open(journal.path, "a") as f:
        f.write(json.dumps({"kind": "unit", "unit": "u2"}))
    assert [r["unit"] for r in FleetJournal.in_dir(tmp_path).replay()] \
        == ["u1"]


def test_version_mismatched_journal_rejected_not_corrupt(tmp_path):
    path = os.path.join(str(tmp_path), JOURNAL_NAME)
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "header", "schema_version": 999})
                + "\n")
        f.write(json.dumps({"kind": "unit", "unit": "u1"}) + "\n")
    journal = FleetJournal.in_dir(tmp_path)
    assert journal.replay() == []
    assert os.path.exists(path + ".stale")
    assert not os.path.exists(path + ".corrupt")
    journal.append("unit", unit="u2")
    assert [r["unit"] for r in FleetJournal.in_dir(tmp_path).replay()] \
        == ["u2"]


def test_torn_header_journal_recovers_cleanly(tmp_path):
    path = os.path.join(str(tmp_path), JOURNAL_NAME)
    with open(path, "w") as f:
        f.write('{"kind": "header", "schema_ver')
    journal = FleetJournal.in_dir(tmp_path)
    assert journal.replay() == []
    journal.append("unit", unit="u1")
    assert [r["unit"] for r in FleetJournal.in_dir(tmp_path).replay()] \
        == ["u1"]
    assert not os.path.exists(path + ".stale")


def test_journal_append_after_replay_truncation(tmp_path):
    journal = FleetJournal.in_dir(tmp_path)
    journal.append("unit", unit="u1")
    with open(journal.path, "rb+") as f:
        f.seek(-5, os.SEEK_END)
        f.truncate()
    assert [r["unit"] for r in journal.replay()] == []
    journal.append("unit", unit="u2")
    assert [r["unit"] for r in FleetJournal.in_dir(tmp_path).replay()] \
        == ["u2"]


# -- the journal across packages -----------------------------------------------

def _drive(coordinator, fname, config):
    """One sequence of messages: a survey, an error completion, a
    regrant, an expiry, a steal and a release."""
    coordinator.add_survey([fname], **config)
    w1 = coordinator.register({})["worker"]
    w2 = coordinator.register({})["worker"]
    lease = coordinator.lease({"worker": w1, "max_units": 1})["leases"][0]
    coordinator.complete({"worker": w1, "lease": lease["lease"],
                          "unit": lease["unit"], "error": "boom",
                          "epoch": lease["epoch"]})
    coordinator.lease({"worker": w1, "max_units": 1})
    coordinator.sweep(now=time.monotonic() + 10.0)
    stolen = coordinator.lease({"worker": w2, "max_units": 2})["leases"]
    coordinator.release({"worker": w2, "leases": [stolen[-1]["lease"]],
                         "epochs": {stolen[-1]["lease"]:
                                    stolen[-1]["epoch"]},
                         "reason": "drain"})
    return coordinator.journal.path


def _records(path):
    out = []
    for line in Path(path).read_text().splitlines():
        rec = json.loads(line)
        rec.pop("trace_id", None)
        if rec.get("kind") == "file":
            rec["config"] = {k: v for k, v in rec["config"].items()
                             if k != "backend"}
        out.append(rec)
    return out


def test_journal_records_equal_jax_coordinator(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=30)
    with FleetCoordinator(str(tmp_path / "port"), auto_sweep=False,
                          lease_ttl_s=5.0) as ours, \
            JFleetCoordinator(str(tmp_path / "jax"), auto_sweep=False,
                              lease_ttl_s=5.0) as theirs:
        mine = _records(_drive(ours, fname, CONFIG))
        ref = _records(_drive(theirs, fname, dict(CONFIG, backend="torch")))
    kinds = [r["kind"] for r in mine]
    assert {"header", "file", "unit", "grant", "requeue"} <= set(kinds)
    assert mine == ref


def _recovered_state(coordinator):
    return ({u.id: (u.fname, u.chunks, u.attempts, u.epoch, u.state)
             for u in coordinator._units.values()},
            list(coordinator._pending), dict(coordinator._seq),
            {f: (r["fingerprint"], r["chunk_starts"])
             for f, r in coordinator._files.items()})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_replays_in_both_packages(tmp_path, writer):
    """The state carried across packages: the journal one package's
    coordinator wrote recovers to the same units, attempts, epochs and
    id sequences in both."""
    fname = write_file(tmp_path / "a.fil", seed=31)
    src = tmp_path / "src"
    if writer == "port":
        first = FleetCoordinator(str(src), auto_sweep=False,
                                 lease_ttl_s=5.0)
        _drive(first, fname, CONFIG)
    else:
        first = JFleetCoordinator(str(src), auto_sweep=False,
                                  lease_ttl_s=5.0)
        _drive(first, fname, dict(CONFIG, backend="torch"))
    first.close()
    states = []
    for cls, sub in ((FleetCoordinator, "port"),
                     (JFleetCoordinator, "jax")):
        (tmp_path / sub).mkdir()
        shutil.copy(src / JOURNAL_NAME, tmp_path / sub / JOURNAL_NAME)
        second = cls.recover(str(tmp_path / sub), auto_sweep=False)
        states.append(_recovered_state(second))
        second.close()
    assert states[0] == states[1]
    units = states[0][0]
    assert any(epoch > 1 for _, _, _, epoch, _ in units.values())
    assert any(attempts == 2 for _, _, attempts, _, _ in units.values())


# -- coordinator recovery -------------------------------------------------------

def test_recover_replays_units_attempts_epochs_and_seqs(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=20)
    out = str(tmp_path / "fleet")
    first = FleetCoordinator(out, auto_sweep=False, lease_ttl_s=5.0)
    first.add_survey([fname], **CONFIG)
    w = first.register({})["worker"]
    lease = first.lease({"worker": w, "max_units": 1})["leases"][0]
    assert lease["epoch"] == 1
    first.complete({"worker": w, "lease": lease["lease"],
                    "unit": lease["unit"], "error": "boom",
                    "epoch": lease["epoch"]})
    lease2 = first.lease({"worker": w, "max_units": 1})["leases"][0]
    assert lease2["unit"] == lease["unit"] and lease2["epoch"] == 2
    del first
    second = FleetCoordinator.recover(out, auto_sweep=False,
                                      lease_ttl_s=5.0)
    victim = second._units[lease["unit"]]
    assert victim.attempts == 1
    assert victim.state == "pending" and victim.epoch == 3
    w2 = second.register({})["worker"]
    regrant = second.lease({"worker": w2, "max_units": 1})["leases"][0]
    assert regrant["lease"] != lease2["lease"]
    assert regrant["epoch"] == 3
    second.close()


def test_recover_finishes_survey_byte_identical(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=0, pulse=True)
    reference_run(fname, tmp_path / "single")
    out = str(tmp_path / "fleet")
    before = counter_value("putpu_fleet_recoveries_total")
    first = FleetCoordinator(out, auto_sweep=False, lease_ttl_s=60.0)
    with start_obs_server(0, fleet=first) as srv:
        url = f"http://127.0.0.1:{srv.port}"
        first.add_survey([fname], **CONFIG)
        worker = FleetWorker(url, http_port=None, **CPU)
        orig = worker._run_unit

        def drain_after_first(lease):
            result = orig(lease)
            worker.drain()
            return result

        worker._run_unit = drain_after_first
        worker.run()
        assert worker.units_done == 1
        ghost = first.register({})["worker"]
        stranded = first.lease({"worker": ghost,
                                "max_units": 1})["leases"][0]
    del first
    second = FleetCoordinator.recover(out, auto_sweep=False,
                                      lease_ttl_s=60.0)
    try:
        assert counter_value("putpu_fleet_recoveries_total") == before + 1
        unit = second._units[stranded["unit"]]
        assert unit.state == "pending" \
            and unit.epoch == stranded["epoch"] + 1
        with start_obs_server(0, fleet=second) as srv:
            finisher = FleetWorker(f"http://127.0.0.1:{srv.port}",
                                   http_port=None, **CPU)
            finisher.run(max_idle_s=60.0)
            assert second.survey_done
    finally:
        second.close()
    assert snapshot_dir(tmp_path / "single") == snapshot_dir(out)


def test_recover_without_journal_falls_back_to_ledgers(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=21, pulse=True)
    reference_run(fname, tmp_path / "single")
    out = str(tmp_path / "fleet")
    fingerprint = plan_survey(fname, **CONFIG)["fingerprint"]
    search_by_chunks(fname, output_dir=out, make_plots=False,
                     progress=False, max_chunks=1, **CPU, **CONFIG)
    journal_path = os.path.join(out, JOURNAL_NAME)
    if os.path.exists(journal_path):
        os.remove(journal_path)
    second = FleetCoordinator.recover(out, auto_sweep=False)
    try:
        assert second._units == {}
        assert len(second.add_survey([fname], **CONFIG)) == 1
        with start_obs_server(0, fleet=second) as srv:
            FleetWorker(f"http://127.0.0.1:{srv.port}", http_port=None,
                        **CPU).run(max_idle_s=60.0)
            assert second.survey_done
    finally:
        second.close()
    assert snapshot_dir(tmp_path / "single") == snapshot_dir(out)
    assert fingerprint in "".join(snapshot_dir(out))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_recover_cli_after_sigkill(tmp_path):
    """``fleet_main coordinator`` SIGKILLed once a chunk is done and
    relaunched with ``--recover`` on the same port: the log shows the
    journal replay, the worker re-registers on ``unknown_worker``, the
    survey finishes, and the outputs are the single-process run's."""
    fname = write_file(tmp_path / "a.fil", seed=0, pulse=True)
    config = dict(dmmin=100.0, dmmax=200.0, chunk_length=8192 * TSAMP,
                  snr_threshold=6.5)
    reference_run(fname, tmp_path / "single", **config)
    out = tmp_path / "fleet"
    port = _free_port()
    cmd = [sys.executable, "-m", "pulsarutils_tpu_torch.cli.fleet_main",
           "coordinator", "--output-dir", str(out), "--http-port",
           str(port), "--dmmin", "100", "--dmmax", "200",
           "--chunk-length", str(8192 * TSAMP), "--snr-threshold", "6.5",
           "--lease-ttl", "60", "--probe-interval", "0.5",
           "--exit-when-done"]
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    logs = [tmp_path / "coord1.log", tmp_path / "coord2.log"]
    procs = []
    url = f"http://127.0.0.1:{port}"
    released = threading.Event()
    worker = FleetWorker(url, http_port=None, poll_s=0.1, **CPU)
    orig = worker._run_unit

    def held_after_first(lease):
        result = orig(lease)
        released.wait(120.0)
        return result

    worker._run_unit = held_after_first
    registrations = []
    orig_register = worker._register

    def counted_register(*a, **kw):
        registrations.append(time.monotonic())
        return orig_register(*a, **kw)

    worker._register = counted_register
    thread = threading.Thread(target=worker.run,
                              kwargs={"max_idle_s": 120.0})
    try:
        with open(logs[0], "w") as fh:
            procs.append(subprocess.Popen(
                cmd + [fname], cwd=str(REPO), env=env, stdout=fh,
                stderr=subprocess.STDOUT))
        thread.start()

        def chunks_done():
            try:
                with urllib.request.urlopen(url + "/fleet/progress",
                                            timeout=5) as resp:
                    return json.loads(resp.read())["chunks_done"] >= 1
            except OSError:
                return False

        assert wait_for(chunks_done, timeout=120.0), logs[0].read_text()
        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait(timeout=30)
        with open(logs[1], "w") as fh:
            procs.append(subprocess.Popen(
                cmd + ["--recover"], cwd=str(REPO), env=env, stdout=fh,
                stderr=subprocess.STDOUT))
        released.set()
        assert procs[1].wait(timeout=180) == 0, logs[1].read_text()
        thread.join(timeout=120.0)
        assert not thread.is_alive()
    finally:
        released.set()
        worker.drain()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        thread.join(timeout=30.0)
    log = logs[1].read_text()
    assert "recovered from journal" in log
    summary = json.loads([ln for ln in log.splitlines()
                          if ln.startswith('{"fleet"')][-1])["fleet"]
    assert summary["survey_done"] and summary["chunks_done"] == 2
    assert worker.units_done == 2
    assert len(registrations) == 2      # the unknown_worker re-register
    assert snapshot_dir(tmp_path / "single") == snapshot_dir(out)


# -- lease epochs ---------------------------------------------------------------

def test_stale_epoch_complete_rejected_idempotently(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=22)
    out = tmp_path / "fleet"
    before = counter_value("putpu_fleet_stale_epoch_rejected_total")
    with FleetCoordinator(str(out), auto_sweep=False,
                          lease_ttl_s=5.0) as coordinator:
        coordinator.add_survey([fname], **CONFIG)
        fingerprint = coordinator.progress_doc()["files"][0]["fingerprint"]
        w1 = coordinator.register({})["worker"]
        w2 = coordinator.register({})["worker"]
        lease1 = coordinator.lease({"worker": w1,
                                    "max_units": 1})["leases"][0]
        coordinator.sweep(now=time.monotonic() + 10.0)
        lease2 = coordinator.lease({"worker": w2,
                                    "max_units": 1})["leases"][0]
        assert lease2["unit"] == lease1["unit"] and lease2["epoch"] == 2
        mark_chunks_done(out, fingerprint, lease2["chunks"])
        done = coordinator.complete({"worker": w2, "lease": lease2["lease"],
                                     "unit": lease2["unit"], "error": None,
                                     "epoch": lease2["epoch"]})
        assert done["unit_done"] is True and "stale" not in done
        ledger = snapshot_dir(out)[f"progress_{fingerprint}.json"]
        late = coordinator.complete({"worker": w1, "lease": lease1["lease"],
                                     "unit": lease1["unit"], "error": None,
                                     "epoch": lease1["epoch"]})
        assert late["stale"] is True and late["unit_done"] is True
        assert late["requeued"] == []
        assert counter_value("putpu_fleet_stale_epoch_rejected_total") \
            == before + 1
        assert coordinator.progress_doc()["stats"]["stale_epochs"] == 1
        assert snapshot_dir(out)[f"progress_{fingerprint}.json"] == ledger


def test_stale_epoch_release_counted_idempotently(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=23)
    before = counter_value("putpu_fleet_stale_epoch_rejected_total")
    with FleetCoordinator(str(tmp_path / "fleet"), auto_sweep=False,
                          lease_ttl_s=5.0) as coordinator:
        coordinator.add_survey([fname], **CONFIG)
        w1 = coordinator.register({})["worker"]
        lease1 = coordinator.lease({"worker": w1,
                                    "max_units": 1})["leases"][0]
        coordinator.sweep(now=time.monotonic() + 10.0)
        pending_before = coordinator.progress_doc()["units"]
        resp = coordinator.release({
            "worker": w1, "leases": [lease1["lease"]],
            "epochs": {lease1["lease"]: lease1["epoch"]},
            "reason": "drain"})
        assert resp["requeued"] == 0
        assert counter_value("putpu_fleet_stale_epoch_rejected_total") \
            == before + 1
        assert coordinator.progress_doc()["units"] == pending_before


def test_partitioned_zombie_fenced_end_to_end(tmp_path):
    """A zombie hangs in the pulse chunk's dispatch past its lease TTL,
    the unit is stolen and finished at a bumped epoch, the zombie's late
    writes are fenced and its completion is stale, and the outputs are
    the single-process run's."""
    fname = write_file(tmp_path / "a.fil", seed=0, pulse=True)
    reference_run(fname, tmp_path / "single")
    out = str(tmp_path / "fleet")
    stale_before = counter_value("putpu_fleet_stale_epoch_rejected_total")
    plan = FaultPlan([FaultSpec(site="dispatch", kind="hang", seconds=6.0,
                                chunks=(8192,), times=1)])
    coordinator = FleetCoordinator(out, lease_ttl_s=2.0,
                                   probe_interval_s=0.25)
    srv = start_obs_server(0, fleet=coordinator)
    url = f"http://127.0.0.1:{srv.port}"
    coordinator.add_survey([fname], **CONFIG)
    try:
        with plan.armed():
            zombie = FleetWorker(url, http_port=None, max_units=1, **CPU)
            zt = threading.Thread(target=zombie.run,
                                  kwargs={"max_idle_s": 60.0})
            zt.start()
            assert wait_for(lambda: coordinator.progress_doc()["stats"]
                            ["expired"] >= 1, timeout=60.0)
            FleetWorker(url, http_port=None, **CPU).run(max_idle_s=30.0)
            zt.join(timeout=120.0)
            assert not zt.is_alive()
        assert coordinator.survey_done
        stats = coordinator.progress_doc()["stats"]
    finally:
        srv.close()
        coordinator.close()
    assert counter_value("putpu_fleet_stale_epoch_rejected_total") \
        > stale_before
    assert stats["stale_epochs"] >= 1
    assert snapshot_dir(tmp_path / "single") == snapshot_dir(out)


# -- the artifact fence ---------------------------------------------------------

def _payload(info_cls, table_cls, value):
    info = info_cls(allprofs=np.full((4, 16), value, np.float32))
    table = table_cls({"DM": np.array([150.0]), "Sigma": np.array([9.0]),
                       "peak": np.array([5])})
    return info, table


def test_candidate_store_fence_rejects_lower_epoch(tmp_path):
    before = counter_value("putpu_fleet_fenced_writes_total")
    fp = "a" * 16
    owner = CandidateStore(str(tmp_path), fp, fence=2)
    owner.mark_done(0)
    owner.save_candidate("s", 0, 16, *_payload(PulseInfo, ResultTable, 2.0))
    ref = snapshot_dir(tmp_path)
    zombie = CandidateStore(str(tmp_path), fp, fence=1)
    base = zombie.save_candidate("s", 0, 16,
                                 *_payload(PulseInfo, ResultTable, 1.0))
    assert base.endswith("s_0-16")
    assert zombie.fenced_rejects == 1
    assert counter_value("putpu_fleet_fenced_writes_total") == before + 1
    assert snapshot_dir(tmp_path) == ref
    newer = CandidateStore(str(tmp_path), fp, fence=3)
    newer.save_candidate("s", 0, 16, *_payload(PulseInfo, ResultTable, 3.0))
    assert snapshot_dir(tmp_path) != ref and newer.fenced_rejects == 0
    with open(os.path.join(str(tmp_path), f"fence_{fp}.json")) as f:
        assert json.load(f)["epochs"]["s_0-16"] == 3


def _fence_sequence(store_cls, info_cls, table_cls, root):
    fp = "c" * 16
    for epoch, name, start in ((2, "b", 16), (1, "a", 0), (3, "b", 16),
                               (1, "b", 16)):
        store_cls(str(root), fp, fence=epoch).save_candidate(
            name, start, start + 16,
            *_payload(info_cls, table_cls, float(epoch)))
    store_cls(str(root), fp, fence=4).fenced_write(
        os.path.join(str(root), "period_cands_x.npz"), lambda: None)
    return (Path(root) / f"fence_{fp}.json").read_bytes()


def test_fence_map_bytes_equal_jax(tmp_path):
    ours = _fence_sequence(CandidateStore, PulseInfo, ResultTable,
                           tmp_path / "port")
    theirs = _fence_sequence(JCandidateStore, JPulseInfo, JResultTable,
                             tmp_path / "jax")
    assert ours == theirs
    assert json.loads(ours)["epochs"] == {"a_0-16": 1, "b_16-32": 3,
                                          "period_cands_x.npz": 4}
    assert not list(Path(tmp_path / "port").glob("*.lock"))


@pytest.mark.parametrize("owner_pkg", ["port", "jax"])
def test_stores_honour_each_others_fence(tmp_path, owner_pkg):
    """A store of one package stamps epoch 3; the other package's store
    at epoch 2 is refused and the owner's bytes stand, at epoch 4 it
    writes."""
    fp = "d" * 16
    cls = {"port": (CandidateStore, PulseInfo, ResultTable),
           "jax": (JCandidateStore, JPulseInfo, JResultTable)}
    owner = cls[owner_pkg]
    other = cls["jax" if owner_pkg == "port" else "port"]
    owner[0](str(tmp_path), fp, fence=3).save_candidate(
        "s", 0, 16, *_payload(owner[1], owner[2], 3.0))
    ref = snapshot_dir(tmp_path)
    zombie = other[0](str(tmp_path), fp, fence=2)
    zombie.save_candidate("s", 0, 16, *_payload(other[1], other[2], 2.0))
    assert zombie.fenced_rejects == 1 and snapshot_dir(tmp_path) == ref
    newer = other[0](str(tmp_path), fp, fence=4)
    newer.save_candidate("s", 0, 16, *_payload(other[1], other[2], 4.0))
    assert newer.fenced_rejects == 0 and snapshot_dir(tmp_path) != ref
    doc = json.loads((tmp_path / f"fence_{fp}.json").read_text())
    assert doc == {"schema_version": 1, "epochs": {"s_0-16": 4}}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_candidate_store_reads_back_across_packages(tmp_path, writer):
    """A ledger and a candidate pair written by one package's store read
    back in the other's (the fleet's shared directory)."""
    cls = {"port": (CandidateStore, PulseInfo, ResultTable),
           "jax": (JCandidateStore, JPulseInfo, JResultTable)}
    w = cls[writer]
    r = cls["jax" if writer == "port" else "port"]
    fp = "f" * 16
    store = w[0](str(tmp_path), fp, fence=1)
    store.mark_done(8192)
    store.mark_done(0, reason="feed_gap")
    info, table = _payload(w[1], w[2], 5.0)
    store.save_candidate("s", 0, 16, info, table)
    other = r[0](str(tmp_path), fp)
    assert other.done_chunks == [0, 8192]
    assert other.quarantined_chunks == {"0": "feed_gap"}
    assert list(other.candidates()) == [("s", 0, 16)]
    got_info, got_table = other.load_candidate("s", 0, 16)
    np.testing.assert_array_equal(got_info.allprofs, info.allprofs)
    assert list(got_table.colnames) == list(table.colnames)
    for col in table.colnames:
        np.testing.assert_array_equal(got_table[col], table[col])


def test_fence_unset_is_byte_inert(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=0, pulse=True)
    reference_run(fname, tmp_path / "plain")
    assert not glob.glob(os.path.join(str(tmp_path / "plain"), "fence_*"))
    search_by_chunks(fname, output_dir=str(tmp_path / "fenced"),
                     make_plots=False, progress=False, fence=1, **CPU,
                     **CONFIG)
    assert snapshot_dir(tmp_path / "plain") \
        == snapshot_dir(tmp_path / "fenced")
    assert glob.glob(os.path.join(str(tmp_path / "fenced"),
                                  "fence_*.json"))


def test_fenced_write_guards_arbitrary_artifacts(tmp_path):
    fp = "b" * 16
    target = os.path.join(str(tmp_path), f"period_cands_s_{fp}.npz")
    owner = CandidateStore(str(tmp_path), fp, fence=2)
    assert owner.fenced_write(
        target, lambda: np.savez(target, x=np.array([2.0]))) is True
    zombie = CandidateStore(str(tmp_path), fp, fence=1)
    assert zombie.fenced_write(
        target, lambda: np.savez(target, x=np.array([1.0]))) is False
    with np.load(target) as z:
        assert z["x"][0] == 2.0
    assert not os.path.exists(
        os.path.join(str(tmp_path), f"fence_{fp}.json.lock"))
    plain = CandidateStore(str(tmp_path / "plain"), fp)
    other = os.path.join(str(tmp_path / "plain"), "x.npz")
    assert plain.fenced_write(
        other, lambda: np.savez(other, x=np.array([0.0]))) is True


def test_abandoned_fence_lock_is_broken(tmp_path):
    fp = "e" * 16
    store = CandidateStore(str(tmp_path), fp, fence=1)
    lock = tmp_path / f"fence_{fp}.json.lock"
    lock.write_text("")
    t0 = time.monotonic()
    with store._fence_lock(timeout_s=0.2):
        assert lock.exists()
    assert time.monotonic() - t0 >= 0.2
    assert not lock.exists()


# -- the periodicity driver's fence and fault seam ------------------------------

PERIOD = dict(dmmin=100.0, dmmax=200.0, accel_max=0.0, n_accel=1,
              chunk_length=8192 * TSAMP, snr_threshold=6.5)


def test_periodicity_search_fence_and_period_site(tmp_path):
    from pulsarutils_tpu_torch.periodicity.driver import periodicity_search

    fname = write_file(tmp_path / "a.fil", seed=0, pulse=True)
    plain = periodicity_search(fname, output_dir=str(tmp_path / "plain"),
                               progress=False, **CPU, **PERIOD)
    assert not glob.glob(str(tmp_path / "plain" / "fence_*"))
    out = tmp_path / "fenced"
    res = periodicity_search(fname, output_dir=str(out), progress=False,
                             fence=2, **CPU, **PERIOD)
    assert res["complete"]
    name = os.path.basename(res["candidates_path"])
    assert name == os.path.basename(plain["candidates_path"])
    fence = json.loads(next(out.glob("fence_*.json")).read_text())
    assert fence["epochs"][name] == 2
    # a zombie at a lower epoch redoes the sweep; its npz is refused
    before = (out / name).read_bytes()
    os.utime(out / name, (0, 0))
    zombie = periodicity_search(fname, output_dir=str(out), progress=False,
                                fence=1, **CPU, **PERIOD)
    assert zombie["store"].fenced_rejects >= 1
    assert (out / name).read_bytes() == before
    assert os.stat(out / name).st_mtime == 0
    # the period site: a firing propagates out of the job
    plan = FaultPlan([FaultSpec(site="period", kind="error", times=1)])
    with plan.armed(), pytest.raises(RuntimeError, match="period"):
        periodicity_search(fname, output_dir=str(tmp_path / "fault"),
                           progress=False, **CPU, **PERIOD)
    assert plan.fired("period") == 1


# -- the structured code and the wire site ---------------------------------------

def test_unknown_worker_carries_structured_code(tmp_path):
    with FleetCoordinator(str(tmp_path / "fleet"),
                          auto_sweep=False) as coordinator:
        with start_obs_server(0, fleet=coordinator) as srv:
            with pytest.raises(ValueError) as err:
                protocol.post_json(
                    f"http://127.0.0.1:{srv.port}/fleet/lease",
                    {"worker": "ghost"})
            assert err.value.code == "unknown_worker"
            assert "unknown worker" in str(err.value)


@pytest.mark.parametrize("exc, expected", [
    (protocol.ProtocolError("anything at all", code="unknown_worker"), True),
    (protocol.ProtocolError("unknown worker 'w1'", code="bad_request"),
     False),
    (ValueError("HTTP 400: unknown worker 'w1'"), True),
    (ValueError("HTTP 400: malformed lease"), False),
])
def test_needs_reregister_code_and_text_fallback(exc, expected):
    from pulsarutils_tpu.fleet.worker import \
        needs_reregister as jax_needs_reregister

    assert needs_reregister(exc) is expected
    assert jax_needs_reregister(exc) is expected


def test_wire_drop_consumes_retries_then_lands(tmp_path):
    before = counter_value("putpu_fleet_wire_retries_total")
    with FleetCoordinator(str(tmp_path / "fleet"),
                          auto_sweep=False) as coordinator:
        with start_obs_server(0, fleet=coordinator) as srv:
            url = f"http://127.0.0.1:{srv.port}"
            plan = FaultPlan([FaultSpec(site="wire", kind="drop",
                                        msg="register", times=2)])
            with plan.armed():
                doc = protocol.post_json_retry(
                    url + "/fleet/register", {"healthz_url": None},
                    retries=3, backoff_s=0.01, jitter_s=0.0)
            assert doc["worker"] and plan.fired() == 2
            assert counter_value("putpu_fleet_wire_retries_total") \
                == before + 2
            full = FaultPlan([FaultSpec(site="wire", kind="drop",
                                        times=None)])
            with full.armed(), pytest.raises(OSError):
                protocol.post_json_retry(
                    url + "/fleet/register", {"healthz_url": None},
                    retries=1, backoff_s=0.01, jitter_s=0.0)


def test_wire_msg_selector_skips_other_messages():
    plan = FaultPlan([FaultSpec(site="wire", kind="drop", msg="lease",
                                times=1)])
    assert plan.wire_action("wire", msg="register") is None
    assert plan.wire_action("wire", msg="lease") == ("drop", 60.0)
    assert plan.wire_action("wire", msg="lease") is None
    spec = json.loads(plan.to_json())["specs"][0]
    assert spec["msg"] == "lease"
    assert FaultPlan.from_json(plan.to_json()).specs[0].msg == "lease"


def test_wire_duplicate_complete_is_idempotent(tmp_path):
    fname = write_file(tmp_path / "a.fil", seed=26)
    out = tmp_path / "fleet"
    before = counter_value("putpu_fleet_duplicate_completions_total")
    with FleetCoordinator(str(out), auto_sweep=False) as coordinator:
        with start_obs_server(0, fleet=coordinator) as srv:
            url = f"http://127.0.0.1:{srv.port}"
            coordinator.add_survey([fname], **CONFIG)
            fingerprint = coordinator.progress_doc()["files"][0][
                "fingerprint"]
            w = coordinator.register({})["worker"]
            lease = coordinator.lease({"worker": w,
                                       "max_units": 1})["leases"][0]
            mark_chunks_done(out, fingerprint, lease["chunks"])
            plan = FaultPlan([FaultSpec(site="wire", kind="duplicate",
                                        msg="complete", times=1)])
            with plan.armed():
                resp = protocol.post_json_retry(
                    url + "/fleet/complete",
                    {"worker": w, "lease": lease["lease"],
                     "unit": lease["unit"], "error": None,
                     "epoch": lease["epoch"]})
            assert plan.fired() == 1 and resp["unit_done"] is True
            assert counter_value(
                "putpu_fleet_duplicate_completions_total") == before + 1


def test_wire_duplicate_timing_brackets_one_exchange(monkeypatch):
    calls = []

    def fake_post(url, doc, timeout=10.0):
        calls.append(time.time())
        time.sleep(0.15)
        return {"ok": True}

    monkeypatch.setattr(protocol, "post_json", fake_post)
    plan = FaultPlan([FaultSpec(site="wire", kind="duplicate", times=1)])
    timing = {}
    with plan.armed():
        protocol.post_json_retry("http://x/fleet/lease", {}, timing=timing)
    assert len(calls) == 2
    assert timing["t1"] <= calls[1]
    assert timing["t1"] - timing["t0"] < 0.3


def test_wire_delay_just_delays(tmp_path):
    with FleetCoordinator(str(tmp_path / "fleet"),
                          auto_sweep=False) as coordinator:
        with start_obs_server(0, fleet=coordinator) as srv:
            url = f"http://127.0.0.1:{srv.port}"
            plan = FaultPlan([FaultSpec(site="wire", kind="delay",
                                        seconds=0.4, msg="register",
                                        times=1)])
            t0 = time.time()
            with plan.armed():
                doc = protocol.post_json_retry(url + "/fleet/register",
                                               {"healthz_url": None})
            assert doc["worker"] and time.time() - t0 >= 0.4
