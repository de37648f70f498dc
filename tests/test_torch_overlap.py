"""The overlapped chunk loop on the CPU: the reader's two-part read, the
staging buffers, and the overlapped loop against the serial one (byte-equal
ledgers, equal candidate contents) and against the JAX driver, with resume
after an interrupt, persist backpressure and the shutdown on error."""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from pulsarutils_tpu.io.sigproc import FilterbankReader as JaxReader
from pulsarutils_tpu.pipeline.search_pipeline import \
    search_by_chunks as jax_search_by_chunks

from pulsarutils_tpu_torch.faults import FaultPlan, FaultSpec
from pulsarutils_tpu_torch.io.candidates import CandidateStore
from pulsarutils_tpu_torch.io.sigproc import (FilterbankReader,
                                              write_simulated_filterbank)
from pulsarutils_tpu_torch.models.simulate import simulate_test_data
from pulsarutils_tpu_torch.pipeline import search_pipeline
from pulsarutils_tpu_torch.pipeline.search_pipeline import search_by_chunks
from pulsarutils_tpu_torch.utils.staging import FrameStaging

torch.set_num_threads(1)

PULSE_DM = 150.0
NSAMPLES = 16384
SEARCH = dict(dmmin=100.0, dmmax=200.0, chunk_length=1.024,
              snr_threshold=6.0)


@pytest.fixture(scope="module")
def pulse_file(tmp_path_factory):
    """The pipeline tests' 8-bit file: one dispersed pulse mid-file."""
    array, header = simulate_test_data(PULSE_DM, nsamples=NSAMPLES, nchan=32,
                                       signal=10.0, noise=4.0, rng=7)
    path = tmp_path_factory.mktemp("overlap") / "pulse.fil"
    write_simulated_filterbank(str(path), array + 20.0, header,
                               descending=True, nbits=8)
    return str(path)


def _ledger(outdir):
    (name,) = [n for n in os.listdir(outdir) if n.startswith("progress_")]
    with open(os.path.join(outdir, name), "rb") as f:
        return name, f.read()


def _candidates(outdir):
    """Every candidate file's members, byte for byte."""
    out = {}
    for name in sorted(os.listdir(outdir)):
        if name.endswith(".npz"):
            with np.load(os.path.join(outdir, name),
                         allow_pickle=False) as d:
                out[name] = {k: d[k].tobytes() for k in d.files}
    return out


# ---------------------------------------------------------------------------
# the reader's two parts and the staging buffers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbits", [8, 16, 32])
@pytest.mark.parametrize("descending", [False, True])
def test_read_frames_into_then_block_equals_jax_reader(tmp_path, nbits,
                                                       descending):
    rng = np.random.default_rng(nbits)
    array = rng.uniform(0, 250 if nbits == 8 else 6e4, (24, 700))
    header = {"bandwidth": 200., "fbottom": 1200., "nchans": 24,
              "nsamples": 700, "tsamp": 5e-4}
    path = str(tmp_path / "f.fil")
    write_simulated_filterbank(path, array, header, descending=descending,
                               nbits=nbits)
    reader = FilterbankReader(path)
    buf = np.full((600, 24), 7, reader.frame_dtype)
    n = reader.read_frames_into(200, 600, buf)
    assert n == 500  # capped at the file's end
    np.testing.assert_array_equal(
        buf[:n].view(reader.read_frames(200, 500).dtype),
        reader.read_frames(200, 500))
    block = reader.block_from_frames(torch.from_numpy(buf[:n]))
    assert block.dtype == torch.float32 and block.is_contiguous()
    assert torch.equal(block, reader.read_block_tensor(200, 500, "cpu"))
    expect = JaxReader(path).read_block(200, 500, band_ascending=True)
    np.testing.assert_array_equal(block.numpy(), expect.astype(np.float32))


def test_read_frames_into_fires_the_read_seam(pulse_file):
    reader = FilterbankReader(pulse_file)
    buf = np.zeros((4096, reader.nchans), reader.frame_dtype)
    plan = FaultPlan([FaultSpec(site="read", kind="truncate", chunks=(0,),
                                frac=0.25),
                      FaultSpec(site="read", kind="error", chunks=(4096,))])
    with plan.armed():
        assert reader.read_frames_into(0, 4096, buf) == 3072
        with pytest.raises(OSError, match="FAULTPLAN"):
            reader.read_frames_into(4096, 4096, buf)
        assert reader.read_frames_into(4096, 4096, buf) == 4096
        # the plain read has no seam
        assert reader.read_frames(0, 4096).shape == (4096, reader.nchans)
    assert plan.fired() == 2


def test_staging_buffers_on_the_cpu():
    staging = FrameStaging((8, 4), np.uint8, "cpu")
    assert staging.stream is None
    view = staging.acquire(1)
    view[:] = np.arange(32, dtype=np.uint8).reshape(8, 4)
    upload = staging.upload(1, 5)
    frames = staging.wait(upload)
    assert upload.frames is None  # handed over
    assert frames.shape == (5, 4) and frames.dtype == torch.uint8
    view[:] = 0  # refilling the buffer leaves the upload alone
    assert torch.equal(frames, torch.arange(20, dtype=torch.uint8)
                       .reshape(5, 4))
    assert len(staging.views) == 2  # the loop's slots k % 2
    assert staging.acquire(0) is staging.views[0]


# ---------------------------------------------------------------------------
# overlapped against serial
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,kw", [
    ("direct", {}),
    ("direct_all_hits", dict(snr_threshold=3.0)),
    ("hybrid", dict(kernel="hybrid")),
    ("period_search", dict(period_search=True)),
    ("strict_gate", dict(quarantine_policy="strict")),
])
def test_overlapped_equals_serial(pulse_file, tmp_path, case, kw):
    search = {**SEARCH, **kw}
    hits_s, store_s = search_by_chunks(pulse_file, device="cpu",
                                       output_dir=str(tmp_path / "s"),
                                       overlap_persist=False, **search)
    stages = {}
    hits_o, store_o = search_by_chunks(pulse_file, device="cpu",
                                       output_dir=str(tmp_path / "o"),
                                       stage_seconds=stages, **search)
    assert hits_s and [h[:2] for h in hits_s] == [h[:2] for h in hits_o]
    assert _ledger(str(tmp_path / "s")) == _ledger(str(tmp_path / "o"))
    cands = _candidates(str(tmp_path / "s"))
    assert cands and cands == _candidates(str(tmp_path / "o"))
    for (_, _, info_s, table_s), (_, _, info_o, table_o) in zip(hits_s,
                                                                hits_o):
        np.testing.assert_array_equal(info_s.allprofs, info_o.allprofs)
        assert info_s.dm == info_o.dm and info_s.snr == info_o.snr
        for col in table_s.colnames:
            np.testing.assert_array_equal(table_s[col], table_o[col])
    assert {"badchans", "read", "read_decode", "upload_wait", "gate",
            "clean", "search", "persist", "persist_drain"} <= set(stages)
    if case == "strict_gate":
        assert "gate" in stages and store_o.quarantined_chunks == {}


def test_overlapped_matches_jax_overlapped(pulse_file, tmp_path):
    ref_hits, ref_store = jax_search_by_chunks(
        pulse_file, backend="jax", kernel="pallas", make_plots=False,
        progress=False, output_dir=str(tmp_path / "jax"), **SEARCH)
    hits, store = search_by_chunks(pulse_file, device="cpu",
                                   output_dir=str(tmp_path / "port"),
                                   **SEARCH)
    assert [h[:2] for h in hits] == [h[:2] for h in ref_hits]
    for (_, _, info, table), (_, _, rinfo, rtable) in zip(hits, ref_hits):
        assert info.dm == rinfo.dm and info.width == rinfo.width
        np.testing.assert_allclose(table["snr"], rtable["snr"], rtol=1e-5)
    assert json.loads(_ledger(str(tmp_path / "port"))[1])["done"] \
        == json.loads(_ledger(str(tmp_path / "jax"))[1])["done"]


def test_overlapped_resume_after_interrupt(pulse_file, tmp_path):
    out = str(tmp_path / "resumed")
    _, store1 = search_by_chunks(pulse_file, device="cpu", output_dir=out,
                                 max_chunks=2, **SEARCH)
    assert len(store1.done_chunks) == 2
    hits2, store2 = search_by_chunks(pulse_file, device="cpu",
                                     output_dir=out, **SEARCH)
    ref = str(tmp_path / "oneshot")
    hits_ref, store_ref = search_by_chunks(pulse_file, device="cpu",
                                           output_dir=ref,
                                           overlap_persist=False, **SEARCH)
    assert store2.done_chunks == store_ref.done_chunks
    assert [h[:2] for h in hits2] == [h[:2] for h in hits_ref]
    assert _ledger(out) == _ledger(ref)
    assert _candidates(out) == _candidates(ref)


def test_default_knobs_are_inert(pulse_file, tmp_path):
    """With nothing armed the gate changes no byte: the default run and
    a gate-off run persist the same candidates and ledger list; only the
    non-default policy changes the fingerprint."""
    summary = {}
    hits_a, store_a = search_by_chunks(pulse_file, device="cpu",
                                       output_dir=str(tmp_path / "default"),
                                       summary=summary, **SEARCH)
    hits_b, store_b = search_by_chunks(
        pulse_file, device="cpu", output_dir=str(tmp_path / "off"),
        quarantine_policy="off", dispatch_timeout=None, **SEARCH)
    assert [h[:2] for h in hits_a] == [h[:2] for h in hits_b]
    assert _candidates(str(tmp_path / "default")) \
        == _candidates(str(tmp_path / "off"))
    assert store_a.fingerprint != store_b.fingerprint
    led_a = json.loads(_ledger(str(tmp_path / "default"))[1])
    led_b = json.loads(_ledger(str(tmp_path / "off"))[1])
    assert set(led_a) == set(led_b) == {"fingerprint", "done"}
    assert led_a["done"] == led_b["done"]
    _, store_c = search_by_chunks(pulse_file, device="cpu",
                                  output_dir=str(tmp_path / "default"),
                                  quarantine_policy="sanitize", **SEARCH)
    assert store_c.fingerprint == store_a.fingerprint
    assert not [f for f in os.listdir(tmp_path / "default")
                if f.startswith("quarantine")]
    assert summary["quarantined"] == 0 and summary["fallback"] is None
    assert summary["oom_descents"] == 0


def test_persist_backpressure_keeps_two_in_flight(pulse_file, tmp_path,
                                                  monkeypatch):
    """A slow disk: at most two persist tasks wait, the loop waits on the
    oldest, and the ledger and candidates are the serial loop's."""
    real = CandidateStore.save_candidate
    in_flight = []

    def slow(self, *args, **kwargs):
        in_flight.append(1)
        time.sleep(0.15)
        try:
            return real(self, *args, **kwargs)
        finally:
            in_flight.pop()

    # every chunk a hit; no figures, so the loop outpaces the slow disk
    search = {**SEARCH, "snr_threshold": 3.0, "make_plots": False}
    search_by_chunks(pulse_file, device="cpu",
                     output_dir=str(tmp_path / "s"), overlap_persist=False,
                     **search)
    monkeypatch.setattr(CandidateStore, "save_candidate", slow)
    stages = {}
    search_by_chunks(pulse_file, device="cpu",
                     output_dir=str(tmp_path / "o"), stage_seconds=stages,
                     **search)
    assert stages["persist_backpressure"] > 0
    assert stages["persist_drain"] > 0
    assert _ledger(str(tmp_path / "s")) == _ledger(str(tmp_path / "o"))
    assert _candidates(str(tmp_path / "s")) \
        == _candidates(str(tmp_path / "o"))


def test_error_shuts_the_workers_down(pulse_file, tmp_path, monkeypatch):
    """A configuration error mid-run propagates, the reader and persist
    workers stop, and the chunks persisted before it stay marked."""
    baseline = threading.active_count()
    real = search_pipeline.dedispersion_search
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise ValueError("bad configuration (test)")
        return real(*args, **kwargs)

    monkeypatch.setattr(search_pipeline, "dedispersion_search", failing)
    with pytest.raises(ValueError, match="test"):
        search_by_chunks(pulse_file, device="cpu", output_dir=str(tmp_path),
                         **SEARCH)
    deadline = time.monotonic() + 10.0
    while threading.active_count() > baseline \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == baseline
    done = json.loads(_ledger(str(tmp_path))[1])["done"]
    assert len(done) <= 2 and done == sorted(done)
