"""The port's canary on the CPU, held against the JAX package.

The injected chunk: the port builds the bump on the reader thread from
the raw frames and adds it to the float block after the frames'
conversion; the JAX package adds it to its float64 host block before the
float32 upload.  The two chunks are equal bit for bit.  Then both
drivers on one small survey file: with the canary in every chunk the
science hits, the candidate files and the ledger are those of the
canary-off run, and the recall, the tagged, promoted and discarded
canaries equal the JAX driver's on the same file.
"""
import contextlib
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from pulsarutils_tpu.faults import FaultPlan as JaxFaultPlan
from pulsarutils_tpu.faults import FaultSpec as JaxFaultSpec
from pulsarutils_tpu.io.sigproc import FilterbankReader as JaxReader
from pulsarutils_tpu.obs.canary import CanaryController as JaxCanary
from pulsarutils_tpu.obs.metrics import REGISTRY as JAX_REGISTRY
from pulsarutils_tpu.pipeline.search_pipeline import \
    search_by_chunks as jax_search_by_chunks

from pulsarutils_tpu_torch.faults import FaultPlan, FaultSpec
from pulsarutils_tpu_torch.io.sigproc import (FilterbankReader,
                                              write_simulated_filterbank)
from pulsarutils_tpu_torch.models.simulate import disperse_array
from pulsarutils_tpu_torch.obs.canary import CanaryController, inject_tensor
from pulsarutils_tpu_torch.obs.metrics import REGISTRY
from pulsarutils_tpu_torch.pipeline.search_pipeline import search_by_chunks

torch.set_num_threads(1)

TSAMP = 0.0005
#: the JAX package's live-survey test geometry (tests/test_obs_live.py)
SEARCH = dict(dmmin=100.0, dmmax=200.0, chunk_length=4096 * TSAMP,
              snr_threshold=6.5)
JAX_KW = dict(backend="jax", kernel="pallas", make_plots=False,
              progress=False)


@pytest.fixture(autouse=True)
def clean_state():
    """The port's process-wide registry, reset after each test."""
    yield
    REGISTRY.reset()


def _bind(canary, header, resample=1):
    return canary.bind(nchan=header["nchans"], start_freq=header["fbottom"],
                       bandwidth=header["bandwidth"], tsamp=header["tsamp"],
                       dmmin=100.0, dmmax=200.0, resample=resample)


@pytest.mark.parametrize("nbits", [8, 16])
@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("nsamples", [3000, 140000])
def test_injected_chunk_equals_jax(tmp_path, nbits, descending, nsamples):
    rng = np.random.default_rng(11)
    nchan = 24
    array = rng.normal(100.0, 9.0, (nchan, nsamples)).clip(0, 250)
    array[3] = 0.0               # a dead channel: the mean-std fill-in
    header = {"bandwidth": 200.0, "fbottom": 1200.0, "nchans": nchan,
              "nsamples": nsamples, "tsamp": TSAMP, "foff": 200.0 / nchan}
    path = str(tmp_path / "chunk.fil")
    write_simulated_filterbank(path, array, header, descending=descending,
                               nbits=nbits)
    jreader, reader = JaxReader(path), FilterbankReader(path)
    for chunk in (0, 4096):
        jcanary = _bind(JaxCanary(rate=1.0, dm=150.0, snr=12.0, seed=5),
                        jreader.header)
        canary = _bind(CanaryController(rate=1.0, dm=150.0, snr=12.0,
                                        seed=5), reader.header)
        want = np.asarray(jcanary.maybe_inject(
            jreader.read_block(0, nsamples, band_ascending=True), chunk),
            dtype=np.float32)
        # the port's path: frames -> bump on the host, conversion and add
        # on the device
        view = np.empty((nsamples, nchan), dtype=reader.frame_dtype)
        n = reader.read_frames_into(0, nsamples, view)
        stride = max(1, n // 65536)
        bump = canary.injection(chunk, n,
                                reader.host_samples(view[:n:stride]))
        block = inject_tensor(
            reader.block_from_frames(torch.from_numpy(view[:n])), bump)
        np.testing.assert_array_equal(block.numpy(), want)
        assert canary._pending == jcanary._pending
        # the host form (a chunk a corrupt fault matched) is the JAX
        # package's injection itself
        host = canary.maybe_inject(reader.read_block(
            0, nsamples, band_ascending=True), chunk + 1)
        jhost = jcanary.maybe_inject(jreader.read_block(
            0, nsamples, band_ascending=True), chunk + 1)
        np.testing.assert_array_equal(host, jhost)


def test_unselected_chunks_are_untouched():
    canary = CanaryController(rate=0.5, dm=150.0, seed=2)
    jcanary = JaxCanary(rate=0.5, dm=150.0, seed=2)
    header = {"nchans": 16, "fbottom": 1200.0, "bandwidth": 200.0,
              "tsamp": TSAMP}
    _bind(canary, header)
    _bind(jcanary, header)
    picks = [canary.selects(c) for c in range(0, 40960, 2048)]
    assert picks == [jcanary.selects(c) for c in range(0, 40960, 2048)]
    assert 0 < sum(picks) < len(picks)
    block = np.ones((16, 512))
    skipped = next(c for c, p in zip(range(0, 40960, 2048), picks) if not p)
    assert canary.maybe_inject(block, skipped) is block
    assert canary.injection(skipped, 512, block) is None
    assert not canary._pending


# -- both drivers on one survey ----------------------------------------------

@pytest.fixture(scope="module")
def survey_file(tmp_path_factory):
    """The JAX package's live-survey file: 64 channels, 24,576 samples,
    one DM-150 pulse at sample 13,000, descending band, 8 bits."""
    tmp = tmp_path_factory.mktemp("canary")
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


def _names(out):
    return sorted(n for n in os.listdir(out) if n.endswith(".npz"))


def _total(registry, name):
    return sum(m["value"] for m in registry.snapshot() if m["name"] == name)


CANARY_COUNTERS = ("putpu_canary_injected_total",
                   "putpu_canary_recovered_total",
                   "putpu_canary_missed_total",
                   "putpu_canary_tagged_hits_total",
                   "putpu_canary_promoted_hits_total",
                   "putpu_canary_contaminated_tables_total",
                   "putpu_canary_discarded_total")


def _run_both(survey_file, tmp_path, make, plan=None, jplan=None):
    """Both drivers with the canary ``make(cls)`` builds; returns each
    package's hits, store, canary and counter deltas."""
    out = {}
    for label, search, cls, registry, kw, fault in (
            ("ours", search_by_chunks, CanaryController, REGISTRY,
             dict(device="cpu", make_plots=False), plan),
            ("theirs", jax_search_by_chunks, JaxCanary, JAX_REGISTRY,
             JAX_KW, jplan)):
        before = {n: _total(registry, n) for n in CANARY_COUNTERS}
        canary = make(cls)
        with (fault.armed() if fault is not None
              else contextlib.nullcontext()):
            hits, store = search(survey_file,
                                 output_dir=str(tmp_path / label),
                                 canary=canary, **SEARCH, **kw)
        out[label] = (hits, store, canary, {
            n: _total(registry, n) - before[n] for n in CANARY_COUNTERS})
    return out


def _same_hits(ours, theirs):
    assert [h[:2] for h in ours] == [h[:2] for h in theirs]
    for (_, _, info, table), (_, _, rinfo, rtable) in zip(ours, theirs):
        assert info.dm == rinfo.dm and info.width == rinfo.width
        assert table.best_row()["peak"] == rtable.best_row()["peak"]
        np.testing.assert_allclose(info.snr, rinfo.snr, rtol=1e-5)
        assert table.nrows == rtable.nrows


def _canary_state(canary):
    s = canary.summary()
    return {k: s[k] for k in ("injected", "recovered", "discarded",
                              "recall", "window_recall", "dm")}


def test_canary_keeps_the_science_and_equals_jax(survey_file, tmp_path):
    """The JAX package's contract (canary at DM 120, away from the
    DM-150 pulse): the ledger, the candidate files and the hit spans of
    the canary-off run; and the JAX driver's recall and hits."""
    off, off_store = search_by_chunks(
        survey_file, output_dir=str(tmp_path / "off"), device="cpu",
        make_plots=False, **SEARCH)
    both = _run_both(survey_file, tmp_path, lambda cls: cls(
        rate=1.0, dm=120.0, snr=15.0, seed=1))
    hits, store, canary, deltas = both["ours"]
    jhits, jstore, jcanary, jdeltas = both["theirs"]
    assert store.done_chunks == off_store.done_chunks == jstore.done_chunks
    assert Path(store._ledger_path).read_bytes() == \
        Path(off_store._ledger_path).read_bytes()
    assert _names(tmp_path / "ours") == _names(tmp_path / "off") == \
        _names(tmp_path / "theirs")
    assert [h[:2] for h in hits] == [h[:2] for h in off]
    pulse = [info for istart, iend, info, _ in hits if istart <= 13000 < iend]
    assert pulse and abs(pulse[0].dm - 150.0) < 10.0
    _same_hits(hits, jhits)
    assert _canary_state(canary) == _canary_state(jcanary)
    assert canary.summary()["injected"] == 5
    assert deltas == jdeltas
    assert canary.to_json()["curve"] == jcanary.to_json()["curve"]


def test_canary_on_the_pulse_promotes_as_jax(survey_file, tmp_path):
    """A canary at the pulse's DM tops the chunks it shares with it: the
    genuine weaker row is promoted, the canary rows masked out of the
    persisted table, as in the JAX driver."""
    both = _run_both(survey_file, tmp_path, lambda cls: cls(
        rate=1.0, dm=150.0, snr=25.0, seed=3))
    hits, _, canary, deltas = both["ours"]
    jhits, _, jcanary, jdeltas = both["theirs"]
    _same_hits(hits, jhits)
    assert deltas == jdeltas
    assert deltas["putpu_canary_tagged_hits_total"] >= 1
    assert _canary_state(canary) == _canary_state(jcanary)
    assert _names(tmp_path / "ours") == _names(tmp_path / "theirs")


def test_quarantined_chunk_discards_its_canary(survey_file, tmp_path):
    both = _run_both(
        survey_file, tmp_path,
        lambda cls: cls(rate=1.0, dm=120.0, snr=15.0, seed=1),
        plan=FaultPlan([FaultSpec(site="corrupt", kind="nan", frac=0.9,
                                  chunks=(8192,), times=None)]),
        jplan=JaxFaultPlan([JaxFaultSpec(site="corrupt", kind="nan",
                                         frac=0.9, chunks=(8192,),
                                         times=None)]))
    hits, store, canary, deltas = both["ours"]
    jhits, jstore, jcanary, jdeltas = both["theirs"]
    assert store.quarantined_chunks == jstore.quarantined_chunks
    assert "8192" in store.quarantined_chunks
    assert canary.summary()["discarded"] == 1
    assert _canary_state(canary) == _canary_state(jcanary)
    assert deltas == jdeltas
    _same_hits(hits, jhits)
