"""The port's batched beams (``beams/``, ``cli/beams_main.py``) against the
JAX package's, on the CPU.

* ``BeamBatcher``: each beam's batched table equals its sequential
  (``search_single``) table bit for bit, for the roll and the gather,
  float and packed input (device unpack against host unpack) and with
  the device conditioning (``prep``); against the JAX ``BeamBatcher`` at
  the same kernel the discrete columns are equal, ``max`` is bit for bit
  for the roll (PR 6 pins the roll's plane bit for bit), and ``std`` and
  ``snr`` (the scorers differ) and the gather's floats are within
  :data:`SCORE_RTOL`, the ``f32`` policy's ``score_rtol``;
* the ragged last chunk, mixed shapes, the ``|b<N>`` key, the memory
  budget's ``max_beam_batch`` and ``resolve_batched_kernel``'s decisions
  equal the JAX package's; an injected ``beams`` OOM takes the
  ``halve_batch`` rung and a preflight split is taken, each with the
  unsplit tables; one beam's OOM propagates;
* ``multibeam_search``: batched == sequential (tables, ledgers and
  candidate files byte for byte, 1 against 3 dispatches an epoch), the
  hits, ``done`` lists and candidate records of the JAX driver, resume,
  a mismatched geometry, the per-beam canary, packed ``device`` ==
  ``host`` byte for byte, and the host conditioning ``_clean_block``
  equal to the JAX one bit for bit;
* ``coincidence_sift``: the JAX test's cases and random candidate lists
  (hypothesis) give the JAX groups and verdicts;
* the ``PUmultibeam`` twin prints the JAX CLI's coincidence line;
  ``--serve`` without a port exits 2 as the JAX CLI does, and the
  service raises without a card.
"""
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pulsarutils_tpu.beams import batcher as jbatcher
from pulsarutils_tpu.beams import coincidence as jcoinc
from pulsarutils_tpu.beams import multibeam as jmultibeam
from pulsarutils_tpu.cli import beams_main as jcli
from pulsarutils_tpu.resilience import memory_budget as jbudget
from pulsarutils_tpu.tuning import autotune as jat
from pulsarutils_tpu.tuning import cache as jcache
from pulsarutils_tpu.tuning.geometry import geometry_key as jgeometry_key

from pulsarutils_tpu_torch.beams import (BeamBatcher, BeamGeometryError,
                                         coincidence_sift, multibeam_search)
from pulsarutils_tpu_torch.beams import coincidence as tcoinc
from pulsarutils_tpu_torch.beams.multibeam import _clean_block, open_beams
from pulsarutils_tpu_torch.cli import beams_main as tcli
from pulsarutils_tpu_torch.faults import FaultPlan, FaultSpec
from pulsarutils_tpu_torch.io.sigproc import write_simulated_filterbank
from pulsarutils_tpu_torch.models.simulate import simulate_test_data
from pulsarutils_tpu_torch.obs import metrics
from pulsarutils_tpu_torch.resilience import ladder
from pulsarutils_tpu_torch.resilience import memory_budget as tbudget
from pulsarutils_tpu_torch.tuning import autotune as tat
from pulsarutils_tpu_torch.tuning import cache as tcache
from pulsarutils_tpu_torch.tuning.geometry import geometry_key
from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant

torch.set_num_threads(1)

GEOM = {"bandwidth": 200.0, "fbottom": 1200.0, "tsamp": 0.0005}
#: the f32 policy's score tolerance (``precision.STRATEGIES["f32"].
#: score_rtol``): the port's and the JAX package's scorers sum in
#: different orders
SCORE_RTOL = 1e-4
FLOATS = ("max", "std", "snr")
DISCRETE = ("DM", "rebin", "peak")


@pytest.fixture(autouse=True)
def _static(monkeypatch):
    """The static choices (no measurement), an undegraded ladder, no
    policy from the environment."""
    monkeypatch.setenv("PUTPU_AUTOTUNE", "off")
    monkeypatch.delenv("PUTPU_PRECISION", raising=False)
    monkeypatch.delenv("PUTPU_MEM_LIMIT", raising=False)
    ladder.reset()
    yield
    ladder.reset()


def _blocks(seed, n=3, nchan=32, nsamples=2048):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(nchan, nsamples)).astype(np.float32)
            for _ in range(n)]


def _codes(seed, n=3, nchan=32, nsamples=2048, nbits=2):
    """``n`` beams' packed frames ``(nsamples, nchan * nbits / 8)`` and
    their ascending float codes ``(nchan, nsamples)``."""
    from pulsarutils_tpu_torch.io.lowbit import PackedFrames, pack_numpy

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        codes = rng.integers(0, 1 << nbits, (nsamples, nchan),
                             dtype=np.uint8)
        codes[1000:1003] = (1 << nbits) - 1
        frames = pack_numpy(codes.reshape(-1), nbits).reshape(nsamples, -1)
        out.append((frames, PackedFrames(frames, nbits, nchan,
                                         band_descending=True).to_host()))
    return out


def _tables_equal(a, b):
    for col in b.colnames:
        assert np.array_equal(np.asarray(a[col]), np.asarray(b[col])), col


def _tables_close(ours, ref, max_exact):
    for col in DISCRETE:
        assert np.array_equal(ours[col], np.asarray(ref[col])), col
    for col in FLOATS:
        want = np.asarray(ref[col])
        if max_exact and col == "max":
            assert np.array_equal(ours[col], want), col
        else:
            np.testing.assert_allclose(ours[col], want, rtol=SCORE_RTOL)


# -- BeamBatcher --------------------------------------------------------------

DMS = np.linspace(100.0, 200.0, 16)
BATCHER_GEOM = (1200.0, 200.0, 5e-4)


@pytest.mark.parametrize("policy", [None, "f32_compensated"])
@pytest.mark.parametrize("kernel", ["roll", "gather"])
def test_batched_bit_identical_per_beam(kernel, policy):
    blocks = _blocks(1)
    batcher = BeamBatcher(32, 2048, DMS, *BATCHER_GEOM, kernel=kernel,
                          precision=policy, chan_block=8, device="cpu")
    for blk, table in zip(blocks, batcher.search(blocks)):
        _tables_equal(table, batcher.search_single(blk))


@pytest.mark.parametrize("prep", [None, (True, 1), (True, 2)])
@pytest.mark.parametrize("kernel", ["roll", "gather"])
def test_packed_device_equals_host_and_batched_equals_single(kernel, prep):
    beams = _codes(2)
    device = BeamBatcher(32, 2048 // (prep[1] if prep else 1), DMS,
                         *BATCHER_GEOM, kernel=kernel, packed=(2, True),
                         prep=prep, device="cpu")
    host = BeamBatcher(32, 2048 // (prep[1] if prep else 1), DMS,
                       *BATCHER_GEOM, kernel=kernel, prep=prep,
                       device="cpu")
    if prep is None:
        # the codes summed in an exact integer type: int16 at 32 x 2 bits
        assert device.packed_meta[3] == "int16"
    got = device.search([f for f, _ in beams])
    want = host.search([c for _, c in beams])
    for (frames, codes), a, b in zip(beams, got, want):
        _tables_equal(a, b)
        _tables_equal(a, device.search_single(frames))
        _tables_equal(b, host.search_single(codes))


@pytest.mark.parametrize("kernel", ["roll", "gather"])
def test_batcher_matches_jax(kernel):
    blocks = _blocks(3)
    ours = BeamBatcher(32, 2048, DMS, *BATCHER_GEOM, kernel=kernel,
                       device="cpu").search(blocks)
    ref = jbatcher.BeamBatcher(32, 2048, DMS, *BATCHER_GEOM,
                               kernel=kernel).search(blocks)
    for a, b in zip(ours, ref):
        _tables_close(a, b, max_exact=kernel == "roll")


@pytest.mark.parametrize("prep", [(True, 1), (True, 2)])
def test_packed_prep_batcher_matches_jax(prep):
    """The device conditioning (float32 renormalisation on each side)
    and the packed unpack against the JAX package's: discrete columns
    equal, floats within :data:`SCORE_RTOL`."""
    beams = _codes(4)
    n = 2048 // prep[1]
    ours = BeamBatcher(32, n, DMS, *BATCHER_GEOM, kernel="roll",
                       packed=(2, True), prep=prep,
                       device="cpu").search([f for f, _ in beams])
    ref = jbatcher.BeamBatcher(32, n, DMS, *BATCHER_GEOM, kernel="roll",
                               packed=(2, True), prep=prep).search(
        [f for f, _ in beams])
    for a, b in zip(ours, ref):
        _tables_close(a, b, max_exact=False)


def test_ragged_tail_gets_its_own_offsets():
    batcher = BeamBatcher(32, 2048, DMS[:8], *BATCHER_GEOM, kernel="roll",
                          device="cpu")
    short = _blocks(5, n=2, nsamples=1024)
    tables = batcher.search(short)
    _tables_equal(tables[1], batcher.search_single(short[1]))
    assert set(batcher._offs_dev) == {1024}
    batcher.search(_blocks(6, n=2))
    assert set(batcher._offs_dev) == {1024, 2048}
    ref = jbatcher.BeamBatcher(32, 2048, DMS[:8], *BATCHER_GEOM,
                               kernel="roll").search(short)
    _tables_close(tables[1], ref[1], max_exact=True)


def test_batcher_rejects_mixed_shapes_and_other_kernels():
    batcher = BeamBatcher(32, 4096, DMS[:8], *BATCHER_GEOM, kernel="roll",
                          device="cpu")
    with pytest.raises(BeamGeometryError):
        batcher.search([np.zeros((32, 4096), np.float32),
                        np.zeros((32, 2048), np.float32)])
    with pytest.raises(BeamGeometryError, match="bound to 32 channels"):
        batcher.search([np.zeros((16, 4096), np.float32)])
    packed = BeamBatcher(32, 4096, DMS[:8], *BATCHER_GEOM, kernel="roll",
                         packed=(2, False), device="cpu")
    with pytest.raises(BeamGeometryError, match="raw"):
        packed.search([np.zeros((4096, 4), np.uint8)])
    for kernel in ("pallas", "hybrid", "fdmt"):
        with pytest.raises(ValueError, match="roll"):
            BeamBatcher(32, 4096, DMS[:8], *BATCHER_GEOM, kernel=kernel,
                        device="cpu")
    with pytest.raises(ValueError):
        jbatcher.BeamBatcher(32, 4096, DMS[:8], *BATCHER_GEOM,
                             kernel="pallas")


@pytest.mark.parametrize("batch", [1, 2, 8, 64])
def test_geometry_key_batch_axis(batch):
    assert geometry_key("cpu", 64, 8192, 128, batch=batch) == \
        jgeometry_key("cpu", 64, 8192, 128, batch=batch)
    base = geometry_key("gpu", 1024, 262144, 514)
    key = geometry_key("gpu", 1024, 262144, 514, batch=batch)
    assert key == (base if batch == 1 else f"{base}|b{batch}")


@pytest.mark.parametrize("formulation, packed_nbits, budget", [
    ("gather", 0, 4 << 30), ("roll", 0, 4 << 30), ("gather", 2, 1 << 30),
    ("roll", 4, 80 << 30), ("gather", 0, 1 << 20)])
def test_max_beam_batch_equals_jax(formulation, packed_nbits, budget):
    kw = dict(dm_block=32, chan_block=32, formulation=formulation,
              packed_nbits=packed_nbits, budget=budget)
    ours = tbudget.max_beam_batch(1024, 1 << 18, 514, **kw)
    assert ours == jbudget.max_beam_batch(1024, 1 << 18, 514, **kw)
    assert ours >= 1
    # no budget known on the host: no cap
    assert tbudget.max_beam_batch(1024, 1 << 18, 514, device="cpu") is None


@pytest.fixture
def fresh_tuners(monkeypatch, tmp_path):
    monkeypatch.setenv("PUTPU_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.delenv("PUTPU_AUTOTUNE", raising=False)
    prev = tat.set_tuner(None), jat.set_tuner(None)
    yield
    tat.set_tuner(prev[0])
    jat.set_tuner(prev[1])


@pytest.mark.parametrize("times", [
    {"roll": 0.02, "gather": 0.01}, {"roll": 0.01, "gather": 0.02},
    {"roll": 0.01, "gather": 0.5}])
def test_resolve_batched_kernel_equals_jax(fresh_tuners, times):
    decided = []
    for mod, cache in ((tat, tcache), (jat, jcache)):
        mod.set_tuner(mod.KernelTuner(
            cache=cache.TuneCache(None), mode="on", min_elements=0,
            probe_trials=8, measurer=lambda k, run, reps: times[k]))
        mark = mod.decision_seq()
        kw = {"device": "cpu"} if mod is tat else {}
        kernel = mod.resolve_batched_kernel(
            16, 1024, 12, 3, *BATCHER_GEOM, np.linspace(100, 200, 12),
            dm_block=12, **kw)
        decided.append((kernel, mod.decisions_since(mark)))
    assert decided[0] == decided[1]
    kernel, (rec,) = decided[0]
    assert kernel == min(times, key=times.get)
    assert rec["key"] == "cpu|c16|t1024|d12|float32|m-|b3"
    assert rec["static"] == "roll"
    # a batcher with no kernel resolves through it
    batcher = BeamBatcher(16, 1024, np.linspace(100, 200, 12),
                          *BATCHER_GEOM, batch_hint=3, device="cpu")
    assert batcher.kernel == kernel


def test_beams_oom_fault_halves_the_batch():
    blocks = _blocks(7, n=5)
    batcher = BeamBatcher(32, 2048, DMS, *BATCHER_GEOM, kernel="gather",
                          device="cpu")
    ref = batcher.search(blocks)
    metrics.REGISTRY.reset()
    plan = FaultPlan([FaultSpec(site="beams", kind="oom", times=1)])
    with plan.armed():
        split = batcher.search(blocks)
    assert plan.fired("beams") == 1
    for a, b in zip(split, ref):
        _tables_equal(a, b)
    snap = {(m["name"], tuple(sorted(m["labels"].items()))): m["value"]
            for m in metrics.REGISTRY.snapshot()}
    assert snap[("putpu_oom_events_total",
                 (("surface", "beam_batch"),))] == 1
    assert snap[("putpu_oom_ladder_steps_total",
                 (("step", "halve_batch"),))] == 1
    assert snap[("putpu_oom_splits_total", (("stage", "ladder"),))] == 1
    assert ladder.level() == 1
    # one beam has nothing to split: the error propagates
    with FaultPlan([FaultSpec(site="beams", kind="oom", times=1)]).armed():
        with pytest.raises(torch.OutOfMemoryError):
            batcher.search(blocks[:1])
    # an error that is not an OOM propagates too
    with FaultPlan([FaultSpec(site="beams", kind="error", times=1)]).armed():
        with pytest.raises(RuntimeError, match="injected beams"):
            batcher.search(blocks)


def test_preflight_split_keeps_the_tables(monkeypatch):
    blocks = _blocks(8, n=5)
    batcher = BeamBatcher(32, 2048, DMS, *BATCHER_GEOM, kernel="roll",
                          device="cpu")
    ref = batcher.search(blocks)
    one = tbudget.estimate_direct(32, 2048, 16, dm_block=16,
                                  formulation="roll")
    # a budget that admits two beams a dispatch
    budget = ((one["workspace"] + one["scoring"] + one["outputs"]
               + 2.5 * one["operand"]) / tbudget.SAFETY_FRACTION)
    monkeypatch.setattr(tbudget, "headroom_bytes", lambda device=None:
                        budget)
    assert batcher.max_batch() == 2
    metrics.REGISTRY.reset()
    acc = BudgetAccountant()
    with acc.chunk(0):
        split = batcher.search(blocks)
    for a, b in zip(split, ref):
        _tables_equal(a, b)
    assert metrics.REGISTRY.counter("putpu_oom_splits_total",
                                    stage="preflight").value == 2
    assert acc.counters_total["dispatches"] == 3
    assert ladder.level() == 0


def test_one_dispatch_and_readback_a_batch():
    blocks = _blocks(9, n=4)
    batcher = BeamBatcher(32, 2048, DMS, *BATCHER_GEOM, kernel="roll",
                          device="cpu")
    batched, sequential = BudgetAccountant(), BudgetAccountant()
    with batched.chunk(0):
        batcher.search(blocks)
    with sequential.chunk(0):
        for blk in blocks:
            batcher.search_single(blk)
    assert batched.counters_total["dispatches"] == 1
    assert batched.counters_total["readbacks"] == 1
    assert sequential.counters_total["dispatches"] == 4
    assert sequential.counters_total["readbacks"] == 4


def test_batch_uploads_host_beams_through_one_slot(monkeypatch):
    """Host beams cross one at a time into one reused device slot (their
    bytes counted once each); beams already on the device are searched
    where they are and count nothing.  The tables are the same."""
    from pulsarutils_tpu_torch.beams import batcher as tbatcher

    blocks = _blocks(5, n=3)
    batcher = BeamBatcher(32, 2048, DMS, *BATCHER_GEOM, kernel="roll",
                          device="cpu")
    operands = []
    real = tbatcher.beam_scores

    def spy(beam, *args):
        operands.append(beam)
        return real(beam, *args)

    monkeypatch.setattr(tbatcher, "beam_scores", spy)
    metrics.REGISTRY.reset()
    host = batcher.search(blocks)
    uploaded = metrics.REGISTRY.counter("putpu_bytes_uploaded_total").value
    assert uploaded == sum(b.nbytes for b in blocks)
    assert len({op.data_ptr() for op in operands}) == 1
    operands.clear()
    dev = batcher.search([torch.from_numpy(b) for b in blocks])
    assert metrics.REGISTRY.counter(
        "putpu_bytes_uploaded_total").value == uploaded
    assert [op.data_ptr() for op in operands] == [
        b.__array_interface__["data"][0] for b in blocks]
    for a, b in zip(host, dev):
        _tables_equal(a, b)


def test_batcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BeamBatcher(32, 2048, DMS, *BATCHER_GEOM, kernel="roll")


# -- the host conditioning ----------------------------------------------------

@pytest.mark.parametrize("shape, resample, order", [
    ((64, 4096), 1, "C"), ((64, 4096), 3, "C"), ((33, 1000), 2, "F"),
    ((8, 300), 1, "reversed"), ((64, 5000), 1, "frames"),
    ((16, 4096), 2, "frames")])
def test_clean_block_equals_jax(shape, resample, order):
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 255, shape, dtype=np.uint8)
    block = codes.astype(np.float64)
    if order == "F":
        block = np.asfortranarray(block)
    elif order == "reversed":
        block = block[::-1]
    elif order == "frames":
        # a file's frames, ascending: the stored values, not converted
        block = np.ascontiguousarray(codes[::-1].T).T[::-1]
    want = jmultibeam._clean_block(np.asarray(block, dtype=np.float64),
                                   resample)
    ours = _clean_block(block, resample)
    assert ours.dtype == want.dtype == np.float32
    assert np.array_equal(ours, want)


@pytest.mark.parametrize("nbits", [8, 32])
def test_stored_values_clean_equal_jax_read_and_clean(tmp_path, nbits):
    """The driver's read of a beam file (the frames' stored values, no
    float copy) and clean equal the JAX driver's ``read_block`` and
    clean, bit for bit."""
    from pulsarutils_tpu.io.sigproc import FilterbankReader as JReader

    from pulsarutils_tpu_torch.beams.multibeam import _read_stored
    from pulsarutils_tpu_torch.io.sigproc import FilterbankReader

    path = write_beam(str(tmp_path / "b.fil"), 64, 4096, seed=3,
                      pulse_dm=150.0, nbits=nbits)
    ours = _clean_block(_read_stored(FilterbankReader(path), 1024, 2048), 2)
    want = jmultibeam._clean_block(JReader(path).read_block(
        1024, 2048, band_ascending=True), 2)
    assert np.array_equal(ours, want)


# -- multibeam_search -----------------------------------------------------------

def write_beam(path, nchan, nsamples, seed, pulse_dm=None, nbeams=None,
               ibeam=None, nbits=32, rfi_at=None):
    rng = np.random.default_rng(seed)
    if nbits == 2:
        arr = np.clip(np.rint(rng.normal(1.5, 0.6, (nchan, nsamples))), 0, 3)
    else:
        arr = np.abs(rng.normal(0, 0.5, (nchan, nsamples))) + 10.0
    if pulse_dm is not None:
        pulse, _ = simulate_test_data(
            dm=pulse_dm, nchan=nchan, nsamples=nsamples, tsamp=GEOM["tsamp"],
            start_freq=GEOM["fbottom"], bandwidth=GEOM["bandwidth"],
            signal=8.0 if nbits != 2 else 2.0, noise=0.0, rng=99)
        arr = arr + pulse
    if rfi_at is not None:
        arr[:, rfi_at:rfi_at + 2] += 40.0 if nbits != 2 else 3.0
    header = {"bandwidth": GEOM["bandwidth"], "fbottom": GEOM["fbottom"],
              "nchans": nchan, "nsamples": nsamples, "tsamp": GEOM["tsamp"],
              "foff": GEOM["bandwidth"] / nchan}
    extra = {"nbits": nbits}
    if nbeams is not None:
        extra.update(nbeams=nbeams, ibeam=ibeam)
    write_simulated_filterbank(path, arr, header, descending=True, **extra)
    return path


@pytest.fixture(scope="module")
def beam_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("beams")
    return [write_beam(str(d / f"beam{b}.fil"), 64, 4096, seed=b,
                       pulse_dm=150.0 if b == 1 else None, nbeams=3,
                       ibeam=b + 1)
            for b in range(3)]


def _files(out):
    return {name: (out / name).read_bytes() for name in sorted(os.listdir(out))}


def test_multibeam_batched_equals_sequential(beam_files, tmp_path):
    accb, accs = BudgetAccountant(), BudgetAccountant()
    kw = dict(snr_threshold=7.0, keep_tables=True, device="cpu")
    rb = multibeam_search(beam_files, 100, 200, budget=accb, batched=True,
                          output_dir=str(tmp_path / "ob"), **kw)
    rs = multibeam_search(beam_files, 100, 200, budget=accs, batched=False,
                          output_dir=str(tmp_path / "os"), **kw)
    for bb, bs in zip(rb["beams"], rs["beams"]):
        assert len(bb["tables"]) == len(bs["tables"]) > 0
        for (i1, t1), (i2, t2) in zip(bb["tables"], bs["tables"]):
            assert i1 == i2
            _tables_equal(t1, t2)
    batched, sequential = _files(tmp_path / "ob"), _files(tmp_path / "os")
    assert batched == sequential
    assert any(n.endswith(".table.npz") for n in batched)
    epochs = len(accb.chunks)
    assert accb.counters_total["dispatches"] == epochs
    assert accb.counters_total["readbacks"] == epochs
    assert accs.counters_total["dispatches"] == 3 * epochs
    hits = {b["beam"]: len(b["hits"]) for b in rb["beams"]}
    assert hits[2] > 0 and hits[1] == 0 and hits[3] == 0
    verdicts = rb["coincidence"]["stats"]["verdicts"]
    assert verdicts["confirmed"] >= 1 and verdicts["rfi"] == 0


def test_multibeam_matches_jax(beam_files, tmp_path):
    ours = multibeam_search(beam_files, 100, 200, snr_threshold=7.0,
                            output_dir=str(tmp_path / "port"), device="cpu")
    ref = jmultibeam.multibeam_search(beam_files, 100, 200,
                                      snr_threshold=7.0,
                                      output_dir=str(tmp_path / "jax"))
    for b, r in zip(ours["beams"], ref["beams"]):
        assert b["beam"] == r["beam"] and b["chunks_done"] == r["chunks_done"]
        assert b["store"].done_chunks == r["store"].done_chunks
        assert [h[:2] for h in b["hits"]] == [h[:2] for h in r["hits"]]
        for (_, _, info, table), (_, _, rinfo, rtable) in zip(b["hits"],
                                                              r["hits"]):
            assert (info.dm, info.width, info.ibeam, info.nbeams) == \
                (rinfo.dm, rinfo.width, rinfo.ibeam, rinfo.nbeams)
            np.testing.assert_allclose(info.snr, rinfo.snr, rtol=SCORE_RTOL)
            _tables_close(table, rtable, max_exact=True)
    # the candidate files: the same names, the same records
    names = sorted(n for n in os.listdir(tmp_path / "port")
                   if not n.startswith("progress_"))
    assert names == sorted(n for n in os.listdir(tmp_path / "jax")
                           if not n.startswith("progress_"))
    assert any(n.endswith(".table.npz") for n in names)
    for name in names:
        with np.load(tmp_path / "port" / name) as a, \
                np.load(tmp_path / "jax" / name) as b:
            assert sorted(a.files) == sorted(b.files)
    assert ours["coincidence"]["stats"] == ref["coincidence"]["stats"]
    assert [(g["verdict"], g["beams"], g["n_members"])
            for g in ours["coincidence"]["groups"]] == \
        [(g["verdict"], g["beams"], g["n_members"])
         for g in ref["coincidence"]["groups"]]


def test_multibeam_resume_skips_done_chunks(tmp_path):
    fnames = [write_beam(str(tmp_path / f"b{b}.fil"), 64, 4096, seed=10 + b,
                         pulse_dm=150.0 if b == 0 else None)
              for b in range(2)]
    out = str(tmp_path / "out")
    kw = dict(snr_threshold=7.0, device="cpu")
    r1 = multibeam_search(fnames, 100, 200, output_dir=out, max_chunks=3,
                          **kw)
    assert all(b["chunks_done"] == 3 for b in r1["beams"])
    r2 = multibeam_search(fnames, 100, 200, output_dir=out, **kw)
    total = len(r2["beams"][0]["store"].done_chunks)
    assert total > 3
    assert all(b["chunks_done"] == total - 3 for b in r2["beams"])
    ref = multibeam_search(fnames, 100, 200, resume=False,
                           output_dir=str(tmp_path / "ref"), **kw)
    assert [[h[:2] for h in b["hits"]] for b in r2["beams"]] == \
        [[h[:2] for h in b["hits"]] for b in ref["beams"]]
    assert any(b["hits"] for b in ref["beams"])


def test_multibeam_rejects_mismatched_geometry(tmp_path):
    a = write_beam(str(tmp_path / "a.fil"), 64, 4096, seed=0)
    b = write_beam(str(tmp_path / "b.fil"), 32, 4096, seed=1)
    with pytest.raises(BeamGeometryError, match="nchans"):
        open_beams([a, b])
    with pytest.raises(jbatcher.BeamGeometryError):
        jmultibeam.open_beams([a, b])
    with pytest.raises(ValueError, match="at least one"):
        multibeam_search([], device="cpu")


def test_multibeam_canary_per_beam(beam_files, tmp_path):
    ours = multibeam_search(beam_files, 100, 200, snr_threshold=7.0,
                            canary_rate=0.5, canary_seed=3, device="cpu",
                            output_dir=str(tmp_path / "port"))
    ref = jmultibeam.multibeam_search(beam_files, 100, 200,
                                      snr_threshold=7.0, canary_rate=0.5,
                                      canary_seed=3,
                                      output_dir=str(tmp_path / "jax"))
    subsets = []
    for b, r in zip(ours["beams"], ref["beams"]):
        assert b["canary"]["beam"] == r["canary"]["beam"] == b["beam"]
        # the chunks each beam injected into (the curve's chunks) and
        # what it recovered
        for key in ("injected", "recovered", "discarded", "curve"):
            assert b["canary"][key] == r["canary"][key], key
        subsets.append(b["canary"]["injected"])
        # the science hits are the canary-off run's
        assert [h[:2] for h in b["hits"]] == [h[:2] for h in r["hits"]]
    assert sum(subsets) > 0


@pytest.fixture(scope="module")
def packed_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("packed")
    return [write_beam(str(d / f"p{b}.fil"), 64, 4096, seed=20 + b,
                       pulse_dm=150.0 if b == 0 else None, nbits=2)
            for b in range(3)]


def test_multibeam_packed_device_equals_host(packed_files, tmp_path):
    metrics.REGISTRY.reset()
    kw = dict(snr_threshold=6.0, keep_tables=True, device="cpu")
    dev = multibeam_search(packed_files, 100, 200, packed="device",
                           output_dir=str(tmp_path / "dev"), **kw)
    dev_bytes = metrics.REGISTRY.counter("putpu_bytes_uploaded_total").value
    metrics.REGISTRY.reset()
    host = multibeam_search(packed_files, 100, 200, packed="host",
                            output_dir=str(tmp_path / "host"), **kw)
    host_bytes = metrics.REGISTRY.counter("putpu_bytes_uploaded_total").value
    for a, b in zip(dev["beams"], host["beams"]):
        for (i1, t1), (i2, t2) in zip(a["tables"], b["tables"]):
            assert i1 == i2
            _tables_equal(t1, t2)
    assert _files(tmp_path / "dev") == _files(tmp_path / "host")
    assert any(b["hits"] for b in dev["beams"])
    # 2-bit codes: a sixteenth of the float32 bytes
    assert dev_bytes * 16 == host_bytes
    # "auto" is "device" for packed files; against the JAX driver
    auto = multibeam_search(packed_files, 100, 200, packed="auto",
                            output_dir=str(tmp_path / "auto"), **kw)
    ref = jmultibeam.multibeam_search(packed_files, 100, 200,
                                      snr_threshold=6.0, packed="device",
                                      keep_tables=True,
                                      output_dir=str(tmp_path / "jax"))
    for a, b, r in zip(auto["beams"], dev["beams"], ref["beams"]):
        assert [h[:2] for h in a["hits"]] == [h[:2] for h in b["hits"]] \
            == [h[:2] for h in r["hits"]]
        for (_, t1), (_, t2) in zip(a["tables"], r["tables"]):
            _tables_close(t1, t2, max_exact=False)
    with pytest.raises(ValueError, match="packed mode"):
        multibeam_search([write_beam(str(tmp_path / "f.fil"), 64, 4096, 1)],
                         100, 200, packed="device", device="cpu")
    with pytest.raises(ValueError, match="packed="):
        multibeam_search(packed_files, 100, 200, packed="sideways",
                         device="cpu")


# -- coincidence ----------------------------------------------------------------

def cand(beam, t, dm, snr, width=0.002):
    return {"beam": beam, "time": t, "dm": dm, "snr": snr, "width": width}


COINCIDENCE_CASES = {
    "all_beam_rfi": ([cand(b, 10.0, 150.0, 12.0 + 0.1 * b) for b in range(8)],
                     dict(nbeams=8)),
    "single_beam": ([cand(3, 42.0, 300.0, 15.0)], dict(nbeams=8)),
    "adjacent_pair": ([cand(3, 5.0, 200.0, 12.0), cand(4, 5.0, 200.2, 9.0)],
                      dict(nbeams=8)),
    "far_pair": ([cand(1, 5.0, 200.0, 12.0), cand(6, 5.0, 200.2, 9.0)],
                 dict(nbeams=8)),
    "two_beams": ([cand(0, 1.0, 100.0, 10.0), cand(1, 1.0, 100.0, 10.5)],
                  dict(nbeams=2)),
    "distinct": ([cand(0, 10.0, 150.0, 12.0), cand(5, 600.0, 150.0, 11.0)],
                 dict(nbeams=8)),
    "adjacency_map": ([cand(1, 5.0, 200.0, 12.0), cand(7, 5.0, 200.1, 9.0)],
                      dict(nbeams=8, adjacency={1: {7}, 7: {1}})),
    "approx_times": ([dict(cand(b, 3.0, 120.0, 9.0 + b), time_approx=True,
                           span=2.0) for b in range(4)], dict(nbeams=4)),
    "string_labels": ([cand("a", 1.0, 100.0, 10.0),
                       cand("b", 1.0, 100.0, 9.0)], dict(nbeams=5)),
}


def _verdicts(groups):
    return [(g["verdict"], [str(b) for b in g["beams"]], g["n_beams"],
             g["n_members"], g["time"], g["dm"], g["snr"]) for g in groups]


@pytest.mark.parametrize("case", sorted(COINCIDENCE_CASES))
def test_coincidence_equals_jax(case):
    cands, kw = COINCIDENCE_CASES[case]
    ours_stats, ref_stats = {}, {}
    ours = coincidence_sift([dict(c) for c in cands], stats=ours_stats, **kw)
    ref = jcoinc.coincidence_sift([dict(c) for c in cands], stats=ref_stats,
                                  **kw)
    assert _verdicts(ours) == _verdicts(ref)
    assert ours_stats == ref_stats
    assert tcoinc.group_summary(ours) == jcoinc.group_summary(ref)
    expected = {"all_beam_rfi": tcoinc.RFI, "single_beam": tcoinc.CONFIRMED,
                "adjacent_pair": tcoinc.CONFIRMED,
                "far_pair": tcoinc.AMBIGUOUS,
                "adjacency_map": tcoinc.CONFIRMED}.get(case)
    if expected is not None:
        assert ours[0]["verdict"] == expected
    if case == "two_beams":
        assert ours[0]["verdict"] != tcoinc.RFI


_cands = st.lists(st.fixed_dictionaries({
    "beam": st.integers(0, 7),
    "time": st.sampled_from([1.0, 1.2, 5.0, 30.0]),
    "dm": st.floats(90.0, 300.0, allow_nan=False),
    "snr": st.floats(6.0, 40.0, allow_nan=False),
    "width": st.sampled_from([0.0005, 0.002, 0.2])}), max_size=25)


@settings(max_examples=60, deadline=None)
@given(cands=_cands, nbeams=st.integers(1, 8),
       veto_frac=st.sampled_from([0.3, 0.7, 1.0]),
       max_real=st.integers(1, 3), use_map=st.booleans())
def test_coincidence_random_lists_equal_jax(cands, nbeams, veto_frac,
                                            max_real, use_map):
    adjacency = ({b: {(b + 3) % 8} for b in range(8)} if use_map else None)
    kw = dict(nbeams=nbeams, veto_frac=veto_frac, max_real_beams=max_real,
              adjacency=adjacency)
    ours_stats, ref_stats = {}, {}
    ours = coincidence_sift([dict(c) for c in cands], stats=ours_stats, **kw)
    ref = jcoinc.coincidence_sift([dict(c) for c in cands], stats=ref_stats,
                                  **kw)
    assert _verdicts(ours) == _verdicts(ref)
    assert ours_stats == ref_stats


# -- the CLI --------------------------------------------------------------------

def _coincidence_line(text):
    lines = [ln for ln in text.splitlines() if ln.startswith('{"coincidence"')]
    assert len(lines) == 1, text
    return json.loads(lines[0])


def test_cli_prints_the_jax_coincidence_line(beam_files, tmp_path, capsys):
    args = ["--dmmin", "100", "--dmmax", "200", "--snr-threshold", "7",
            "--no-resume"]
    assert tcli.main(beam_files + args + ["--output-dir",
                                          str(tmp_path / "port"),
                                          "--device", "cpu"]) == 0
    ours = _coincidence_line(capsys.readouterr().out)
    assert jcli.main(beam_files + args + ["--output-dir",
                                          str(tmp_path / "jax")]) == 0
    assert ours == _coincidence_line(capsys.readouterr().out)
    assert ours["coincidence"]["verdicts"]["confirmed"] >= 1


def test_cli_serve_and_service_raise(tmp_path):
    # --serve and beams.service are ported (tests/test_torch_service.py):
    # without --http-port the service refuses as the JAX CLI does (exit
    # 2), and without a card it raises before binding anything
    assert tcli.main(["--serve", "--output-dir", str(tmp_path)]) == 2
    assert jcli.main(["--serve", "--output-dir", str(tmp_path)]) == 2
    with pytest.raises(SystemExit):
        tcli.main([])
    from pulsarutils_tpu_torch.beams.service import SurveyService

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--serve", "--http-port", "0", "--output-dir",
                   str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SurveyService(str(tmp_path))
