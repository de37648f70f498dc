"""The budget accountant's device timing and launch counts, on the CPU.

A card's stage times come from pairs of CUDA events that the accountant
records on the stream and reads without a wait.  Here a fake event class
and a fake stream stand in for the card's (patched into the accountant's
seams): the pairs resolve into each chunk's ``device_s`` at chunk close
and at the entry's return; with timing off no event is made and no record
has the key; the budgeted loop never synchronises the stream; the B1 and
B4 launch counters count a chunk's launches; and ``multibeam_search``
labels its epoch's host work (hit products, candidate and ledger writes,
uploads).
"""
import itertools

import numpy as np
import pytest
import torch

from pulsarutils_tpu_torch.beams import multibeam_search
from pulsarutils_tpu_torch.io.sigproc import write_simulated_filterbank
from pulsarutils_tpu_torch.models.simulate import simulate_test_data
from pulsarutils_tpu_torch.obs import metrics, trace
from pulsarutils_tpu_torch.ops import dedisperse_cuda, score_cuda
from pulsarutils_tpu_torch.pipeline.search_pipeline import search_by_chunks
from pulsarutils_tpu_torch.utils import logging_utils
from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant

torch.set_num_threads(1)

SEARCH = dict(dmmin=100.0, dmmax=200.0, chunk_length=1.024,
              snr_threshold=6.0)


class FakeStream:
    """The card's stream: ``reached`` is the last event it has passed."""

    def __init__(self):
        self.reached = float("inf")
        self.recorded = 0
        self.syncs = 0

    def synchronize(self):
        self.syncs += 1


class FakeEvent:
    """A timing event: ``record`` stamps it with the next tick (one tick a
    millisecond) and its place on the stream."""

    made = []
    ticks = itertools.count(1)

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.stream = self.seq = self.tick = None
        FakeEvent.made.append(self)

    def record(self, stream):
        self.stream = stream
        self.tick = self.seq = next(FakeEvent.ticks)
        stream.recorded += 1

    def query(self):
        return self.seq <= self.stream.reached

    def elapsed_time(self, end):
        assert self.query() and end.query()
        return float(end.tick - self.tick)


@pytest.fixture
def fake_card(monkeypatch):
    """Fake events on any device and a fake current stream; the stream's
    and the device's synchronise are counted."""
    stream = FakeStream()
    syncs = []
    FakeEvent.made = []
    FakeEvent.ticks = itertools.count(1)
    monkeypatch.setattr(logging_utils, "_timing_event_class",
                        lambda device: FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: syncs.append(device))
    stream.device_syncs = syncs
    yield stream
    trace.stop_tracing()
    metrics.REGISTRY.reset()


@pytest.fixture(scope="module")
def pulse_file(tmp_path_factory):
    array, header = simulate_test_data(150.0, nsamples=16384, nchan=32,
                                       signal=10.0, noise=4.0, rng=7)
    path = tmp_path_factory.mktemp("timing") / "pulse.fil"
    write_simulated_filterbank(str(path), array + 20.0, header,
                               descending=True, nbits=8)
    return str(path)


# -- the accountant -----------------------------------------------------------

def test_pending_pairs_resolve_at_chunk_close_and_at_return(fake_card):
    acct = BudgetAccountant()
    acct.enable_device_timing("cpu")
    fake_card.reached = 0                   # the stream has passed nothing
    with acct.chunk(0):
        with acct.bucket("clean"):          # events 1, 2
            pass
        with acct.bucket("search"):         # events 3, 6
            with logging_utils.budget_bucket("search/dispatch"):  # 4, 5
                pass
    first = acct.chunks[0]
    assert "device_s" not in first and len(acct._pending) == 3
    fake_card.reached = 2                   # past clean's end only
    with acct.chunk(1):
        pass
    assert first["device_s"] == {"clean": pytest.approx(1e-3)}
    assert "device_s" not in acct.chunks[1]
    fake_card.reached = float("inf")
    acct.resolve_device_times()             # the entry's return
    assert first["device_s"] == {"clean": pytest.approx(1e-3),
                                 "search": pytest.approx(3e-3),
                                 "search/dispatch": pytest.approx(1e-3)}
    assert not acct._pending
    # a bucket opened twice in a chunk sums; the resolved events are
    # reused, and nothing waited
    made = len(FakeEvent.made)
    with acct.chunk(2):
        for _ in range(2):
            with acct.bucket("search"):
                pass
    assert len(FakeEvent.made) == made == 6
    assert acct.chunks[2]["device_s"] == {"search": pytest.approx(2e-3)}
    assert fake_card.syncs == 0 and not fake_card.device_syncs
    # buckets stay host walls
    assert set(first["buckets"]) == {"clean", "search", "search/dispatch"}


def test_pairs_the_stream_has_not_reached_stay_pending(fake_card):
    acct = BudgetAccountant()
    acct.enable_device_timing("cpu")
    fake_card.reached = 1                   # the start, not the end
    with acct.chunk(0):
        with acct.bucket("search"):
            pass
    acct.resolve_device_times()
    assert "device_s" not in acct.chunks[0] and len(acct._pending) == 1
    fake_card.reached = float("inf")
    acct.resolve_device_times()
    assert acct.chunks[0]["device_s"] == {"search": pytest.approx(1e-3)}


def test_no_events_without_device_timing(fake_card):
    acct = BudgetAccountant()
    with acct.chunk(0):
        with acct.bucket("search"):
            with logging_utils.budget_bucket("search/dispatch"):
                pass
    acct.resolve_device_times()
    assert not FakeEvent.made and fake_card.recorded == 0
    assert "device_s" not in acct.chunks[0]
    assert "device_s" not in acct.to_json()["per_chunk"][0]


def _one_bucket(acct):
    with acct.bucket("persist"):
        pass


def test_only_the_enabling_thread_records_events(fake_card):
    import threading

    acct = BudgetAccountant()
    acct.enable_device_timing("cpu")
    with acct.chunk(0):
        worker = threading.Thread(target=lambda: acct.add_async(
            "persist", 0.5))
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
        other = threading.Thread(target=_one_bucket, args=(acct,))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
    assert not FakeEvent.made


def test_off_a_card_device_timing_is_off(monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda **kw: made.append(kw))
    acct = BudgetAccountant()
    acct.enable_device_timing(torch.device("cpu"))
    with acct.chunk(0):
        with acct.bucket("search"):
            pass
    assert not made and "device_s" not in acct.chunks[0]
    assert logging_utils._timing_event_class(torch.device("cpu")) is None


# -- the launch counters ------------------------------------------------------

def test_launch_counters_count_the_chunks_launches(fake_card, monkeypatch):
    acct = BudgetAccountant()
    with acct.chunk(0):
        monkeypatch.setattr(score_cuda, "launches", score_cuda.launches + 3)
        monkeypatch.setattr(dedisperse_cuda, "launches",
                            dedisperse_cuda.launches + 2)
    with acct.chunk(1):
        monkeypatch.setattr(score_cuda, "launches", score_cuda.launches + 1)
    with acct.chunk(2):
        pass
    c0, c1, c2 = (c["counters"] for c in acct.chunks)
    assert c0 == {"b1_launches": 2, "b4_launches": 3}
    assert c1 == {"b4_launches": 1}
    assert c2 == {}
    assert acct.counters_total == {"b1_launches": 2, "b4_launches": 4}
    assert metrics.REGISTRY.counter("putpu_b4_launches_total").value == 4
    assert metrics.REGISTRY.counter("putpu_b1_launches_total").value == 2


# -- the entries --------------------------------------------------------------

@pytest.mark.parametrize("asks", ["budget", "stage_seconds", "tracer",
                                  None])
def test_search_by_chunks_times_stages_only_when_asked(fake_card, asks,
                                                       pulse_file, tmp_path):
    acct = BudgetAccountant()
    kw = {}
    if asks == "budget":
        kw["budget"] = acct
    elif asks == "stage_seconds":
        kw["stage_seconds"] = {}
    elif asks == "tracer":
        trace.start_tracing()
    summary = {}
    # a budget is read for its records; the others use the loop's own
    hits, _ = search_by_chunks(pulse_file, device="cpu", make_plots=False,
                               output_dir=str(tmp_path), summary=summary,
                               **kw, **SEARCH)
    assert summary["searched"] == 7
    assert fake_card.syncs == 0 and not fake_card.device_syncs
    if asks is None:
        assert not FakeEvent.made and fake_card.recorded == 0
        return
    assert FakeEvent.made and fake_card.recorded >= 2 * 7 * 3
    if asks != "budget":
        return
    assert len(acct.chunks) == 7 and not acct._pending
    for rec in acct.chunks:
        # every bucket of the chunk has its device interval
        assert set(rec["device_s"]) == set(rec["buckets"])
        assert {"read", "clean", "search"} <= set(rec["device_s"])
        assert all(v > 0 for v in rec["device_s"].values())
    # the events made are the most in flight at once, not one a bucket
    assert len(FakeEvent.made) < fake_card.recorded


def _beam_file(path, seed, pulse_dm=None, nchan=64, nsamples=4096):
    rng = np.random.default_rng(seed)
    arr = np.abs(rng.normal(0, 0.5, (nchan, nsamples))) + 10.0
    header = {"bandwidth": 200.0, "fbottom": 1200.0, "nchans": nchan,
              "nsamples": nsamples, "tsamp": 0.0005, "foff": 200.0 / nchan}
    if pulse_dm is not None:
        pulse, _ = simulate_test_data(
            dm=pulse_dm, nchan=nchan, nsamples=nsamples,
            tsamp=header["tsamp"], start_freq=header["fbottom"],
            bandwidth=header["bandwidth"], signal=8.0, noise=0.0, rng=99)
        arr = arr + pulse
    write_simulated_filterbank(path, arr, header, descending=True, nbits=8)
    return path


def test_multibeam_budget_labels_the_epoch(fake_card, tmp_path):
    files = [_beam_file(str(tmp_path / f"beam{b}.fil"), b,
                        pulse_dm=150.0 if b == 1 else None)
             for b in range(3)]
    acct = BudgetAccountant()
    out = multibeam_search(files, 100, 200, snr_threshold=7.0,
                           output_dir=str(tmp_path / "out"), budget=acct,
                           device="cpu")
    hits = [h[0] for b in out["beams"] for h in b["hits"]]
    epochs = [rec["chunk"] for rec in acct.chunks]
    assert hits and set(hits) < set(epochs)
    for rec in acct.chunks:
        n_hits = hits.count(rec["chunk"])
        buckets = rec["buckets"]
        assert "persist/ledger" in buckets
        assert ("hit_products" in buckets) == ("persist/candidate"
                                               in buckets) == (n_hits > 0)
        assert set(rec["device_s"]) == set(buckets)
    assert acct.counts["persist/ledger"] == 3 * len(epochs)
    assert acct.counts["hit_products"] == len(hits)
    assert acct.counts["persist/candidate"] == len(hits)
    # one upload a host beam, inside the batch's dispatch
    assert acct.counts["search/dispatch/upload"] == 3 * len(epochs)
    assert acct.counts["search/dispatch"] == len(epochs)
    assert not acct._pending
    assert fake_card.syncs == 0 and not fake_card.device_syncs


def test_multibeam_without_a_budget_makes_no_event(fake_card, tmp_path):
    files = [_beam_file(str(tmp_path / f"beam{b}.fil"), b)
             for b in range(2)]
    multibeam_search(files, 100, 200, snr_threshold=7.0, max_chunks=2,
                     output_dir=str(tmp_path / "out"), device="cpu")
    assert not FakeEvent.made and fake_card.recorded == 0
