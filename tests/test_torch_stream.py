"""The port's streaming search and ring sweep (``parallel/stream.py``)
against the JAX package's, on the CPU.

* ``stream_search`` on one list of chunks: the tables and hits of the
  JAX ``stream_search`` for the direct sweep, ``kernel="hybrid"`` and
  ``kernel="fdmt"`` (discrete columns equal, the floats within
  :data:`RTOL`, the tolerance of the port's hybrid and FDMT tests), and
  on a ``(2, 2)`` CPU mesh against the JAX route on its 8-device mesh
  (the JAX package's mesh tolerance, :data:`MESH_RTOL`);
* a generator producer gives what a list gives and is never pulled more
  than one chunk ahead;
* failures: ``skip_failed`` contains one bad chunk, a transient error is
  retried, the deadline bounds a hang, an OOM descends the ladder with
  the same tables bit for bit, configuration errors propagate;
* observers: the canary (the science hits of the canary-off run), health
  and the HTTP surface, lineage and push, the plane consumer (a
  ``ShardedPlane`` handle on the mesh), a packed chunk against its host
  unpack (bit for bit), the budget's per-chunk buckets and retrace flag;
* ``ring_dedisperse`` on ``[cpu] * 8``: within rtol 1e-4 and atol 1e-3 of
  the JAX ring on its 8-device ``time`` mesh and of the global plane (the
  JAX test's tolerances), bit for bit with ``ring_plain``, the multi-hop
  case and both ``ValueError``s.
"""
import json
import socket
import http.server
import threading

import numpy as np
import pytest
import torch

from pulsarutils_tpu.models.simulate import \
    simulate_test_data as jsimulate_test_data
from pulsarutils_tpu.parallel import stream as jstream
from pulsarutils_tpu.parallel.mesh import make_mesh as jax_mesh

from pulsarutils_tpu_torch.faults import FaultPlan, FaultSpec
from pulsarutils_tpu_torch.faults.policy import join_abandoned
from pulsarutils_tpu_torch.io.lowbit import PackedFrames, pack_numpy
from pulsarutils_tpu_torch.obs import metrics
from pulsarutils_tpu_torch.obs.canary import CanaryController
from pulsarutils_tpu_torch.obs.health import HealthEngine
from pulsarutils_tpu_torch.ops.dedisperse import dedisperse_plane_plain
from pulsarutils_tpu_torch.ops.plan import (dedispersion_plan,
                                            dedispersion_shifts,
                                            dedispersion_shifts_batch,
                                            normalize_shifts)
from pulsarutils_tpu_torch.parallel import stream as tstream
from pulsarutils_tpu_torch.parallel.mesh import make_mesh
from pulsarutils_tpu_torch.parallel.sharded_plane import ShardedPlane
from pulsarutils_tpu_torch.parallel.stream import (ring_dedisperse,
                                                   ring_plain, stream_search)
from pulsarutils_tpu_torch.resilience import ladder
from pulsarutils_tpu_torch.utils import nvcc
from pulsarutils_tpu_torch.utils.logging_utils import BudgetAccountant

torch.set_num_threads(1)

GEOM = (1200.0, 200.0, 5e-4)
ARGS = (100.0, 200.0) + GEOM
#: the port's hybrid and FDMT tests' tolerance against the JAX package
RTOL = 1e-5
#: the JAX package's mesh tolerance on the float scores
MESH_RTOL = 1e-4
CPU4 = [torch.device("cpu")] * 4
CPU8 = [torch.device("cpu")] * 8
NCHAN, STEP = 32, 4096


@pytest.fixture(autouse=True)
def _static(monkeypatch):
    monkeypatch.setenv("PUTPU_AUTOTUNE", "off")
    monkeypatch.delenv("PUTPU_PRECISION", raising=False)
    ladder.reset()
    yield
    ladder.reset()


def _series(nchunks=4, seed=3, pulse_chunk=2):
    """Renormalised half-overlapping chunks of one series, as a driver
    searches them: |N(0,1)| / 2, an impulse dispersed at DM 150 in the
    middle of chunk ``pulse_chunk``."""
    rng = np.random.default_rng(seed)
    hop = STEP // 2
    total = hop * (nchunks + 1)
    arr = np.abs(rng.standard_normal((NCHAN, total), dtype=np.float32)) * 0.5
    if pulse_chunk is not None:
        t0 = pulse_chunk * hop + STEP // 2
        shifts = np.rint(dedispersion_shifts(NCHAN, 150.0, *GEOM)).astype(int)
        for c in range(NCHAN):
            arr[c, (t0 + shifts[c]) % total] += 1.5
    chunks = []
    for k in range(nchunks):
        blk = arr[:, k * hop:k * hop + STEP]
        blk = (blk - blk.mean(1, keepdims=True)) / blk.std(1, keepdims=True)
        chunks.append((k * hop, np.ascontiguousarray(blk, dtype=np.float32)))
    return chunks


@pytest.fixture(scope="module")
def chunks():
    return _series()


def _same_results(ours, ref, rtol=RTOL):
    (res, hits), (rres, rhits) = ours, ref
    assert [s for s, _ in res] == [s for s, _ in rres]
    for (_, t), (_, r) in zip(res, rres):
        assert t.argbest() == r.argbest()
        for col in ("DM", "rebin", "peak") + (
                ("exact",) if "exact" in r.colnames else ()):
            np.testing.assert_array_equal(t[col], np.asarray(r[col]),
                                          err_msg=col)
        for col in ("max", "std", "snr"):
            np.testing.assert_allclose(t[col], np.asarray(r[col]),
                                       rtol=rtol, err_msg=col)
    assert [h[0] for h in hits] == [h[0] for h in rhits]
    for (_, _, b), (_, _, rb) in zip(hits, rhits):
        assert b["DM"] == rb["DM"] and b["rebin"] == rb["rebin"]


def _tables_bitwise(a, b):
    (res, hits), (rres, rhits) = a, b
    assert [s for s, _ in res] == [s for s, _ in rres]
    for (_, t), (_, r) in zip(res, rres):
        for col in r.colnames:
            assert np.asarray(t[col]).tobytes() == \
                np.asarray(r[col]).tobytes(), col
    assert [h[0] for h in hits] == [h[0] for h in rhits]


# -- against the JAX package ----------------------------------------------------

@pytest.mark.parametrize("kernel", ["auto", "hybrid", "fdmt"])
def test_stream_matches_jax(chunks, kernel):
    ours = stream_search(list(chunks), *ARGS, kernel=kernel, device="cpu",
                         snr_threshold=7.0)
    ref = jstream.stream_search(list(chunks), *ARGS, kernel=kernel,
                                snr_threshold=7.0)
    _same_results(ours, ref)
    assert ours[1]
    best = max((h[2] for h in ours[1]), key=lambda b: b["snr"])
    assert abs(best["DM"] - 150.0) < 1.0


@pytest.mark.parametrize("kernel", ["auto", "hybrid", "fdmt"])
def test_stream_on_a_mesh_matches_jax_and_one_device(chunks, kernel):
    mesh = make_mesh((2, 2), devices=CPU4)
    ours = stream_search(list(chunks), *ARGS, kernel=kernel, mesh=mesh,
                         device="cpu", snr_threshold=7.0)
    ref = jstream.stream_search(list(chunks), *ARGS, kernel=kernel,
                                mesh=jax_mesh((4, 2), ("dm", "chan")),
                                snr_threshold=7.0)
    _same_results(ours, ref, rtol=MESH_RTOL)
    single = stream_search(list(chunks), *ARGS, kernel=kernel, device="cpu",
                           snr_threshold=7.0)
    _same_results(ours, single, rtol=MESH_RTOL)


def test_iter_lookahead_is_bounded_and_ordered():
    produced, consumed = [], []

    def gen():
        for i in range(10):
            produced.append(i)
            yield i

    for item in tstream._iter_lookahead(gen()):
        consumed.append(item)
        assert len(produced) - len(consumed) <= 2
    assert consumed == list(range(10))
    assert list(tstream._iter_lookahead(iter([]))) == []
    assert list(tstream._iter_lookahead([7])) == \
        list(jstream._iter_lookahead([7])) == [7]


def test_generator_matches_list_and_stays_lazy(chunks):
    state = {"produced": 0, "searched": 0, "max_ahead": 0}

    def producer():
        for item in chunks:
            state["produced"] += 1
            state["max_ahead"] = max(state["max_ahead"],
                                     state["produced"] - state["searched"])
            yield item

    def saw_plane(istart, plane, table):
        state["searched"] += 1
        assert isinstance(plane, torch.Tensor)
        assert plane.shape == (table.nrows, STEP)

    gen = stream_search(producer(), *ARGS, device="cpu",
                        plane_consumer=saw_plane)
    lst = stream_search(list(chunks), *ARGS, device="cpu")
    assert state["produced"] == state["searched"] == len(chunks)
    assert state["max_ahead"] <= 2
    _tables_bitwise(gen, lst)


# -- failures -------------------------------------------------------------------

def test_skip_failed_contains_one_bad_chunk(chunks):
    ref = stream_search(list(chunks), *ARGS, device="cpu")
    plan = FaultPlan([FaultSpec(site="dispatch", chunks=(2048,), times=None)])
    before = metrics.REGISTRY.counter(
        "putpu_stream_chunks_failed_total").value
    with plan.armed():
        res, hits = stream_search(list(chunks), *ARGS, device="cpu",
                                  skip_failed=True)
    assert [s for s, _ in res] == [0, 4096, 6144]
    assert metrics.REGISTRY.counter(
        "putpu_stream_chunks_failed_total").value == before + 1
    kept = [(s, t) for s, t in ref[0] if s != 2048]
    _tables_bitwise((res, hits), (kept, [h for h in ref[1]
                                         if h[0] != 2048]))
    with plan.armed():
        with pytest.raises(RuntimeError, match="injected dispatch"):
            stream_search(list(chunks), *ARGS, device="cpu")


def test_transient_error_is_retried(chunks):
    ref = stream_search(list(chunks), *ARGS, device="cpu")
    before = metrics.REGISTRY.counter("putpu_dispatch_retries_total").value
    plan = FaultPlan([FaultSpec(site="dispatch", chunks=(4096,), times=1)])
    with plan.armed():
        got = stream_search(list(chunks), *ARGS, device="cpu",
                            dispatch_retries=1)
    assert plan.fired() == 1
    assert metrics.REGISTRY.counter(
        "putpu_dispatch_retries_total").value == before + 1
    _tables_bitwise(got, ref)


def test_deadline_bounds_a_hang(chunks):
    plan = FaultPlan([FaultSpec(site="dispatch", kind="hang", seconds=2.0,
                                chunks=(0,), times=1)])
    with plan.armed():
        res, _ = stream_search(list(chunks), *ARGS, device="cpu",
                               dispatch_timeout=0.5, skip_failed=True)
    join_abandoned(timeout=5.0)
    assert [s for s, _ in res] == [2048, 4096, 6144]


@pytest.mark.parametrize("kernel", ["auto", "gather", "hybrid"])
def test_oom_descends_the_ladder_with_the_same_tables(chunks, kernel):
    ref = stream_search(list(chunks), *ARGS, kernel=kernel, device="cpu")
    ladder.reset()
    plan = FaultPlan([FaultSpec(site="dispatch", kind="oom", chunks=(0,),
                                times=1)])
    steps = metrics.REGISTRY.counter(
        "putpu_oom_ladder_steps_total",
        step="unfuse" if kernel == "hybrid" else "split_dm").value
    with plan.armed():
        got = stream_search(list(chunks), *ARGS, kernel=kernel,
                            device="cpu")
    assert plan.fired() == 1
    assert metrics.REGISTRY.counter(
        "putpu_oom_ladder_steps_total",
        step="unfuse" if kernel == "hybrid" else "split_dm").value \
        == steps + 1
    assert ladder.level() == 1
    _tables_bitwise(got, ref)


def test_configuration_errors_propagate(chunks):
    bad = [(0, chunks[0][1][None])]  # (1, nchan, T): not a block
    with pytest.raises(ValueError):
        stream_search(bad, *ARGS, device="cpu", skip_failed=True)
    with pytest.raises(ValueError, match="unknown kernel"):
        stream_search(list(chunks), *ARGS, device="cpu", kernel="nope",
                      skip_failed=True)
    if not torch.cuda.is_available():
        for producer in (list(chunks), []):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                stream_search(producer, *ARGS)


# -- observers ------------------------------------------------------------------

def test_canary_keeps_the_science_hits_and_feeds_health(chunks):
    off = stream_search(list(chunks), *ARGS, device="cpu",
                        snr_threshold=7.0)
    health = HealthEngine()
    canary = CanaryController(rate=1.0, seed=2, dm=120.0, snr=20.0)
    on = stream_search(list(chunks), *ARGS, device="cpu", snr_threshold=7.0,
                       canary=canary, health=health)
    ref_canary = stream_search(list(chunks), *ARGS, device="cpu",
                               snr_threshold=7.0, canary=1.0)
    jref = jstream.stream_search(list(chunks), *ARGS, snr_threshold=7.0,
                                 canary=1.0)
    summary = canary.summary()
    assert summary["injected"] == len(chunks)
    assert summary["recovered"] == len(chunks)
    # the canary outranks the pulse: the pulse is promoted, the hits are
    # the canary-off run's
    assert [h[0] for h in on[1]] == [h[0] for h in off[1]]
    for (_, _, b), (_, _, rb) in zip(on[1], off[1]):
        assert b["DM"] == rb["DM"]
    assert [h[0] for h in ref_canary[1]] == [h[0] for h in jref[1]]
    assert health.snapshot()["updates"] == len(chunks)


def test_canary_in_a_tensor_chunk_equals_a_host_chunk(chunks):
    """A tensor chunk gets the canary where it is, from a subsample of it
    read back: the same floats as the host injection of an array."""
    runs = []
    for wrap in (np.asarray, torch.from_numpy):
        canary = CanaryController(rate=1.0, seed=4, dm=120.0)
        runs.append(stream_search([(s, wrap(c)) for s, c in chunks], *ARGS,
                                  device="cpu", canary=canary))
        assert canary.summary()["recovered"] == len(chunks)
    _tables_bitwise(*runs)
    # the caller's tensor is not modified
    tensor = torch.from_numpy(chunks[0][1].copy())
    stream_search([(0, tensor)], *ARGS, device="cpu", canary=1.0)
    assert torch.equal(tensor, torch.from_numpy(chunks[0][1]))


def test_http_surface_serves_while_the_stream_runs(chunks):
    import urllib.request

    seen = {}

    def consume(istart, plane, table):
        if istart == 2048:
            url = f"http://127.0.0.1:{seen['port']}"
            with urllib.request.urlopen(url + "/progress", timeout=10) as r:
                seen["progress"] = json.loads(r.read())
            with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
                seen["health"] = json.loads(r.read())

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        seen["port"] = s.getsockname()[1]
    stream_search(list(chunks), *ARGS, device="cpu", http_port=seen["port"],
                  plane_consumer=consume)
    doc = seen["progress"]
    assert doc["chunks_total"] == len(chunks) and doc["chunks_done"] == 1
    assert seen["health"]["status"] == "OK"


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


def test_lineage_and_push_publish_each_hit(chunks):
    from pulsarutils_tpu_torch.obs.lineage import LineageRecorder

    sink = _Sink()
    lineage = LineageRecorder(source="stream_search")
    try:
        res, hits = stream_search(list(chunks), *ARGS, device="cpu",
                                  snr_threshold=7.0, lineage=lineage,
                                  push=[sink.url])
    finally:
        sink.close()
    assert hits
    assert sorted(a["chunk"] for a in sink.received) == \
        [h[0] for h in hits]
    assert all(a["source"] == "stream_search" and a["kind"] == "candidate"
               for a in sink.received)
    # a stream writes no lineage doc: each hit closes its latency there
    summary = lineage.summary()
    assert summary["candidates"] == len(hits)
    assert summary["latency"]["n"] == len(hits)


def test_plane_consumer_gets_the_mesh_handle(chunks):
    mesh = make_mesh((2, 2), devices=CPU4)
    planes = []
    res, _ = stream_search(list(chunks[:2]), *ARGS, mesh=mesh, device="cpu",
                           plane_consumer=lambda s, p, t: planes.append(
                               (p, t)))
    assert len(planes) == 2
    for plane, table in planes:
        assert isinstance(plane, ShardedPlane)
        assert plane.shape == (table.nrows, STEP)
    single = []
    stream_search(list(chunks[:2]), *ARGS, device="cpu",
                  plane_consumer=lambda s, p, t: single.append(p))
    # two channel partials added: one reassociated float32 add
    np.testing.assert_allclose(np.asarray(planes[0][0].to_host()),
                               single[0].numpy(), rtol=1e-5, atol=1e-5)


def test_packed_chunk_equals_its_host_unpack():
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, (STEP, NCHAN), dtype=np.uint8)
    frames = pack_numpy(codes.reshape(-1), 2).reshape(STEP, -1)
    packed = PackedFrames(frames, 2, NCHAN, band_descending=True)
    before = metrics.REGISTRY.counter("putpu_bytes_uploaded_total").value
    got = stream_search([(0, packed)], *ARGS, device="cpu")
    mid = metrics.REGISTRY.counter("putpu_bytes_uploaded_total").value
    ref = stream_search([(0, packed.to_host())], *ARGS, device="cpu")
    after = metrics.REGISTRY.counter("putpu_bytes_uploaded_total").value
    _tables_bitwise(got, ref)
    assert (mid - before) * 16 == after - mid
    for kernel in ("gather", "roll"):  # integer sums of the codes
        _tables_bitwise(
            stream_search([(0, packed)], *ARGS, device="cpu",
                          kernel=kernel),
            stream_search([(0, packed.to_host())], *ARGS, device="cpu",
                          kernel=kernel))


def test_upload_counter_counts_only_bytes_that_cross():
    """A host array is uploaded (its float32 bytes counted); a tensor
    already on the search's device crosses nothing."""
    rng = np.random.default_rng(12)
    block = rng.normal(size=(NCHAN, STEP)).astype(np.float32)
    before = metrics.REGISTRY.counter("putpu_bytes_uploaded_total").value
    host = stream_search([(0, block)], *ARGS, device="cpu")
    mid = metrics.REGISTRY.counter("putpu_bytes_uploaded_total").value
    dev = stream_search([(0, torch.from_numpy(block))], *ARGS, device="cpu")
    after = metrics.REGISTRY.counter("putpu_bytes_uploaded_total").value
    assert mid - before == block.nbytes and after == mid
    _tables_bitwise(host, dev)


def test_budget_buckets_and_retrace_flag(monkeypatch):
    rng = np.random.default_rng(0)
    chunks = [(0, rng.normal(size=(16, 512)).astype(np.float32)),
              (256, rng.normal(size=(16, 512)).astype(np.float32)),
              (512, rng.normal(size=(16, 384)).astype(np.float32))]
    from pulsarutils_tpu_torch.ops import search as tsearch

    real = tsearch.dedispersion_search
    built = set()

    def building_search(data, *args, **kwargs):
        # a kernel build the first time a length is seen, as a new
        # geometry's first launch builds on the card
        n = np.shape(data)[1]
        if n not in built:
            built.add(n)
            with nvcc.COMPILES_LOCK:
                nvcc.COMPILES["count"] += 1
                nvcc.COMPILES["secs"] += 0.1
        return real(data, *args, **kwargs)

    monkeypatch.setattr(tsearch, "dedispersion_search", building_search)
    acct = BudgetAccountant()
    results, _ = stream_search(chunks, 100, 200, *GEOM, device="cpu",
                               budget=acct)
    assert len(results) == 3 and len(acct.chunks) == 3
    assert all("search" in rec["buckets"] for rec in acct.chunks)
    assert all(rec["counters"].get("dispatches") for rec in acct.chunks)
    assert "retrace" not in acct.chunks[0]
    assert "retrace" not in acct.chunks[1]
    assert acct.chunks[2].get("retrace") is True


# -- the ring sweep -------------------------------------------------------------

def _ring_case(case):
    if case == "sim":
        array, header = jsimulate_test_data(150, nchan=64, nsamples=4096,
                                            rng=4)
        dms = dedispersion_plan(64, 100, 200., header["fbottom"],
                                header["bandwidth"], header["tsamp"])[:16]
    else:  # the span (~229 samples at DM 150) far exceeds the 32 a shard
        array, header = jsimulate_test_data(150, nchan=16, nsamples=256,
                                            rng=4)
        dms = np.array([140.0, 150.0, 160.0])
    return (np.asarray(array, dtype=np.float32),
            (dms, header["fbottom"], header["bandwidth"], header["tsamp"]))


@pytest.mark.parametrize("case", ["sim", "multihop"])
def test_ring_matches_jax_and_the_global_plane(case):
    array, args = _ring_case(case)
    mesh = make_mesh((8,), ("time",), devices=CPU8)
    ours = ring_dedisperse(array, *args, mesh)
    assert ours.dtype == torch.float32 and ours.device.type == "cpu"
    ref = np.asarray(jstream.ring_dedisperse(array, *args,
                                             jax_mesh((8,), ("time",))))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-3)
    dms, f0, bw, ts = args
    shifts = dedispersion_shifts_batch(dms, array.shape[0], f0, bw, ts)
    offsets = normalize_shifts(shifts, array.shape[1])
    plane = dedisperse_plane_plain(torch.from_numpy(array), offsets).numpy()
    np.testing.assert_allclose(ours.numpy(), plane, rtol=1e-4, atol=1e-3)
    # its plain program, bit for bit; on 2 or 4 shards too
    assert torch.equal(ours, ring_plain(array, *args, 8))
    for n in (2, 4):
        m = make_mesh((n,), ("time",), devices=[torch.device("cpu")] * n)
        assert torch.equal(ring_dedisperse(torch.from_numpy(array), *args,
                                           m), ring_plain(array, *args, n))


def test_ring_hops_and_bounded_workspace(monkeypatch):
    array, args = _ring_case("multihop")
    offsets, base, span = tstream.ring_offsets(args[0], 16, *args[1:])
    assert offsets.min() == 0 and offsets.max() == span
    assert span > 32
    _, t_loc, n_hops, rotation = tstream._ring_geometry(
        16, 256, 8, *args)
    assert (t_loc, n_hops) == (32, -(-(span + 1) // 32))
    assert rotation == (-base) % 256
    # every step adds one channel's (ndm, T_loc) window to its shard's
    # (ndm, T_loc) accumulator; a hop skips the channels valid for no
    # trial and masks those valid for some: both occur here, and the
    # sums stay its plain program's bit for bit
    steps = []
    real = tstream._ring_accumulate

    def spy(acc, cur, nxt, rel, valid, host_valid):
        steps.append((tuple(acc.shape), tuple(cur.shape), host_valid.copy()))
        np.testing.assert_array_equal(valid.numpy(), host_valid)
        return real(acc, cur, nxt, rel, valid, host_valid)

    monkeypatch.setattr(tstream, "_ring_accumulate", spy)
    mesh = make_mesh((8,), ("time",), devices=CPU8)
    assert torch.equal(ring_dedisperse(array, *args, mesh),
                       ring_plain(array, *args, 8))
    assert len(steps) == 8 * n_hops
    assert all(a == (len(args[0]), t_loc) and c == (16, t_loc)
               for a, c, _ in steps)
    per_chan = [(v.any(axis=0), v.all(axis=0)) for _, _, v in steps]
    assert any((~anyv).any() for anyv, _ in per_chan)
    assert any((anyv & ~allv).any() for anyv, allv in per_chan)


def test_ring_value_errors():
    array, header = jsimulate_test_data(150, nchan=32, nsamples=256, rng=4)
    geom = (header["fbottom"], header["bandwidth"], header["tsamp"])
    mesh = make_mesh((8,), ("time",), devices=CPU8)
    with pytest.raises(ValueError, match="exceeds the sequence length"):
        ring_dedisperse(array, [3000.0], *geom, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        ring_dedisperse(array[:, :250], [150.0], *geom, mesh)
    with pytest.raises(ValueError, match="exceeds the sequence length"):
        jstream.ring_dedisperse(array, [3000.0], *geom,
                                jax_mesh((8,), ("time",)))
