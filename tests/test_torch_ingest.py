"""The port's live feed (``io/packets.py``, ``ingest/``,
``resilience/shedding.py``, the ``ingest`` fault site and ``PUingest``)
against the JAX package's, on the CPU.

* the wire: ``encode_packet`` and ``packetize_array`` bytes equal the JAX
  package's for float32, 1/2/4-bit packed and descending payloads; each
  package decodes the other's bytes; header and CRC rejections raise the
  same classes with the same messages;
* the assembler: every scenario of the JAX package's ``test_ingest.py``
  fed the same packet sequence to both assemblers gives byte-equal chunks
  (a packed feed delivers ``PackedFrames`` with equal frames), an equal
  ``summary()``, equal ledger journals, byte-equal quarantine manifests
  and the same health verdicts and reasons;
* the feeds, on loopback sockets bound to port 0: a lossless TCP feed
  searched by ``stream_search(device="cpu")`` gives the port's disk
  stream's tables bit for bit and the JAX disk stream's within
  :data:`RTOL` (discrete columns equal); the UDP roundtrip (the ledger
  balances; bytes compared only when nothing was lost); the idle timeout
  with and without a connection; a counted reconnect; a corrupt packet
  that becomes a gap; each ``ingest`` fault kind through ``feed_tcp``
  against the JAX feeder's outcome;
* ``PUingest feed --out`` writes the JAX CLI's bytes; ``listen`` over
  TCP exits 0 with the ledger balanced, and raises without a card.

Every source has an idle timeout or is closed in a ``finally``, every
thread is joined with a timeout.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from pulsarutils_tpu.cli import ingest_main as jingest_main
from pulsarutils_tpu.faults import inject as jinject
from pulsarutils_tpu.faults.policy import \
    QuarantineManifest as JQuarantineManifest
from pulsarutils_tpu.ingest import ChunkAssembler as JChunkAssembler
from pulsarutils_tpu.ingest import source as jsource
from pulsarutils_tpu.io import packets as jpackets
from pulsarutils_tpu.obs.health import HealthEngine as JHealthEngine
from pulsarutils_tpu.parallel import stream as jstream
from pulsarutils_tpu.resilience import shedding as jshedding

from pulsarutils_tpu_torch.cli import ingest_main
from pulsarutils_tpu_torch.faults import inject as tinject
from pulsarutils_tpu_torch.faults import reasons
from pulsarutils_tpu_torch.faults.policy import QuarantineManifest
from pulsarutils_tpu_torch.ingest import (ChunkAssembler, TCPSource,
                                          UDPSource, feed_tcp, feed_udp)
from pulsarutils_tpu_torch.ingest import source as tsource
from pulsarutils_tpu_torch.io import packets
from pulsarutils_tpu_torch.io.lowbit import PackedFrames
from pulsarutils_tpu_torch.io.sigproc import (FilterbankReader,
                                              write_simulated_filterbank)
from pulsarutils_tpu_torch.obs.health import HealthEngine
from pulsarutils_tpu_torch.parallel.stream import stream_search
from pulsarutils_tpu_torch.resilience import (ShedPolicy, ladder,
                                              resolve_shed_policy)

torch.set_num_threads(1)

#: the port's scorer against the JAX package's (the f32 policy's
#: ``score_rtol``): they sum in different orders
RTOL = 1e-4
TSAMP = 5e-4


@pytest.fixture(autouse=True)
def _static(monkeypatch):
    monkeypatch.setenv("PUTPU_AUTOTUNE", "off")
    monkeypatch.delenv("PUTPU_PRECISION", raising=False)
    ladder.reset()
    yield
    ladder.reset()


def make_block(nchan, nsamps, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(10.0, 1.0, (nchan, nsamps)).astype(np.float32)


def make_codes(nchan, nsamps, nbits, seed=0):
    """Packed frames ``(nsamps, bytes_per_frame)`` of random codes."""
    rng = np.random.default_rng(seed)
    width = packets.frame_nbytes(nchan, nbits)
    return rng.integers(0, 256, (nsamps, width), dtype=np.uint8)


# -- the wire -----------------------------------------------------------------

WIRE_CASES = {
    "float32": dict(data=lambda: make_block(8, 100, 1), spp=32),
    "float32_descending": dict(data=lambda: make_block(8, 100, 2), spp=16,
                               band_descending=True),
    "packed_1bit": dict(data=lambda: make_codes(24, 50, 1, 3), spp=16,
                        nbits=1, nchan=24),
    "packed_2bit": dict(data=lambda: make_codes(16, 70, 2, 4), spp=32,
                        nbits=2, nchan=16),
    "packed_4bit_descending": dict(data=lambda: make_codes(10, 33, 4, 5),
                                   spp=8, nbits=4, nchan=10,
                                   band_descending=True),
    "packed_2bit_padded": dict(data=lambda: make_codes(14, 20, 2, 6),
                               spp=7, nbits=2, nchan=14),
}


def _packetize(mod, case, **extra):
    kw = {k: v for k, v in case.items() if k not in ("data", "spp")}
    return mod.packetize_array(case["data"](),
                               samples_per_packet=case["spp"], **kw, **extra)


@pytest.mark.parametrize("name", sorted(WIRE_CASES))
def test_packetize_bytes_equal_jax_and_cross_decode(name):
    case = WIRE_CASES[name]
    ours = _packetize(packets, case, sample0=4096, seq0=7)
    theirs = _packetize(jpackets, case, sample0=4096, seq0=7)
    assert ours == theirs
    for buf in ours:
        mine, n = packets.decode_packet(buf)
        jax_pkt, jn = jpackets.decode_packet(buf)
        assert n == jn == len(buf)
        for field in ("seq", "sample0", "nsamps", "nchan", "chan0",
                      "nbits", "band_descending", "payload"):
            assert getattr(mine, field) == getattr(jax_pkt, field), field
        np.testing.assert_array_equal(mine.frames(), jax_pkt.frames())


@pytest.mark.parametrize("nbits, nchan", [(0, 5), (1, 17), (2, 9), (4, 3)])
def test_encode_packet_and_frame_nbytes_equal_jax(nbits, nchan):
    fb = packets.frame_nbytes(nchan, nbits)
    assert fb == jpackets.frame_nbytes(nchan, nbits)
    payload = bytes(range(256))[:fb] * 3
    kw = dict(seq=2 ** 40, sample0=2 ** 33 + 5, nchan=nchan, nbits=nbits,
              payload=payload, chan0=0, band_descending=bool(nbits % 2))
    assert packets.encode_packet(**kw) == jpackets.encode_packet(**kw)


def _bad_buffers():
    good = packets.encode_packet(seq=3, sample0=0, nchan=2, nbits=0,
                                 payload=np.ones(4, np.float32).tobytes())
    crc = bytearray(good)
    crc[packets.HEADER_SIZE] ^= 0xFF
    nbits = bytearray(good)
    nbits[5] = 3
    length = bytearray(good)
    length[32] ^= 0x01
    return {"magic": b"XXXX" + good[4:],
            "version": good[:4] + b"\x09" + good[5:],
            "short_header": good[:packets.HEADER_SIZE - 1],
            "short_payload": good[:-1], "crc": bytes(crc),
            "nbits": bytes(nbits), "payload_len": bytes(length)}


@pytest.mark.parametrize("name", sorted(_bad_buffers()))
def test_decode_rejections_raise_the_jax_classes(name):
    buf = _bad_buffers()[name]
    with pytest.raises(packets.PacketError) as ours:
        packets.decode_packet(buf)
    with pytest.raises(jpackets.PacketError) as theirs:
        jpackets.decode_packet(buf)
    assert type(ours.value).__name__ == type(theirs.value).__name__
    assert str(ours.value) == str(theirs.value)
    assert isinstance(ours.value, packets.PacketCorruptError) \
        == (name == "crc")


def test_encode_rejections_equal_jax():
    for mod in (packets, jpackets):
        with pytest.raises(mod.PacketError, match="whole number"):
            mod.encode_packet(seq=0, sample0=0, nchan=2, nbits=0,
                              payload=b"abc")
        with pytest.raises(mod.PacketError, match="unsupported nbits"):
            mod.frame_nbytes(4, 3)
        with pytest.raises(mod.PacketError, match="bytes/frame"):
            mod.packetize_array(make_codes(16, 4, 2), nbits=2, nchan=20)


def _reader(parts):
    buf = bytearray(b"".join(parts))

    def read(n):
        out = bytes(buf[:n])
        del buf[:n]
        return out

    return read


def test_read_packet_stream_equals_jax():
    bufs = packets.packetize_array(make_block(2, 6), samples_per_packet=2)
    torn = bytearray(bufs[1])
    torn[packets.HEADER_SIZE] ^= 0xFF
    stream = [bufs[0], bytes(torn), bufs[2]]
    for mod in (packets, jpackets):
        skipped = []
        got = list(mod.read_packet_stream(_reader(stream),
                                          on_corrupt=skipped.append))
        assert [p.seq for p in got] == [0, 2] and len(skipped) == 1
        with pytest.raises(mod.PacketCorruptError):
            list(mod.read_packet_stream(_reader(stream)))
        with pytest.raises(mod.PacketError, match="mid-packet"):
            list(mod.read_packet_stream(_reader([bufs[0][:-3]])))


@pytest.mark.parametrize("policy, chunk_nbytes", [
    (8, None), (1, 10), (None, 5), ("off", 5), (3, 1 << 20),
    (ShedPolicy(max_chunks=4, max_bytes=100), 30),
    (ShedPolicy(max_chunks=None, max_bytes=100), 1000)])
def test_shed_policy_equals_jax(policy, chunk_nbytes):
    ours = resolve_shed_policy(policy)
    jpolicy = policy
    if isinstance(policy, ShedPolicy):
        jpolicy = jshedding.ShedPolicy(policy.max_chunks, policy.max_bytes)
    theirs = jshedding.resolve_shed_policy(jpolicy)
    assert ours.to_json() == theirs.to_json()
    assert ours.max_queued(chunk_nbytes) == theirs.max_queued(chunk_nbytes)
    for queued in range(6):
        assert ours.should_shed(queued, chunk_nbytes) \
            == theirs.should_shed(queued, chunk_nbytes)
    with pytest.raises(ValueError, match="max_chunks"):
        ShedPolicy(max_chunks=0)


# -- the assembler ------------------------------------------------------------

def _scenario(name, tmp_path):
    """``(encoded packets, assembler kwargs, extra pushes)`` of one JAX
    ``test_ingest.py`` scenario; ``extra`` is pushed after the list."""
    pkt = jpackets.packetize_array
    if name == "in_order":
        return pkt(make_block(8, 192, 1), samples_per_packet=16), \
            dict(nchan=8, step=64), []
    if name == "reorder":
        bufs = pkt(make_block(4, 128, 3), samples_per_packet=16)
        bufs[2], bufs[3] = bufs[3], bufs[2]
        return bufs, dict(nchan=4, step=64, reorder_window=32), []
    if name == "gap":
        bufs = pkt(make_block(4, 128, 4), samples_per_packet=16)
        del bufs[1]
        return bufs, dict(nchan=4, step=64), []
    if name == "unrecoverable_gap":
        bufs = pkt(make_block(4, 128, 5), samples_per_packet=8)
        return [bufs[0]] + bufs[8:], dict(nchan=4, step=64,
                                          manifest=True), []
    if name == "strict_gap":
        bufs = pkt(make_block(4, 128, 5), samples_per_packet=8)
        del bufs[3]
        return bufs, dict(nchan=4, step=64, policy="strict",
                          manifest=True), []
    if name == "duplicate":
        bufs = pkt(make_block(4, 64, 6), samples_per_packet=16)
        return bufs, dict(nchan=4, step=64), [bufs[1]]
    if name == "descending":
        wire = make_block(4, 32, 7)[::-1]
        return pkt(wire, samples_per_packet=8, band_descending=True), \
            dict(nchan=4, step=32, band_descending=True), []
    if name == "geometry_mismatch":
        return pkt(make_block(4, 16), samples_per_packet=16), \
            dict(nchan=8, step=64), []
    if name == "shed":
        return pkt(make_block(4, 256, 8), samples_per_packet=64), \
            dict(nchan=4, step=64, shed=1, manifest=True), []
    if name == "wedged_consumer":
        return pkt(make_block(4, 16 * 256, 9), samples_per_packet=256), \
            dict(nchan=4, step=256, shed=2), []
    if name == "far_future":
        tail = make_block(4, 16, 10)
        return pkt(tail, samples_per_packet=16) + pkt(
            tail, samples_per_packet=16, sample0=8 * 64), \
            dict(nchan=4, step=64, reorder_window=64, manifest=True), []
    if name == "health":
        bufs = pkt(make_block(4, 128, 15), samples_per_packet=16)
        del bufs[1]
        return bufs, dict(nchan=4, step=64, health=True), []
    if name == "multi_tile_descending":
        # chunks of several transpose tiles and a remainder
        wire = make_block(6, 1800, 11)[::-1]
        return pkt(wire, samples_per_packet=100, band_descending=True), \
            dict(nchan=6, step=600, band_descending=True), []
    if name == "offset_start":
        # a stream that starts mid-chunk: some chunks wrap the ring
        return pkt(make_block(4, 64 * 20, 12), samples_per_packet=16,
                   sample0=37), dict(nchan=4, step=64, start_sample=37), []
    if name == "partial_tail":
        return pkt(make_block(4, 150, 16), samples_per_packet=16), \
            dict(nchan=4, step=64), []
    if name.startswith("packed_"):
        nbits = int(name.split("_")[1][0])
        descending = name.endswith("descending")
        codes = make_codes(12, 96, nbits, 17 + nbits)
        bufs = pkt(codes, samples_per_packet=16, nbits=nbits, nchan=12,
                   band_descending=descending)
        del bufs[2]
        return bufs, dict(nchan=12, step=48, nbits=nbits,
                          band_descending=descending), []
    raise KeyError(name)


SCENARIOS = ["in_order", "reorder", "gap", "unrecoverable_gap",
             "strict_gap", "duplicate", "descending", "geometry_mismatch",
             "shed", "wedged_consumer", "far_future", "health",
             "multi_tile_descending", "offset_start", "partial_tail", "packed_1bit", "packed_2bit_descending",
             "packed_4bit"]


def _run_assembler(mod_packets, asm_cls, manifest_cls, health_cls, bufs,
                   kw, extra, out_dir):
    kw = dict(kw)
    if kw.pop("manifest", False):
        kw["manifest"] = manifest_cls(str(out_dir), "ingest")
    if kw.pop("health", False):
        kw["health"] = health_cls(recover_after=1, gap_degraded=0.0)
    asm = asm_cls(**kw)
    placed = [asm.push(mod_packets.decode_packet(b)[0])
              for b in bufs + extra]
    asm.close()
    got = []
    for istart, chunk in asm.chunks():
        if hasattr(chunk, "frames"):
            got.append((istart, "packed", chunk.nbits, chunk.nchan,
                        chunk.band_descending,
                        np.asarray(chunk.frames).tobytes()))
        else:
            got.append((istart, chunk.dtype.str, chunk.shape,
                        np.asarray(chunk).tobytes()))
    health = kw.get("health")
    return {"placed": placed, "chunks": got, "summary": asm.summary(),
            "journal": asm.ledger.journal,
            "manifest": (open(kw["manifest"].path, "rb").read()
                         if "manifest" in kw
                         and os.path.exists(kw["manifest"].path) else None),
            "health": (None if health is None else
                       (health.verdict, health.reasons(), [
                           {k: v for k, v in i.items() if k != "t"}
                           for i in health.snapshot()["incidents"]]))}


@pytest.mark.parametrize("name", SCENARIOS)
def test_assembler_scenario_equals_jax(name, tmp_path):
    bufs, kw, extra = _scenario(name, tmp_path)
    ours = _run_assembler(packets, ChunkAssembler, QuarantineManifest,
                          HealthEngine, bufs, kw, extra, tmp_path / "port")
    theirs = _run_assembler(jpackets, JChunkAssembler, JQuarantineManifest,
                            JHealthEngine, bufs, kw, extra, tmp_path / "jax")
    assert ours == theirs
    assert ours["summary"]["ledger"]["unaccounted"] == 0


def test_assembler_packed_chunk_is_packed_frames_owning_a_copy():
    bufs, kw, _ = _scenario("packed_2bit_descending", None)
    asm = ChunkAssembler(**kw)
    for b in bufs:
        asm.push(packets.decode_packet(b)[0])
    asm.close()
    chunks = list(asm.chunks())
    assert chunks and all(isinstance(c, PackedFrames) for _, c in chunks)
    assert all(c.band_descending and c.shape == (12, 48)
               for _, c in chunks)
    # the ring is recycled (zeroed) at the cut: a delivered chunk holds its
    # own copy, never a view of the ring
    assert not any(np.shares_memory(c.frames, asm._buf) for _, c in chunks)


def test_float_chunk_never_views_the_ring():
    block = make_block(4, 256, 21)
    asm = ChunkAssembler(nchan=4, step=64, reorder_window=16)
    first = None
    for k, buf in enumerate(packets.packetize_array(block,
                                                    samples_per_packet=16)):
        asm.push(packets.decode_packet(buf)[0])
        if first is None and asm.queued():
            first = next(asm.chunks())
    asm.close()
    istart, chunk = first
    assert not np.shares_memory(chunk, asm._buf)
    # later pushes reuse the ring rows the first chunk came from; it is
    # unchanged
    np.testing.assert_array_equal(chunk, block[:, :64])


def test_assembler_push_returns_promptly_with_a_wedged_consumer():
    bufs, kw, _ = _scenario("wedged_consumer", None)
    asm = ChunkAssembler(**kw)
    t0 = time.monotonic()
    for b in bufs:
        asm.push(packets.decode_packet(b)[0])
    asm.close()
    assert time.monotonic() - t0 < 5.0
    assert asm.ledger.shed >= 256
    assert asm.ledger.unaccounted(queued_samples=2 * 256) == 0


# -- the feeds ------------------------------------------------------------------

def _write_survey(path, nchan=16, nsamples=3 * 1024, seed=23):
    from pulsarutils_tpu_torch.models.simulate import disperse_array

    rng = np.random.default_rng(seed)
    arr = np.abs(rng.normal(0, 0.5, (nchan, nsamples))) + 20.0
    arr[:, 1024 + 512] += 6.0
    arr = disperse_array(arr, 150.0, 1200., 200., TSAMP)
    write_simulated_filterbank(
        str(path), arr, {"bandwidth": 200., "fbottom": 1200.,
                         "nchans": nchan, "nsamples": nsamples,
                         "tsamp": TSAMP, "foff": 200. / nchan},
        descending=True)
    return str(path)


def _consume(asm, out):
    def run():
        for istart, chunk in asm.chunks():
            out[istart] = np.asarray(chunk)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread


def test_tcp_feed_tables_equal_disk_stream_and_jax(tmp_path):
    fname = _write_survey(tmp_path / "survey.fil")
    step, nsamples = 1024, 3 * 1024
    reader = FilterbankReader(fname)
    wire = reader.read_block(0, nsamples).astype(np.float32)
    disk = reader.read_block(0, nsamples,
                             band_ascending=True).astype(np.float32)
    encoded = packets.packetize_array(wire, samples_per_packet=128,
                                      band_descending=True)
    asm = ChunkAssembler(nchan=16, step=step, band_descending=True,
                         wait_poll_s=0.05)
    delivered = {}
    consumer = _consume(asm, delivered)
    src = TCPSource(asm, port=0, max_reconnects=0, idle_timeout_s=5.0)
    try:
        src.start()
        assert src.port != 0
        feed_tcp(src.host, src.port, encoded)
        assert src.wait(timeout_s=30), "reader failed to drain"
    finally:
        src.close()
        consumer.join(timeout=30)
    assert not consumer.is_alive()
    assert sorted(delivered) == [0, step, 2 * step]
    disk_chunks = [(s, np.ascontiguousarray(disk[:, s:s + step]))
                   for s in (0, step, 2 * step)]
    for s, chunk in disk_chunks:
        assert delivered[s].tobytes() == chunk.tobytes()
    assert asm.ledger.unaccounted() == 0 and not asm.ledger.journal

    dms = np.linspace(100., 200., 16)
    args = (100., 200., 1200., 200., TSAMP)
    res_feed, hits_feed = stream_search(sorted(delivered.items()), *args,
                                        trial_dms=dms, device="cpu")
    res_disk, hits_disk = stream_search(disk_chunks, *args, trial_dms=dms,
                                        device="cpu")
    res_jax, hits_jax = jstream.stream_search(disk_chunks, *args,
                                              trial_dms=dms)
    assert hits_disk and [h[0] for h in hits_feed] \
        == [h[0] for h in hits_disk] == [h[0] for h in hits_jax]
    for (s1, t1), (s2, t2), (s3, t3) in zip(res_feed, res_disk, res_jax):
        assert s1 == s2 == s3
        for col in t1.colnames:
            assert np.asarray(t1[col]).tobytes() \
                == np.asarray(t2[col]).tobytes(), (s1, col)
        for col in ("DM", "rebin", "peak"):
            np.testing.assert_array_equal(t1[col], np.asarray(t3[col]))
        for col in ("max", "std", "snr"):
            np.testing.assert_allclose(t1[col], np.asarray(t3[col]),
                                       rtol=RTOL, err_msg=col)


def test_tcp_corrupt_packet_surfaces_as_gap():
    block = make_block(4, 64, 11)
    encoded = packets.packetize_array(block, samples_per_packet=16)
    hurt = bytearray(encoded[1])
    hurt[packets.HEADER_SIZE] ^= 0xFF
    encoded[1] = bytes(hurt)
    asm = ChunkAssembler(nchan=4, step=64)
    src = TCPSource(asm, port=0, max_reconnects=0, idle_timeout_s=5.0)
    try:
        src.start()
        feed_tcp(src.host, src.port, encoded)
        assert src.wait(timeout_s=30)
    finally:
        src.close()
    (istart, got), = list(asm.chunks())
    expected = block.copy()
    expected[:, 16:32] = 0.0
    assert asm.invalid == 1 and asm.ledger.gap_filled == 16
    assert got.tobytes() == np.ascontiguousarray(expected).tobytes()
    assert asm.ledger.unaccounted() == 0


@pytest.mark.parametrize("connect", [True, False])
def test_tcp_idle_timeout_ends_session(connect):
    block = make_block(4, 32, 12)
    asm = ChunkAssembler(nchan=4, step=32, wait_poll_s=0.05)
    got = {}
    consumer = _consume(asm, got)
    src = TCPSource(asm, port=0, idle_timeout_s=0.3)
    try:
        src.start()
        if connect:
            feed_tcp(src.host, src.port,
                     packets.packetize_array(block, samples_per_packet=16))
        assert src.wait(timeout_s=30), "idle reader never exited"
        consumer.join(timeout=30)
        assert not consumer.is_alive(), "iterator never terminated"
    finally:
        src.close()
    assert sorted(got) == ([0] if connect else [])
    assert asm.ledger.delivered == (32 if connect else 0)


def test_udp_feed_roundtrip():
    block = make_block(4, 64, 13)
    asm = ChunkAssembler(nchan=4, step=64)
    src = UDPSource(asm, port=0, idle_timeout_s=0.3)
    try:
        src.start()
        feed_udp(src.host, src.port,
                 packets.packetize_array(block, samples_per_packet=16),
                 pace_s=0.002)
        assert src.wait(timeout_s=30)
    finally:
        src.close()
    got = dict(asm.chunks())
    led = asm.ledger
    assert led.unaccounted() == 0
    assert led.arrived + led.gap_filled == led.observed
    # loopback may drop a datagram under load: bytes only without loss
    if led.gap_filled == 0:
        assert got[0].tobytes() == np.ascontiguousarray(block).tobytes()
    else:
        assert asm.summary()["ledger"]["gap_filled"] == led.gap_filled


def test_tcp_reconnect_is_counted():
    block = make_block(4, 128, 14)
    encoded = packets.packetize_array(block, samples_per_packet=32)
    asm = ChunkAssembler(nchan=4, step=64)
    src = TCPSource(asm, port=0, idle_timeout_s=0.4, backoff_s=0.01)
    try:
        src.start()
        feed_tcp(src.host, src.port, encoded[:2])
        feed_tcp(src.host, src.port, encoded[2:])
        assert src.wait(timeout_s=30)
    finally:
        src.close()
    got = dict(asm.chunks())
    assert asm.reconnects == 1 and asm.summary()["reconnects"] == 1
    for s in (0, 64):
        assert got[s].tobytes() == \
            np.ascontiguousarray(block[:, s:s + 64]).tobytes()
    assert asm.ledger.unaccounted() == 0


FAULT_KINDS = ["drop", "reorder", "duplicate", "corrupt", "disconnect",
               "burst"]


def _faulted_feed(kind, inject_mod, source_mod, asm_cls, health_cls,
                  bufs, spec_seq):
    """Feed ``bufs`` over TCP under one ``ingest`` fault on packet
    ``spec_seq``; returns the delivered chunks and the session record."""
    plan = inject_mod.FaultPlan([inject_mod.FaultSpec(
        site="ingest", kind=kind, chunks=(spec_seq,), times=1)])
    health = health_cls(recover_after=8)
    asm = asm_cls(nchan=4, step=64, reorder_window=32, health=health)
    src = source_mod.TCPSource(asm, port=0, idle_timeout_s=0.5,
                               backoff_s=0.01)
    try:
        src.start()
        with plan.armed():
            sent = source_mod.feed_tcp(src.host, src.port, bufs,
                                       pace_s=0.001 if kind == "burst"
                                       else 0.0)
        assert src.wait(timeout_s=30)
    finally:
        src.close()
    chunks = {s: np.asarray(c).tobytes() for s, c in asm.chunks()}
    return {"sent": sent, "fired": plan.fired("ingest"), "chunks": chunks,
            "summary": asm.summary(), "journal": asm.ledger.journal,
            "verdict": health.verdict, "reasons": health.reasons()}


@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_ingest_fault_kind_equals_jax_feeder(kind):
    block = make_block(4, 192, 31)
    bufs = packets.packetize_array(block, samples_per_packet=16)
    ours = _faulted_feed(kind, tinject, tsource, ChunkAssembler,
                         HealthEngine, bufs, 5)
    theirs = _faulted_feed(kind, jinject, jsource, JChunkAssembler,
                           JHealthEngine, bufs, 5)
    assert ours == theirs
    assert ours["fired"] == 1 and ours["summary"]["ledger"]["unaccounted"] \
        == 0
    led = ours["summary"]["ledger"]
    if kind in ("drop", "corrupt"):
        # one packet's 16 samples of chunk 0 zero-filled and accounted
        assert led["gap_filled"] == 16 and "feed_gap" in ours["reasons"]
        expected = block.copy()
        expected[:, 80:96] = 0.0
        assert ours["chunks"][64] == \
            np.ascontiguousarray(expected[:, 64:128]).tobytes()
    else:
        assert led["gap_filled"] == 0
        for s in (0, 64, 128):
            assert ours["chunks"][s] == \
                np.ascontiguousarray(block[:, s:s + 64]).tobytes()
    if kind == "disconnect":
        assert ours["summary"]["reconnects"] == 1
        assert "feed_disconnect" in ours["reasons"]
    if kind == "duplicate":
        assert ours["summary"]["duplicate_packets"] == 1
    if kind == "reorder":
        assert ours["summary"]["reordered_packets"] >= 1
    if kind == "corrupt":
        assert ours["summary"]["invalid_packets"] == 1


def test_ingest_action_unarmed_is_none():
    assert tinject.ingest_action("ingest", seq=0) is None
    plan = tinject.FaultPlan([tinject.FaultSpec(site="ingest",
                                                kind="drop", times=2)])
    with plan.armed():
        assert tinject.ingest_action("ingest", seq=3)[0] == "drop"
        assert tinject.ingest_action("read", seq=3) is None
        assert tinject.ingest_action("ingest", seq=4)[0] == "drop"
        assert tinject.ingest_action("ingest", seq=5) is None
    assert plan.fired("ingest") == 2


# -- PUingest -----------------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
def test_feed_out_bytes_equal_jax_cli(tmp_path, packed):
    if packed:
        from pulsarutils_tpu_torch.io.sigproc import write_filterbank

        codes = np.random.default_rng(5).integers(0, 4, (16, 2000))
        fname = str(tmp_path / "codes.fil")
        write_filterbank(fname, codes.astype(np.float64), TSAMP, 1400.0,
                         -200.0 / 16, nbits=2)
    else:
        fname = _write_survey(tmp_path / "survey.fil")
    args = ["feed", fname, "--samples-per-packet", "100",
            "--max-samples", "1500"] + (["--packed"] if packed else [])
    assert ingest_main.main(args + ["--out", str(tmp_path / "t.bin")]) == 0
    assert jingest_main.main(args + ["--out", str(tmp_path / "j.bin")]) == 0
    ours = (tmp_path / "t.bin").read_bytes()
    assert ours and ours == (tmp_path / "j.bin").read_bytes()
    first, _ = packets.decode_packet(ours)
    assert first.nbits == (2 if packed else 0) and first.band_descending


def test_listen_cli_over_tcp_balances_the_ledger(tmp_path):
    fname = _write_survey(tmp_path / "survey.fil")
    summary = tmp_path / "summary.json"
    # a listener on an ephemeral port in a thread; the feeder connects to
    # the port the assembler's source bound
    bound = {}
    real = tsource.TCPSource.start

    def start(self):
        out = real(self)
        bound["port"] = self.port
        return out

    result = {}

    def listen():
        result["rc"] = ingest_main.main([
            "listen", "--like", fname, "--port", "0", "--step", "1024",
            "--dmmin", "100", "--dmmax", "200", "--idle-timeout", "1.0",
            "--device", "cpu", "--summary-out", str(summary)])

    tsource.TCPSource.start = start
    try:
        thread = threading.Thread(target=listen, daemon=True)
        thread.start()
        deadline = time.monotonic() + 30
        while "port" not in bound and time.monotonic() < deadline:
            time.sleep(0.02)
        assert "port" in bound
        assert ingest_main.main(["feed", fname, "--port",
                                 str(bound["port"])]) == 0
        thread.join(timeout=120)
    finally:
        tsource.TCPSource.start = real
    assert not thread.is_alive() and result["rc"] == 0
    doc = json.loads(summary.read_text())
    assert doc["ledger"]["unaccounted"] == 0
    assert doc["ledger"]["delivered"] == 3 * 1024
    assert doc["invalid_packets"] == 0


def test_listen_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ingest_main.main(["listen", "--nchan", "4", "--fbottom", "1200",
                          "--bandwidth", "200", "--tsamp", "0.0005",
                          "--port", "0", "--idle-timeout", "0.1"])
    listen = ingest_main.build_parser()._subparsers._group_actions[0] \
        .choices["listen"]
    flags = {f for a in listen._actions for f in a.option_strings}
    assert "--device" in flags and "--backend" not in flags


def test_shed_overrun_with_a_slow_consumer(tmp_path):
    block = make_block(4, 8 * 64, 41)
    manifest = QuarantineManifest(str(tmp_path), "ingest")
    asm = ChunkAssembler(nchan=4, step=64, shed=1, manifest=manifest,
                         wait_poll_s=0.05)
    got = []

    def slow():
        for istart, chunk in asm.chunks():
            got.append(istart)
            time.sleep(0.05)

    consumer = threading.Thread(target=slow, daemon=True)
    consumer.start()
    src = TCPSource(asm, port=0, idle_timeout_s=0.5)
    try:
        src.start()
        feed_tcp(src.host, src.port,
                 packets.packetize_array(block, samples_per_packet=64))
        assert src.wait(timeout_s=30)
    finally:
        src.close()
        consumer.join(timeout=30)
    led = asm.ledger
    assert led.unaccounted() == 0 and led.shed > 0
    assert led.delivered + led.shed == 8 * 64
    shed = [r["chunk"] for r in led.journal
            if r["reason"] == reasons.SHED_OVERRUN]
    assert shed and [r["chunk"] for r in manifest.records()] == shed
    assert sorted(set(got) | set(shed)) == list(range(0, 8 * 64, 64))
