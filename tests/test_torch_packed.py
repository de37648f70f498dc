"""The port's packed low-bit chunk loop and packed searches on the CPU,
held against the JAX package.

``search_by_chunks(device="cpu")`` on 1/2/4-bit files in both band orders
against the JAX driver (``backend="jax"``, ``kernel="pallas"`` in
interpret mode, which uploads the packed bytes and unpacks them in its
clean program): hits, tables, the ledger's ``done`` and ``quarantined``
entries, the quarantine manifest's records and the deltas of the
``putpu_lowbit_*``, upload and canary counters, with a railed chunk and
the packed canary at rate 1.0 among the cases; a multi-IF low-bit file
(decoded on the host and gated in the code domain) the same way.  Then
``dedispersion_search`` on :class:`PackedFrames` with every kernel
against the float run of the same codes, and the rule that a failed
unpack fails the run.
"""
import glob
import json
import threading

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from pulsarutils_tpu.io.lowbit import PackedFrames as JaxPackedFrames
from pulsarutils_tpu.obs.canary import CanaryController as JaxCanary
from pulsarutils_tpu.obs.metrics import REGISTRY as JAX_REGISTRY
from pulsarutils_tpu.ops.search import \
    dedispersion_search as jax_dedispersion_search
from pulsarutils_tpu.pipeline.search_pipeline import \
    search_by_chunks as jax_search_by_chunks

from pulsarutils_tpu_torch.io import lowbit
from pulsarutils_tpu_torch.io.lowbit import PackedFrames
from pulsarutils_tpu_torch.io.sigproc import (FilterbankReader,
                                              FilterbankWriter)
from pulsarutils_tpu_torch.models.simulate import disperse_array
from pulsarutils_tpu_torch.obs.canary import CanaryController
from pulsarutils_tpu_torch.obs.metrics import REGISTRY
from pulsarutils_tpu_torch.ops.search import dedispersion_search
from pulsarutils_tpu_torch.pipeline.search_pipeline import search_by_chunks

torch.set_num_threads(1)

TSAMP = 0.0005
GEOM = (1200.0, 200.0, TSAMP)
NCHAN, NSAMPLES, PULSE_T = 64, 24576, 13000
SEARCH = dict(dmmin=100.0, dmmax=200.0, chunk_length=4096 * TSAMP,
              snr_threshold=6.5)
JAX_KW = dict(backend="jax", kernel="pallas", make_plots=False,
              progress=False)
COUNTERS = ("putpu_lowbit_packed_chunks_total",
            "putpu_lowbit_bytes_saved_total",
            "putpu_bytes_uploaded_total",
            "putpu_chunks_quarantined_total",
            "putpu_canary_packed_injections_total",
            "putpu_canary_injected_total",
            "putpu_canary_recovered_total",
            "putpu_canary_tagged_hits_total",
            "putpu_canary_discarded_total")


@pytest.fixture(autouse=True)
def clean_state():
    """Both registries start and end empty; no test leaves a thread."""
    REGISTRY.reset()
    JAX_REGISTRY.reset()
    threads = set(threading.enumerate())
    yield
    REGISTRY.reset()
    JAX_REGISTRY.reset()
    left = [t for t in threading.enumerate()
            if t not in threads and t.is_alive()]
    for t in left:
        t.join(timeout=5.0)
    assert not [t for t in left if t.is_alive()], left


def make_codes(nbits, seed=0, nchan=NCHAN, nsamples=NSAMPLES, amp=2.0,
               railed=None):
    """Gaussian noise with a DM-150 pulse at ``PULSE_T``, digitised onto
    ``nbits``-bit codes (thresholds every 4 / 2^nbits sigma about the
    mean); ``railed`` samples ``(lo, hi)`` pinned at the top code."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (nchan, nsamples))
    pulse = np.zeros((nchan, nsamples))
    pulse[:, PULSE_T:PULSE_T + 3] = amp
    x += disperse_array(pulse, 150.0, *GEOM)
    top = (1 << nbits) - 1
    codes = np.clip(np.floor((x + 2.0) * (1 << nbits) / 4.0), 0, top)
    if railed is not None:
        codes[:, railed[0]:railed[1]] = top
    return codes.astype(np.float32)


def write_file(path, codes, nbits, descending=True, nifs=1):
    nchan = codes.shape[-2]
    header = {"nchans": nchan, "nbits": nbits, "nifs": nifs, "tsamp": TSAMP,
              "fch1": (GEOM[0] + GEOM[1]) if descending else GEOM[0],
              "foff": (-GEOM[1] / nchan) if descending else GEOM[1] / nchan,
              "tstart": 60000.0}
    with FilterbankWriter(path, header) as w:
        w.write_block(codes[..., ::-1, :] if descending else codes)
    return str(path)


def _total(registry, name):
    return sum(m["value"] for m in registry.snapshot() if m["name"] == name)


def _manifest(directory):
    paths = glob.glob(str(directory / "quarantine_*.jsonl"))
    if not paths:
        return []
    return [json.loads(line) for line in open(paths[0])]


def _run_both(path, tmp_path, canary=None, **extra):
    out = {}
    for label, search, registry, kw, cls in (
            ("ours", search_by_chunks, REGISTRY,
             dict(device="cpu", make_plots=False), CanaryController),
            ("theirs", jax_search_by_chunks, JAX_REGISTRY, JAX_KW,
             JaxCanary)):
        before = {n: _total(registry, n) for n in COUNTERS}
        c = cls(**canary) if canary is not None else None
        hits, store = search(path, output_dir=str(tmp_path / label),
                             canary=c, **SEARCH, **kw, **extra)
        out[label] = dict(hits=hits, store=store, canary=c,
                          manifest=_manifest(tmp_path / label),
                          counters={n: _total(registry, n) - before[n]
                                    for n in COUNTERS})
    return out["ours"], out["theirs"]


def _assert_same(ours, theirs):
    hits, jhits = ours["hits"], theirs["hits"]
    assert [h[:2] for h in hits] == [h[:2] for h in jhits]
    for (_, _, info, table), (_, _, rinfo, rtable) in zip(hits, jhits):
        assert info.dm == rinfo.dm and info.width == rinfo.width
        best, rbest = table.best_row(), rtable.best_row()
        for col in ("DM", "rebin", "peak"):
            assert best[col] == rbest[col]
        np.testing.assert_allclose(info.snr, rinfo.snr, rtol=1e-5)
        np.testing.assert_array_equal(table["DM"], rtable["DM"])
        np.testing.assert_array_equal(table["rebin"], rtable["rebin"])
        np.testing.assert_allclose(table["snr"], rtable["snr"], rtol=1e-5)
    assert ours["store"].done_chunks == theirs["store"].done_chunks
    assert ours["store"].quarantined_chunks == \
        theirs["store"].quarantined_chunks
    assert ours["manifest"] == theirs["manifest"]
    assert ours["counters"] == theirs["counters"]


@pytest.mark.parametrize("nbits,descending", [
    (1, True), (1, False), (2, True), (2, False), (4, True), (4, False)])
def test_packed_loop_equals_jax(tmp_path, nbits, descending):
    path = write_file(tmp_path / "f.fil", make_codes(nbits, seed=nbits),
                      nbits, descending)
    ours, theirs = _run_both(path, tmp_path)
    _assert_same(ours, theirs)
    nchunks = len(ours["store"].done_chunks)
    assert ours["hits"], "the pulse was not found"
    c = ours["counters"]
    assert c["putpu_lowbit_packed_chunks_total"] == nchunks
    # every chunk's bytes cross packed: nbits / 32 of the float block's
    assert c["putpu_lowbit_bytes_saved_total"] == \
        c["putpu_bytes_uploaded_total"] * (32 // nbits - 1)


@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_railed_chunk_quarantined_as_jax(tmp_path, nbits):
    """A chunk pinned at the top code is quarantined in the code domain
    with the JAX package's reason and stats; the chunks after it are
    searched as in the JAX driver."""
    codes = make_codes(nbits, seed=20 + nbits, railed=(0, 8192))
    path = write_file(tmp_path / "railed.fil", codes, nbits)
    ours, theirs = _run_both(path, tmp_path)
    _assert_same(ours, theirs)
    assert "0" in ours["store"].quarantined_chunks
    assert ours["manifest"][0]["reason"].startswith("integrity:rail_frac")
    assert ours["counters"]["putpu_chunks_quarantined_total"] >= 1


@pytest.mark.parametrize("nbits", [1, 2])
def test_packed_canary_equals_jax(tmp_path, nbits):
    """The packed canary at rate 1.0: the same injected bytes, hence the
    same recall, tagged hits and counters as the JAX driver; the science
    hits those of the canary-off run."""
    path = write_file(tmp_path / "c.fil", make_codes(nbits, seed=30), nbits)
    off, _ = search_by_chunks(path, output_dir=str(tmp_path / "off"),
                              device="cpu", make_plots=False, **SEARCH)
    ours, theirs = _run_both(path, tmp_path,
                             canary=dict(rate=1.0, dm=120.0, snr=15.0,
                                         seed=4))
    _assert_same(ours, theirs)
    s, js = ours["canary"].summary(), theirs["canary"].summary()
    for key in ("injected", "recovered", "discarded", "recall"):
        assert s[key] == js[key]
    assert s["injected"] == len(ours["store"].done_chunks)
    assert ours["counters"]["putpu_canary_packed_injections_total"] == \
        s["injected"]
    assert [h[:2] for h in ours["hits"]] == [h[:2] for h in off]


def test_multi_if_lowbit_equals_jax(tmp_path):
    """Two IFs of 2-bit codes: decoded on the host, the IFs summed, gated
    in the code domain, as in the JAX driver; nothing counted as packed."""
    planes = np.stack([make_codes(2, seed=40), make_codes(2, seed=41,
                                                          railed=(0, 8192))])
    path = write_file(tmp_path / "mif.fil", planes, 2, nifs=2)
    ours, theirs = _run_both(path, tmp_path)
    # the decoded block crosses as float32; the JAX driver counts its
    # float64 host block's bytes before the float32 transfer
    up = ours["counters"].pop("putpu_bytes_uploaded_total")
    assert 2 * up == theirs["counters"].pop("putpu_bytes_uploaded_total")
    _assert_same(ours, theirs)
    assert ours["hits"]
    assert ours["counters"]["putpu_lowbit_packed_chunks_total"] == 0


def test_packed_twin_equal_hits(tmp_path):
    """A 2-bit file and its 8-bit twin holding the same codes: the same
    hits through the direct sweep, the hybrid and the FDD; the packed run
    uploads a quarter of the twin's bytes."""
    codes = make_codes(2, seed=50)
    packed = write_file(tmp_path / "p.fil", codes, 2)
    twin = write_file(tmp_path / "t.fil", codes, 8)
    for kernel in ("auto", "hybrid", "fourier"):
        runs = []
        for path in (packed, twin):
            before = _total(REGISTRY, "putpu_bytes_uploaded_total")
            hits, _ = search_by_chunks(
                path, output_dir=str(tmp_path / f"{kernel}{len(runs)}"),
                device="cpu", make_plots=False, kernel=kernel, **SEARCH)
            runs.append((hits, _total(REGISTRY, "putpu_bytes_uploaded_total")
                         - before))
        (hits, up), (thits, tup) = runs
        assert hits and [h[:2] for h in hits] == [h[:2] for h in thits]
        for (_, _, info, table), (_, _, tinfo, ttable) in zip(hits, thits):
            assert info.dm == tinfo.dm and info.snr == tinfo.snr
            np.testing.assert_array_equal(table["snr"], ttable["snr"])
        assert 4 * up == tup


def test_failed_unpack_fails_the_run(tmp_path, monkeypatch):
    """No fallback to the host decode: an unpack that raises makes the
    run raise, and no chunk is marked done."""
    path = write_file(tmp_path / "f.fil", make_codes(2, seed=60), 2)

    def boom(*args, **kwargs):
        raise RuntimeError("injected unpack failure")

    monkeypatch.setattr(lowbit, "device_unpack_block", boom)
    with pytest.raises(RuntimeError, match="injected unpack failure"):
        search_by_chunks(path, output_dir=str(tmp_path / "out"),
                         device="cpu", make_plots=False, **SEARCH)
    ledger = glob.glob(str(tmp_path / "out" / "progress_*.json"))
    done = json.load(open(ledger[0]))["done"] if ledger else []
    assert done == []


# -- dedispersion_search on packed frames -------------------------------------

def _packed(codes, nbits, descending=True):
    file_order = codes[::-1] if descending else codes
    frames = np.stack([lowbit.pack_numpy(file_order[:, t], nbits)
                       for t in range(codes.shape[1])])
    return (PackedFrames(frames, nbits, codes.shape[0], descending),
            JaxPackedFrames(frames, nbits, codes.shape[0], descending))


@pytest.mark.parametrize("nbits", [1, 2, 4])
@pytest.mark.parametrize("kernel", ["auto", "pallas", "gather", "roll",
                                    "fdmt", "hybrid", "fourier"])
def test_packed_search_equals_float(nbits, kernel):
    codes = make_codes(nbits, seed=70, nchan=32, nsamples=4096, amp=3.0)
    codes[:, :] = np.roll(codes, 4000 - PULSE_T % 4096, axis=1)
    packed, _ = _packed(codes, nbits)
    args = (100.0, 200.0, *GEOM)
    table = dedispersion_search(packed, *args, kernel=kernel, device="cpu")
    ref = dedispersion_search(codes, *args, kernel=kernel, device="cpu")
    assert table.colnames == ref.colnames
    for col in table.colnames:
        np.testing.assert_array_equal(table[col], ref[col], err_msg=col)
    if kernel in ("gather", "roll"):
        # the captured plane is the float plane; the uncaptured search
        # summed int16/int32 codes and scored the same values
        assert lowbit.accum_dtype(nbits, 32) in ("int16", "int32")
        t2, plane = dedispersion_search(packed, *args, kernel=kernel,
                                        capture_plane=True, device="cpu")
        _, rplane = dedispersion_search(codes, *args, kernel=kernel,
                                        capture_plane=True, device="cpu")
        assert plane.dtype == torch.float32
        np.testing.assert_array_equal(plane.numpy(), rplane.numpy())


@pytest.mark.parametrize("kernel", ["pallas", "roll", "gather"])
def test_packed_search_equals_jax(kernel, monkeypatch):
    monkeypatch.setenv("PUTPU_AUTOTUNE", "off")
    codes = make_codes(2, seed=80, nchan=32, nsamples=2048, amp=3.0)
    packed, jpacked = _packed(codes, 2, descending=False)
    args = (100.0, 160.0, *GEOM)
    table = dedispersion_search(packed, *args, kernel=kernel, device="cpu")
    ref = jax_dedispersion_search(jpacked, *args, backend="jax",
                                  kernel=kernel)
    for col in ("DM", "rebin", "peak"):
        np.testing.assert_array_equal(table[col], ref[col], err_msg=col)
    np.testing.assert_allclose(table["snr"], ref["snr"], rtol=1e-5)


def test_packed_dtype_rejected_as_jax():
    codes = make_codes(2, seed=90, nchan=16, nsamples=1024)
    packed, jpacked = _packed(codes, 2)
    with pytest.raises(ValueError, match="pass dtype=None"):
        dedispersion_search(packed, 100.0, 160.0, *GEOM, kernel="gather",
                            dtype=torch.int16, device="cpu")
    with pytest.raises(ValueError, match="pass dtype=None"):
        jax_dedispersion_search(jpacked, 100.0, 160.0, *GEOM,
                                backend="jax", kernel="gather",
                                dtype=jnp.int16)
    assert dedispersion_search(packed, 100.0, 160.0, *GEOM, kernel="roll",
                               dtype=torch.float32, device="cpu").nrows


def test_packed_reader_rejects_multi_if(tmp_path):
    planes = np.stack([make_codes(2, seed=1, nsamples=512)] * 2)
    path = write_file(tmp_path / "m.fil", planes, 2, nifs=2)
    with pytest.raises(ValueError, match="single-IF"):
        PackedFrames.read(FilterbankReader(path), 0, 64)


def test_periodicity_search_on_2bit_file_equals_jax(tmp_path):
    """The periodicity job on a 2-bit pulsar file (packed chunks into the
    accumulator) finds the JAX driver's best candidate."""
    from pulsarutils_tpu.models.simulate import simulate_accel_pulsar_data
    from pulsarutils_tpu.periodicity.driver import \
        periodicity_search as jax_periodicity_search

    from pulsarutils_tpu_torch.periodicity.driver import periodicity_search

    arr, _ = simulate_accel_pulsar_data(
        freq=492 / (16384 * TSAMP), dm=150.0, accel=0.0, tsamp=TSAMP,
        nsamples=16384, nchan=32, rng=13)
    edges = np.percentile(arr, [25, 50, 75])
    codes = sum((arr >= e).astype(np.float32) for e in edges)
    path = write_file(tmp_path / "psr2.fil", codes, 2)
    job = dict(dmmin=130.0, dmmax=170.0, accel_max=0.0, n_accel=1,
               sigma_threshold=8.0, chunk_length=4096 * TSAMP,
               snr_threshold=8.0)
    before = _total(REGISTRY, "putpu_lowbit_packed_chunks_total")
    res = periodicity_search(path, output_dir=str(tmp_path / "t"),
                             device="cpu", **job)
    ref = jax_periodicity_search(path, output_dir=str(tmp_path / "j"),
                                 progress=False, **job)
    assert res["complete"] and res["candidates"]
    assert _total(REGISTRY, "putpu_lowbit_packed_chunks_total") > before
    top = [(c["dm"], c["freq_bin"], c["nharm"]) for c in res["candidates"]]
    jtop = [(c["dm"], c["freq_bin"], c["nharm"]) for c in ref["candidates"]]
    assert top[0] == jtop[0]
    assert res["candidates"][0]["freq_bin"] == 492
