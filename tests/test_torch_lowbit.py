"""The port's 1/2/4-bit and multi-IF file surface on the CPU, held against
the JAX package: the decode triangle (the port's device unpack and host
unpack, the JAX package's ``device_unpack_block`` and ``unpack_numpy``)
bit for bit across widths, band orders, channel counts and a truncated
final frame; the writer's bytes; the reader's ``if_mode``; the
code-domain gates and the packed canary's bytes; the native host decode
(``native/unpack.cpp``) built here, against the JAX package's, and the
host reads, writes and cleans that go through it."""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from pulsarutils_tpu.faults.policy import IntegrityPolicy as JaxPolicy
from pulsarutils_tpu.faults.policy import \
    gate_chunk_lowbit as jax_gate_chunk_lowbit
from pulsarutils_tpu.faults.policy import \
    gate_chunk_packed as jax_gate_chunk_packed
from pulsarutils_tpu.io import lowbit as jax_lowbit
from pulsarutils_tpu.io.sigproc import FilterbankReader as JaxReader
from pulsarutils_tpu.io.sigproc import FilterbankWriter as JaxWriter
from pulsarutils_tpu.obs.canary import CanaryController as JaxCanary
from pulsarutils_tpu.obs.metrics import REGISTRY as JAX_REGISTRY

from pulsarutils_tpu_torch.faults.policy import (IntegrityPolicy,
                                                 gate_chunk_lowbit,
                                                 gate_chunk_packed,
                                                 lowbit_code_stats)
from pulsarutils_tpu_torch.io import lowbit
from pulsarutils_tpu_torch.io.sigproc import (FilterbankReader,
                                              FilterbankWriter,
                                              write_filterbank)
from pulsarutils_tpu_torch.obs.canary import CanaryController
from pulsarutils_tpu_torch.obs.metrics import REGISTRY

torch.set_num_threads(1)

PER = {1: 8, 2: 4, 4: 2}
GEOM = (1200.0, 200.0, 0.0005)


@pytest.fixture(autouse=True)
def clean_state():
    yield
    REGISTRY.reset()


def _header(nchan, nbits, descending, nifs=1):
    return {"nchans": nchan, "nbits": nbits, "nifs": nifs, "tsamp": GEOM[2],
            "fch1": (GEOM[0] + GEOM[1]) if descending else GEOM[0],
            "foff": (-GEOM[1] / nchan) if descending else GEOM[1] / nchan,
            "tstart": 60000.0}


def _codes(nchan, nsamps, nbits, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << nbits, (nchan, nsamps)).astype(np.float32)


@pytest.mark.parametrize("nbits", [1, 2, 4])
@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("nchan", [24, 40, 64])
def test_decode_triangle_bit_exact(tmp_path, nbits, descending, nchan):
    """Four decodes of one file's bytes agree bit for bit, and with the
    codes written."""
    nsamps = 37
    data = _codes(nchan, nsamps, nbits, seed=nbits * 100 + nchan)
    path = str(tmp_path / "tri.fil")
    with FilterbankWriter(path, _header(nchan, nbits, descending)) as w:
        w.write_block(data[::-1] if descending else data)
    ours, ref = FilterbankReader(path), JaxReader(path)
    raw = np.array(ours.read_block_packed(0, nsamps))
    np.testing.assert_array_equal(raw, ref.read_block_packed(0, nsamps))
    dev = lowbit.device_unpack_block(torch.from_numpy(raw), nbits, nchan,
                                     band_descending=descending)
    assert dev.dtype == torch.float32 and dev.is_contiguous()
    host = ours.read_block(0, nsamps, band_ascending=True)
    jdev = np.asarray(jax_lowbit.device_unpack_block(
        jnp.asarray(raw), nbits, nchan, band_descending=descending, xp=jnp))
    oracle = jax_lowbit.unpack_numpy(raw, nbits).reshape(nsamps, -1)[
        :, :nchan].T
    if descending:
        oracle = oracle[::-1]
    np.testing.assert_array_equal(dev.numpy(), jdev)
    np.testing.assert_array_equal(dev.numpy(), oracle)
    np.testing.assert_array_equal(host, ref.read_block(
        0, nsamps, band_ascending=True))
    np.testing.assert_array_equal(host.astype(np.float32), oracle)
    np.testing.assert_array_equal(oracle, data)
    np.testing.assert_array_equal(lowbit.unpack_numpy(raw, nbits),
                                  jax_lowbit.unpack_numpy(raw, nbits))
    # the chunk loop's frame API: frames in the staging dtype, the block
    # on the frames' device
    assert ours.frame_dtype == np.uint8
    assert ours.frame_width == ours.bytes_per_frame == nchan * nbits // 8
    view = np.empty((nsamps, ours.frame_width), dtype=ours.frame_dtype)
    assert ours.read_frames_into(0, nsamps, view) == nsamps
    np.testing.assert_array_equal(
        ours.block_from_frames(torch.from_numpy(view)).numpy(), oracle)
    np.testing.assert_array_equal(ours.read_block_tensor(3, 20, "cpu"),
                                  oracle[:, 3:23])
    np.testing.assert_array_equal(ours.host_samples(view[5:9]),
                                  oracle[:, 5:9].T)
    # PackedFrames: both decodes and the sizes
    pf = lowbit.PackedFrames.read(ours, 0, nsamps)
    assert pf.shape == (nchan, nsamps) and pf.nbytes == raw.nbytes
    assert pf.float_nbytes == nchan * nsamps * 4
    np.testing.assert_array_equal(pf.to_host(), oracle)
    np.testing.assert_array_equal(pf.to_device("cpu").numpy(), oracle)
    jpf = jax_lowbit.PackedFrames.read(ref, 0, nsamps)
    assert pf.meta("int16") == jpf.meta("int16")


@pytest.mark.parametrize("nbits", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_device_unpack_integer_dtype(nbits, dtype):
    data = _codes(16, 50, nbits, seed=5)
    frames = np.stack([jax_lowbit.pack_numpy(data[:, t], nbits)
                       for t in range(50)])
    got = lowbit.device_unpack_block(torch.from_numpy(frames), nbits, 16,
                                     band_descending=True, dtype=dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), data[::-1])


def test_truncated_final_frame(tmp_path):
    nbits, nchan, nsamps = 2, 16, 50
    data = _codes(nchan, nsamps, nbits, seed=3)
    path = str(tmp_path / "trunc.fil")
    with FilterbankWriter(path, _header(nchan, nbits, True)) as w:
        w.write_block(data[::-1])
    buf = open(path, "rb").read()
    with open(path, "wb") as f:  # chop one whole and one partial frame
        f.write(buf[:-(nchan * nbits // 8 + 3)])
    ours, ref = FilterbankReader(path), JaxReader(path)
    assert ours.nsamples == ref.nsamples == nsamps - 2
    raw = np.array(ours.read_block_packed(0, nsamps))  # over-asked
    assert raw.shape[0] == nsamps - 2
    dev = lowbit.device_unpack_block(torch.from_numpy(raw), nbits, nchan,
                                     band_descending=True)
    np.testing.assert_array_equal(dev.numpy(), data[:, :nsamps - 2])
    np.testing.assert_array_equal(
        ours.read_block(0, nsamps, band_ascending=True),
        ref.read_block(0, nsamps, band_ascending=True))


@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_pack_unpack_equal_jax(nbits):
    rng = np.random.default_rng(nbits)
    # codes, halves (rint to even), and values past both rails
    values = np.concatenate([
        rng.integers(0, 1 << nbits, 4000).astype(np.float32),
        np.array([0.5, 1.5, 2.5, 3.5, -0.5, -3.0, 99.0, 1.4], np.float32)])
    packed = lowbit.pack(values, nbits)
    np.testing.assert_array_equal(packed, jax_lowbit.pack(values, nbits))
    np.testing.assert_array_equal(packed,
                                  jax_lowbit.pack_numpy(values, nbits))
    np.testing.assert_array_equal(lowbit.unpack(packed, nbits),
                                  jax_lowbit.unpack(packed, nbits))
    with pytest.raises(ValueError):
        lowbit.pack(values[:PER[nbits] + 1], nbits)
    with pytest.raises(ValueError):
        lowbit.unpack(packed, 3)


@pytest.mark.parametrize("nbits", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("nifs", [1, 2])
def test_writer_bytes_equal_jax(tmp_path, nbits, nifs):
    """The port's writer gives the JAX writer's bytes: rounding and
    clipping, packing, and the multi-IF interleave."""
    rng = np.random.default_rng(nbits + nifs)
    top = {1: 1, 2: 3, 4: 15, 8: 255, 16: 65535, 32: 1000}[nbits]
    shape = (nifs, 32, 77) if nifs > 1 else (32, 77)
    data = rng.uniform(-1.0, top + 1.5, shape)
    data.flat[:4] = [0.5, 1.5, 2.5, -0.5]
    header = _header(32, nbits, True, nifs=nifs)
    paths = [str(tmp_path / f"{who}.fil") for who in ("ours", "theirs")]
    for cls, path in zip((FilterbankWriter, JaxWriter), paths):
        with cls(path, header) as w:
            w.write_block(data)
            w.write_block(data[..., :5])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    # the frame path: float64 frames encoded as tensors, then written
    frames = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(data, -1, 0).reshape(data.shape[-1], -1)))
    path = str(tmp_path / "frames.fil")
    with FilterbankWriter(path, header) as w:
        w.write_frames(w.encode_frames(frames))
        w.write_frames(w.encode_frames(frames[:5]))
    assert open(path, "rb").read() == open(paths[1], "rb").read()
    if nifs == 1:
        write_filterbank(paths[0], data, tsamp=1e-3, fch1=1400.0, foff=-1.0,
                         nbits=nbits)
        assert FilterbankReader(paths[0]).header["nbits"] == nbits


@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_pack_codes_inverts_unpack_codes(nbits):
    rng = np.random.default_rng(nbits)
    codes = torch.from_numpy(rng.integers(0, 1 << nbits, (9, 8 * PER[nbits]),
                                          dtype=np.uint8))
    packed = lowbit.pack_codes(codes, nbits)
    assert packed.dtype == torch.uint8 and packed.shape == (9, 8)
    np.testing.assert_array_equal(
        packed.numpy(), jax_lowbit.pack_numpy(codes.numpy(), nbits)
        .reshape(9, 8))
    np.testing.assert_array_equal(lowbit.unpack_codes(packed, nbits).numpy(),
                                  codes.numpy())


@pytest.mark.parametrize("signed", [False, True])
def test_signed_8bit_frames_encode_as_jax(tmp_path, signed):
    header = {**_header(8, 8, True), "signed": int(signed)}
    data = np.linspace(-300.0, 300.0, 8 * 40).reshape(8, 40)
    paths = [str(tmp_path / f"{who}.fil") for who in ("ours", "theirs")]
    with FilterbankWriter(paths[0], header) as w:
        w.write_frames(w.encode_frames(torch.from_numpy(data.T.copy())))
    with JaxWriter(paths[1], header) as w:
        w.write_block(data)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    ours = FilterbankReader(paths[0])
    view = np.empty((40, 8), dtype=ours.frame_dtype)
    ours.read_frames_into(0, 40, view)
    np.testing.assert_array_equal(
        ours.frame_values(torch.from_numpy(view)).numpy(),
        JaxReader(paths[1]).read_block(0, 40).T)


@pytest.mark.parametrize("nbits", [2, 8])
def test_multi_if_reads_equal_jax(tmp_path, nbits):
    rng = np.random.default_rng(7)
    planes = rng.integers(0, 1 << nbits, (3, 16, 60)).astype(float)
    path = str(tmp_path / "mif.fil")
    with FilterbankWriter(path, _header(16, nbits, True, nifs=3)) as w:
        w.write_block(planes)
    for mode in ("sum", 0, 2):
        ours = FilterbankReader(path, if_mode=mode)
        ref = JaxReader(path, if_mode=mode)
        block = ours.read_block(5, 40, band_ascending=True)
        np.testing.assert_array_equal(block, ref.read_block(
            5, 40, band_ascending=True))
        expect = planes.sum(0) if mode == "sum" else planes[mode]
        np.testing.assert_array_equal(block, expect[::-1, 5:45])
        np.testing.assert_array_equal(
            ours.read_block_tensor(5, 40, "cpu").numpy(),
            block.astype(np.float32))
        view = np.empty((40, ours.frame_width), dtype=ours.frame_dtype)
        ours.read_frames_into(5, 40, view)
        np.testing.assert_array_equal(ours.host_samples(view), block.T)
    with pytest.raises(ValueError, match="IF planes"):
        FilterbankReader(path, if_mode=3)
    if nbits == 2:
        with pytest.raises(ValueError, match="single-IF"):
            FilterbankReader(path).read_block_packed(0, 4)


def test_widths_that_do_not_pack_are_refused(tmp_path):
    header = _header(10, 2, True)
    with pytest.raises(ValueError, match="whole bytes"):
        FilterbankWriter(str(tmp_path / "bad.fil"), header)
    with pytest.raises(ValueError):
        FilterbankWriter(str(tmp_path / "bad.fil"), _header(8, 3, True))
    with pytest.raises(ValueError, match="packed"):
        write_filterbank(str(tmp_path / "f8.fil"), np.zeros((8, 8)),
                         tsamp=1e-3, fch1=1400.0, foff=-1.0, nbits=8)
        FilterbankReader(str(tmp_path / "f8.fil")).read_block_packed(0, 4)


def test_accum_dtype_equals_jax():
    for nbits in (1, 2, 4):
        for nchan in (64, 1024, 4096, 1 << 20, 1 << 23):
            assert lowbit.accum_dtype(nbits, nchan) == \
                jax_lowbit.accum_dtype(nbits, nchan)


# -- the code-domain gates ----------------------------------------------------

def _frames(codes, nbits, descending=True):
    file_order = codes[::-1] if descending else codes
    return np.stack([jax_lowbit.pack_numpy(file_order[:, t], nbits)
                     for t in range(codes.shape[1])])


@pytest.mark.parametrize("nbits", [1, 2, 4])
@pytest.mark.parametrize("case", ["healthy", "zeros", "rails", "dead_half",
                                  "long"])
def test_gates_equal_jax(nbits, case):
    nchan = 32
    codes = _codes(nchan, 10000 if case == "long" else 2048, nbits,
                   seed=nbits)
    if case == "zeros":
        codes[:] = 0
    elif case == "rails":
        codes[:] = (1 << nbits) - 1
    elif case == "dead_half":
        codes[:20] = 1
    frames = _frames(codes, nbits)
    for policy, jpolicy in ((IntegrityPolicy(), JaxPolicy()),
                            (IntegrityPolicy(sanitize=False),
                             JaxPolicy(sanitize=False))):
        out, info = gate_chunk_packed(frames, nbits, nchan, policy)
        assert out is frames
        assert info == jax_gate_chunk_packed(frames, nbits, nchan,
                                             jpolicy)[1]
        block = codes.astype(np.float64)
        out, info = gate_chunk_lowbit(block, nbits, policy)
        assert out is block
        assert info == jax_gate_chunk_lowbit(block, nbits, jpolicy)[1]
    verdict = gate_chunk_packed(frames, nbits, nchan, IntegrityPolicy())[1]
    assert verdict["verdict"] == ("clean" if case in ("healthy", "long")
                                  else "quarantine")
    if case == "rails":
        assert "rail_frac" in verdict["reasons"]
    assert lowbit_code_stats(codes, nbits)["nbits"] == nbits


# -- the packed canary --------------------------------------------------------

def _bound(cls, nchan, **kw):
    c = cls(rate=kw.pop("rate", 1.0), snr=kw.pop("snr", 20.0),
            seed=kw.pop("seed", 1), **kw)
    return c.bind(nchan=nchan, start_freq=GEOM[0], bandwidth=GEOM[1],
                  tsamp=GEOM[2], dmmin=100, dmmax=200)


def _injections(registry):
    return sum(m["value"] for m in registry.snapshot()
               if m["name"] == "putpu_canary_packed_injections_total")


@pytest.mark.parametrize("nbits", [1, 2, 4])
@pytest.mark.parametrize("descending", [True, False])
def test_packed_canary_bytes_equal_jax(nbits, descending):
    nchan, nsamps = 32, 4096
    codes = _codes(nchan, nsamps, nbits, seed=60 + nbits)
    frames = _frames(codes, nbits, descending)
    ours, theirs = _bound(CanaryController, nchan), _bound(JaxCanary, nchan)
    before, jbefore = _injections(REGISTRY), _injections(JAX_REGISTRY)
    for chunk in (0, 4096, 12288):
        out = ours.maybe_inject_packed(frames, chunk, nbits=nbits,
                                       nchan=nchan,
                                       band_descending=descending)
        jout = theirs.maybe_inject_packed(frames, chunk, nbits=nbits,
                                          nchan=nchan,
                                          band_descending=descending)
        assert out is not frames
        np.testing.assert_array_equal(out, jout)
        decoded = lowbit.PackedFrames(out, nbits, nchan,
                                      band_descending=descending).to_host()
        diff = decoded - codes
        assert np.any(diff != 0) and np.all(diff >= 0)
    assert ours._pending == theirs._pending
    assert _injections(REGISTRY) - before == 3
    assert _injections(JAX_REGISTRY) - jbefore == 3
    # an unselected chunk is returned as it is
    half = _bound(CanaryController, nchan, rate=0.5)
    skipped = next(k for k in range(64) if not half.selects(k))
    assert half.maybe_inject_packed(frames, skipped, nbits=nbits,
                                    nchan=nchan) is frames


# -- the native host decode ---------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_native_source_is_the_jax_file_byte_for_byte():
    ours = os.path.join(REPO, "pulsarutils_tpu_torch", "native", "unpack.cpp")
    theirs = os.path.join(REPO, "pulsarutils_tpu", "native", "unpack.cpp")
    assert open(ours, "rb").read() == open(theirs, "rb").read()


@pytest.fixture
def fresh_native(monkeypatch):
    """The loader as in a fresh process (its state restored after)."""
    monkeypatch.setattr(lowbit, "_lib", None)
    monkeypatch.setattr(lowbit, "_lib_tried", False)
    return monkeypatch


def _halves_and_rails(nbits, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(0, 1 << nbits, 8000).astype(np.float32),
        rng.uniform(-2.0, (1 << nbits) + 2.0, 800).astype(np.float32),
        np.array([0.5, 1.5, 2.5, 3.5, 14.5, 15.5, -0.5, -3.0, 99.0, 1.4],
                 np.float32),
        np.zeros(6, np.float32)])[: 8800 // 8 * 8 + 8]


@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_native_decode_and_encode_equal_jax(nbits):
    """Built here (the host has a C++ compiler): the native path's bytes
    are the JAX package's native path's and the numpy oracle's, exact
    halves rounded to even."""
    assert lowbit.native_available()
    assert jax_lowbit.native_available()
    raw = np.random.default_rng(nbits).integers(0, 256, 1 << 16,
                                                dtype=np.uint8)
    before = lowbit.native_calls
    out = lowbit.unpack(raw, nbits)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, jax_lowbit.unpack(raw, nbits))
    np.testing.assert_array_equal(out, lowbit.unpack_numpy(raw, nbits))
    values = _halves_and_rails(nbits, nbits)
    values = values[: values.size // PER[nbits] * PER[nbits]]
    packed = lowbit.pack(values, nbits)
    np.testing.assert_array_equal(packed, jax_lowbit.pack(values, nbits))
    np.testing.assert_array_equal(packed, lowbit.pack_numpy(values, nbits))
    assert lowbit.native_calls == before + 2


@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_no_native_variable_takes_numpy(fresh_native, nbits):
    fresh_native.setenv("PUTPU_NO_NATIVE", "1")
    assert not lowbit.native_available()
    raw = np.arange(256, dtype=np.uint8)
    before = lowbit.native_calls
    np.testing.assert_array_equal(lowbit.unpack(raw, nbits),
                                  jax_lowbit.unpack_numpy(raw, nbits))
    values = _halves_and_rails(nbits, 7)
    values = values[: values.size // PER[nbits] * PER[nbits]]
    np.testing.assert_array_equal(lowbit.pack(values, nbits),
                                  jax_lowbit.pack_numpy(values, nbits))
    assert lowbit.native_calls == before


def test_native_builds_into_build_dir_else_a_user_temp_dir(fresh_native,
                                                           tmp_path):
    build = tmp_path / "pkg_build"
    fresh_native.setattr(lowbit, "_BUILD_DIR", str(build))
    path = lowbit._build_library()
    assert os.path.dirname(path) == str(build)
    assert os.path.basename(path).startswith("_unpack.")
    assert [p.name for p in build.iterdir()] == [os.path.basename(path)]
    # the second call reuses the library (no rebuild, no temp file)
    assert lowbit._build_library() == path
    # an unwritable build directory (here a file): the per-user temp dir
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    fresh_native.setattr(lowbit, "_BUILD_DIR", str(blocker / "_build"))
    fresh_native.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    path = lowbit._build_library()
    assert path.startswith(str(tmp_path / "tmp"))
    assert "pulsarutils_tpu_torch_native_" in path
    assert lowbit.native_available()


def test_no_working_compiler_takes_numpy_and_logs(fresh_native, tmp_path,
                                                  caplog):
    fresh_native.setattr(lowbit, "_BUILD_DIR", str(tmp_path / "b"))
    fresh_native.setattr(tempfile, "tempdir",
                         str(tmp_path / "t"))
    fresh_native.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with caplog.at_level("INFO", logger="pulsarutils_tpu_torch"):
        assert not lowbit.native_available()
    assert "numpy decode" in caplog.text
    raw = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(lowbit.unpack(raw, 2),
                                  lowbit.unpack_numpy(raw, 2))
    assert not list((tmp_path / "b").iterdir())  # no orphan temp file


def test_concurrent_builds_leave_one_library(tmp_path):
    """Processes building at once (parallel test workers) rename their
    own temp file into place: one library, no partial file left."""
    code = ("import sys, pulsarutils_tpu_torch.io.lowbit as l; "
            "l._BUILD_DIR = sys.argv[1]; "
            "print(l.native_available(), l._build_library())")
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "b")], cwd=REPO,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert {o[0] for o in outs} == {"True"}
    assert len({o[1] for o in outs}) == 1
    assert os.listdir(tmp_path / "b") == [os.path.basename(outs[0][1])]


@pytest.mark.parametrize("nbits", [1, 2, 4])
@pytest.mark.parametrize("nifs", [1, 3])
def test_host_reads_and_writes_go_through_the_native_decode(tmp_path, nbits,
                                                            nifs):
    """The reader's host blocks (``read_block``/``readBlock``, a
    multi-IF read, the bandpass scan) and the writer's host encode call
    the native decode, with the JAX package's bytes and values."""
    from pulsarutils_tpu.pipeline.spectral_stats import \
        get_spectral_stats as jax_stats
    from pulsarutils_tpu_torch.pipeline.spectral_stats import \
        get_spectral_stats

    rng = np.random.default_rng(nbits * 10 + nifs)
    shape = (nifs, 32, 300) if nifs > 1 else (32, 300)
    data = rng.integers(0, 1 << nbits, shape).astype(np.float64)
    path = str(tmp_path / "x.fil")
    before = lowbit.native_calls
    with FilterbankWriter(path, _header(32, nbits, True, nifs=nifs)) as w:
        w.write_block(data)
    assert lowbit.native_calls > before
    jpath = str(tmp_path / "jax.fil")
    with JaxWriter(jpath, _header(32, nbits, True, nifs=nifs)) as w:
        w.write_block(data)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    ours, ref = FilterbankReader(path), JaxReader(path)
    for read in ("read_block", "readBlock"):
        before = lowbit.native_calls
        block = getattr(ours, read)(7, 200, band_ascending=True)
        assert lowbit.native_calls > before
        np.testing.assert_array_equal(block, ref.readBlock(
            7, 200, as_filterbankBlock=False, band_ascending=True))
    before = lowbit.native_calls
    mean, std = get_spectral_stats(path, chunksize=64)
    assert lowbit.native_calls > before
    jmean, jstd = jax_stats(path, chunksize=64)
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(std, jstd)


@pytest.mark.parametrize("nbits", [2, 4])
def test_cpu_clean_goes_through_the_native_decode(tmp_path, nbits):
    from pulsarutils_tpu.pipeline.cleanup import cleanup_data as jax_clean
    from pulsarutils_tpu_torch.pipeline.cleanup import cleanup_data

    data = _codes(32, 400, nbits, 3).astype(np.float64)
    data[5] = 0.0
    path = str(tmp_path / "in.fil")
    with FilterbankWriter(path, _header(32, nbits, True)) as w:
        w.write_block(data)
    before = lowbit.native_calls
    cleanup_data(path, str(tmp_path / "ours.fil"), surelybad=(3,),
                 chunksize=128, device="cpu")
    assert lowbit.native_calls > before
    jax_clean(path, str(tmp_path / "jax.fil"), surelybad=(3,),
              chunksize=128)
    assert open(tmp_path / "ours.fil", "rb").read() \
        == open(tmp_path / "jax.fil", "rb").read()


@pytest.mark.parametrize("nbits", [1, 2, 4])
@pytest.mark.parametrize("descending", [True, False])
def test_unpack_from_meta_equals_jax(nbits, descending):
    codes = _codes(40, 64, nbits, nbits)
    frames = _frames(codes, nbits, descending)
    packed = lowbit.PackedFrames(frames, nbits, 40, descending)
    for dtype_name in ("float32", "int32"):
        meta = packed.meta(dtype_name)
        ours = lowbit.unpack_from_meta(torch.from_numpy(frames), meta)
        theirs = jax_lowbit.unpack_from_meta(jnp.asarray(frames), meta, jnp)
        assert ours.dtype == getattr(torch, dtype_name)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_device_paths_keep_the_torch_unpack(tmp_path):
    """The chunk loop's block (a single-IF packed file) and the
    statistics sample stay off the native decode, as in JAX."""
    codes = _codes(32, 256, 2, 5)
    path = str(tmp_path / "x.fil")
    with FilterbankWriter(path, _header(32, 2, True)) as w:
        w.write_block(codes)
    reader = FilterbankReader(path)
    before = lowbit.native_calls
    block = reader.read_block_tensor(0, 256, "cpu")
    lowbit.sample_codes(reader.read_block_packed(0, 256), 2, 32)
    assert lowbit.native_calls == before
    np.testing.assert_array_equal(block.numpy(), codes[::-1])


@pytest.mark.parametrize("nbits", [1, 2, 4])
@pytest.mark.parametrize("nbytes", [(2 << 20) + 999, (2 << 20) + 4096,
                                    (3 << 20) + 10007])
def test_native_calls_split_over_threads_give_the_single_call(monkeypatch,
                                                              nbits, nbytes):
    """A call of 2 MiB or more runs in byte slices on several threads
    (three cores here): the values and bytes of one call, whatever the
    slice bounds."""
    monkeypatch.setattr(lowbit.os, "cpu_count", lambda: 3)
    raw = np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                                 dtype=np.uint8)
    before = lowbit.native_calls
    out = lowbit.unpack(raw, nbits)
    np.testing.assert_array_equal(out, jax_lowbit.unpack_numpy(raw, nbits))
    values = out
    values[::7] += 0.5        # exact halves round to even
    values[::11] = -1.0
    values[::13] = 99.0
    np.testing.assert_array_equal(lowbit.pack(values, nbits),
                                  jax_lowbit.pack(values, nbits))
    assert lowbit.native_calls == before + 2


@pytest.mark.parametrize("nbits", [1, 2, 4])
@pytest.mark.parametrize("descending", [True, False])
def test_packed_frames_to_host_goes_through_the_native_decode(nbits,
                                                              descending):
    """``PackedFrames.to_host`` (multibeam's host packed mode) decodes
    with :func:`lowbit.unpack`, to the JAX package's block."""
    codes = _codes(40, 64, nbits, nbits + 7)
    frames = _frames(codes, nbits, descending)
    before = lowbit.native_calls
    ours = lowbit.PackedFrames(frames, nbits, 40, descending).to_host()
    assert lowbit.native_calls == before + 1
    theirs = jax_lowbit.PackedFrames(frames, nbits, 40, descending).to_host()
    assert ours.dtype == np.float32 and ours.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, codes)
