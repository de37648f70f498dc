"""The port's file CLIs on the CPU, held against the JAX package's:
``PUstats`` (the ``.badchans`` bytes, 8-bit, 2-bit and multi-IF files),
``PUcands`` (the CSV of one store, sifted and raw) and ``PUclean`` (the
cleaned file's bytes at 8 and 2 bits and for a 2-IF file; with
``--fft-zap`` the zapped bins equal and the codes within the stated
tolerance)."""
import logging
import os
import re
import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from pulsarutils_tpu.cli import cands_main as jax_cands_main
from pulsarutils_tpu.cli import clean_main as jax_clean_main
from pulsarutils_tpu.cli import stats_main as jax_stats_main
from pulsarutils_tpu.io.sigproc import FilterbankReader as JaxReader
from pulsarutils_tpu.obs.metrics import REGISTRY as JAX_REGISTRY
from pulsarutils_tpu.ops.clean_ops import fft_zap_time as jax_fft_zap_time
from pulsarutils_tpu.pipeline.search_pipeline import \
    search_by_chunks as jax_search_by_chunks

from pulsarutils_tpu_torch.cli import cands_main, clean_main, stats_main
from pulsarutils_tpu_torch.io.sigproc import (FilterbankReader,
                                              FilterbankWriter)
from pulsarutils_tpu_torch.models.simulate import disperse_array
from pulsarutils_tpu_torch.obs.metrics import REGISTRY
from pulsarutils_tpu_torch.pipeline.cleanup import cleanup_data
from pulsarutils_tpu_torch.pipeline.search_pipeline import search_by_chunks

torch.set_num_threads(1)

TSAMP = 0.0005


@pytest.fixture(autouse=True)
def clean_registries():
    """Both packages' process-wide registries, reset after each test."""
    yield
    REGISTRY.reset()
    JAX_REGISTRY.reset()
#: codes that differ between the port's and the JAX package's --fft-zap
#: output: both compute in float64, so a code moves only where a cleaned
#: value falls within rounding of a half-code boundary (0 of the 262,144
#: codes of each file here); the cap allows one in 10^4
FFT_ZAP_CODE_TOL = 1e-4


def _file(path, nbits, nifs=1, nchan=32, nsamples=8192, seed=0, tone=False,
          hot=(5, 21)):
    """Noise codes with hot channels ``hot`` (and a periodic tone in every
    channel with ``tone``), at ``nbits`` bits and ``nifs`` IFs."""
    rng = np.random.default_rng(seed)
    top = (1 << nbits) - 1 if nbits < 32 else 200
    mid = top / 2.0
    x = rng.normal(mid, top / 6.0, (nifs, nchan, nsamples))
    x[:, list(hot)] += rng.normal(0, top / 2.0, (nifs, len(hot), nsamples))
    if tone:
        x += (top / 4.0) * np.sin(2 * np.pi * np.arange(nsamples) / 64)
    if nbits < 32:
        x = np.clip(np.rint(x), 0, top)
    header = {"nchans": nchan, "nbits": nbits, "nifs": nifs, "tsamp": TSAMP,
              "fch1": 1400.0, "foff": -200.0 / nchan, "tstart": 60000.0,
              "source_name": "clis"}
    with FilterbankWriter(str(path), header) as w:
        w.write_block(x if nifs > 1 else x[0])
    return str(path)


def _twins(src, tmp_path):
    """Two copies of ``src``, one for each package (the ``.badchans`` cache
    sits beside the file)."""
    out = []
    for who in ("ours", "theirs"):
        d = tmp_path / who
        d.mkdir(exist_ok=True)
        out.append(str(shutil.copy(src, d / os.path.basename(src))))
    return out


CASES = [(8, 1), (2, 1), (4, 1), (1, 1), (2, 2), (8, 2)]


@pytest.mark.parametrize("nbits,nifs", CASES)
def test_stats_badchans_bytes_equal_jax(tmp_path, nbits, nifs):
    src = _file(tmp_path / "obs.fil", nbits, nifs, seed=nbits + nifs)
    ours, theirs = _twins(src, tmp_path)
    assert stats_main.main([ours, "--surelybad", "2"]) == 0
    assert jax_stats_main.main([theirs, "--surelybad", "2"]) == 0
    mine = open(ours + ".badchans", "rb").read()
    assert mine == open(theirs + ".badchans", "rb").read()
    flagged = np.flatnonzero(np.loadtxt(ours + ".badchans"))
    if nbits > 1:  # one bit cannot show a hot channel's excess power
        assert {5, 21} <= set(flagged)
    # the cache is read back, --refresh rewrites it the same
    assert stats_main.main([ours, "--refresh"]) == 0
    assert open(ours + ".badchans", "rb").read() == mine


def test_stats_plot(tmp_path):
    pytest.importorskip("matplotlib")
    src = _file(tmp_path / "obs.fil", 2)
    ours, theirs = _twins(src, tmp_path)
    png = tmp_path / "bp.png"
    assert stats_main.main([ours, "--plot", str(png)]) == 0
    assert png.stat().st_size > 1000
    assert jax_stats_main.main([theirs, "--plot",
                                str(tmp_path / "jbp.png")]) == 0
    assert open(ours + ".badchans", "rb").read() == \
        open(theirs + ".badchans", "rb").read()


@pytest.mark.parametrize("nbits,nifs", [(8, 1), (2, 1), (2, 2), (8, 2),
                                        (32, 1)])
def test_clean_bytes_equal_jax(tmp_path, nbits, nifs):
    src = _file(tmp_path / "dirty.fil", nbits, nifs, seed=10 + nbits)
    ours, theirs = _twins(src, tmp_path)
    out, jout = str(tmp_path / "ours.fil"), str(tmp_path / "theirs.fil")
    assert clean_main.main([ours, "-o", out, "--surelybad", "7",
                            "--device", "cpu", "--chunksize", "3000"]) == 0
    assert jax_clean_main.main([theirs, "-o", jout, "--surelybad", "7",
                                "--chunksize", "3000"]) == 0
    assert open(out, "rb").read() == open(jout, "rb").read()
    r = FilterbankReader(out)
    assert (r.nbits, r.nifs, r.nsamples) == (nbits, nifs, 8192)
    for k in range(nifs):
        plane = FilterbankReader(out, if_mode=k).read_block(0, 8192)
        assert not plane[[5, 7, 21]].any()


def test_clean_default_output_name(tmp_path):
    src = _file(tmp_path / "obs.fil", 2)
    ours, theirs = _twins(src, tmp_path)
    assert clean_main.main([ours, "--device", "cpu"]) == 0
    assert jax_clean_main.main([theirs]) == 0
    assert open(ours.replace(".fil", "_clean.fil"), "rb").read() == \
        open(theirs.replace(".fil", "_clean.fil"), "rb").read()


def _jax_zapped(path, mask, chunksize):
    """The zapped bins of the JAX package's cleanup, chunk by chunk (its
    own loop: the mask, then ``fft_zap_time``, on its reader's blocks)."""
    reader = JaxReader(path)
    out = []
    for istart in range(0, reader.nsamples, chunksize):
        block = reader.read_block(istart, chunksize).copy()
        block[mask, :] = 0.0
        _, zapped = jax_fft_zap_time(block)
        out.append((istart, 0, np.flatnonzero(zapped)))
    return out


@pytest.mark.parametrize("nbits", [2, 8])
def test_clean_fft_zap_equals_jax(tmp_path, nbits, caplog):
    src = _file(tmp_path / "tone.fil", nbits, seed=30, tone=True)
    ours, theirs = _twins(src, tmp_path)
    out, jout = str(tmp_path / "ours.fil"), str(tmp_path / "theirs.fil")
    summary = {}
    mask = cleanup_data(ours, out, fft_zap=True, chunksize=4096,
                        device="cpu", summary=summary)
    with caplog.at_level(logging.INFO, logger="pulsarutils_tpu"):
        assert jax_clean_main.main([theirs, "-o", jout, "--fft-zap",
                                    "--chunksize", "4096"]) == 0
    jax_zapped = _jax_zapped(theirs, mask, 4096)
    assert len(summary["zapped"]) == len(jax_zapped) == 2
    for (lo, k, bins), (jlo, jk, jbins) in zip(summary["zapped"],
                                               jax_zapped):
        assert (lo, k) == (jlo, jk)
        np.testing.assert_array_equal(bins, jbins)
        assert 64 in bins  # the tone's bin (4096 / 64)
    logged = [int(m.group(1)) for m in (
        re.search(r"(\d+) Fourier bins zapped", r.getMessage())
        for r in caplog.records) if m]
    assert logged == [summary["nzapped"]]
    a = FilterbankReader(out).read_block(0, 8192)
    b = JaxReader(jout).read_block(0, 8192)
    assert np.count_nonzero(a != b) <= FFT_ZAP_CODE_TOL * a.size
    assert not a[[5, 21]].any()


def test_clean_rejects_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cpu"):
        cleanup_data("unused.fil", "unused_out.fil")


# -- PUcands ------------------------------------------------------------------

def _pulse_file(path, nbits=8):
    rng = np.random.default_rng(5)
    nchan, nsamples = 64, 16384
    x = np.abs(rng.normal(0, 0.5, (nchan, nsamples))) + 20.0
    x[:, 9000] += 4.0
    x = disperse_array(x, 150.0, 1200.0, 200.0, TSAMP)
    header = {"nchans": nchan, "nbits": nbits, "nifs": 1, "tsamp": TSAMP,
              "fch1": 1400.0 - 200.0 / nchan / 2, "foff": -200.0 / nchan,
              "tstart": 60000.0}
    with FilterbankWriter(str(path), header) as w:
        w.write_block(x[::-1])
    return str(path)


@pytest.mark.parametrize("producer", ["ours", "theirs"])
def test_cands_csv_equal_jax(tmp_path, producer):
    path = _pulse_file(tmp_path / "pulse.fil")
    store = tmp_path / "store"
    search = dict(dmmin=100.0, dmmax=200.0, snr_threshold=6.0,
                  make_plots=False, output_dir=str(store))
    if producer == "ours":
        hits, _ = search_by_chunks(path, device="cpu", **search)
    else:
        hits, _ = jax_search_by_chunks(path, backend="jax", kernel="pallas",
                                       progress=False, **search)
    assert hits
    for extra in ([], ["--no-sift"], ["--min-snr", "1e9"]):
        mine, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
        assert cands_main.main([str(store), "--csv", str(mine), *extra]) \
            == 0
        assert jax_cands_main.main([str(store), "--csv", str(theirs),
                                    *extra]) == 0
        assert mine.read_bytes() == theirs.read_bytes()
    rows = (tmp_path / "ours.csv").read_text().splitlines()
    assert rows[0].split(",") == cands_main.CSV_FIELDS


def test_cands_missing_and_empty_directory(tmp_path):
    missing = str(tmp_path / "nope")
    assert cands_main.main([missing]) == jax_cands_main.main([missing]) == 1
    assert not os.path.exists(missing)
    (tmp_path / "empty").mkdir()
    assert cands_main.main([str(tmp_path / "empty")]) == 0
