"""The reference's library surface in the port, held against the JAX
package: ``quick_chan_rebin``, ``roll_and_sum``, ``dedisperse``,
``get_noisier_channels``, ``measure_channel_variability``,
``inject_rfi``, the spectral moments and ``spectral_stats_scan``, the
top-level names, ``__version__``, ``test()``, and ``progress=`` of
``search_by_chunks`` and ``periodicity_search``."""

from __future__ import annotations

import logging
import subprocess

import numpy as np
import pytest
import torch

import pulsarutils_tpu as J
import pulsarutils_tpu_torch as P
from pulsarutils_tpu.models import simulate as jsim
from pulsarutils_tpu.ops import clean_ops as jclean
from pulsarutils_tpu.ops import dedisperse as jded
from pulsarutils_tpu.ops import rebin as jrebin
from pulsarutils_tpu.pipeline import spectral_stats as jstats
from pulsarutils_tpu_torch.io.sigproc import write_simulated_filterbank
from pulsarutils_tpu_torch.models import simulate as tsim
from pulsarutils_tpu_torch.ops import clean_ops as tclean
from pulsarutils_tpu_torch.ops import dedisperse as tded
from pulsarutils_tpu_torch.ops import rebin as trebin
from pulsarutils_tpu_torch.periodicity.driver import periodicity_search
from pulsarutils_tpu_torch.pipeline import spectral_stats as tstats
from pulsarutils_tpu_torch.pipeline.search_pipeline import search_by_chunks

torch.set_num_threads(1)

#: float tolerance between a float32 device reduction of the port and the
#: JAX package's (their summation orders differ)
F32_RTOL = 1e-5


def _rfi_block(seed, nchan=64, nsamples=2048, dtype=np.float64):
    """Seeded noise with loud and dead channels: flags that mean
    something."""
    rng = np.random.default_rng(seed)
    data = rng.normal(10.0, 1.0, (nchan, nsamples))
    data[[5, 40]] += 6.0            # bright (noisier-channel) outliers
    data[17] *= 4.0                 # a high-variance channel
    data[50] = 10.0 + 0.01 * rng.standard_normal(nsamples)  # dead-ish
    return data.astype(dtype)


# -- rebin and dedisperse ----------------------------------------------------

@pytest.mark.parametrize("shape, factor, dtype", [
    ((5, 3), 2, np.float64), ((8, 2), 2, np.int64), ((64, 100), 4,
                                                     np.float32),
    ((13, 7), 3, np.float64), ((4, 4), 4, np.int32)])
def test_quick_chan_rebin_equals_jax(shape, factor, dtype):
    rng = np.random.default_rng(sum(shape))
    counts = (rng.integers(0, 100, shape) if np.dtype(dtype).kind == "i"
              else rng.standard_normal(shape)).astype(dtype)
    ref = jrebin.quick_chan_rebin(counts, factor)
    ours = trebin.quick_chan_rebin(torch.from_numpy(counts), factor)
    assert ours.dtype == torch.from_numpy(ref).dtype
    if np.dtype(dtype) == np.float32:
        # float32 block sums of up to ``factor`` terms, in an order that
        # may differ from numpy's
        assert np.allclose(ours.numpy(), ref, rtol=F32_RTOL)
    else:
        assert np.array_equal(ours.numpy(), ref)


def test_quick_chan_rebin_doctests_pin_the_jax_values():
    ones = trebin.quick_chan_rebin(torch.ones((5, 3), dtype=torch.float64), 2)
    assert np.array_equal(ones.numpy(), jrebin.quick_chan_rebin(
        np.ones((5, 3)), 2))
    ints = trebin.quick_chan_rebin(torch.arange(8).reshape(4, 2), 2)
    assert ints.tolist() == [[2, 4], [10, 12]]


@pytest.mark.parametrize("n", [0, 3, -2, 10, 13])
def test_roll_and_sum_equals_jax(n):
    array = np.random.default_rng(n + 20).standard_normal(10)
    ours, theirs = np.ones(10), np.ones(10)
    out = tded.roll_and_sum(array, ours, n)
    assert out is ours
    jded.roll_and_sum(array, theirs, n)
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dedisperse_equals_jax(seed):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((16, 500))
    shifts = rng.uniform(-700, 700, 16)
    assert np.array_equal(tded.dedisperse(data, shifts),
                          jded.dedisperse(data, shifts))


# -- the channel flaggers ----------------------------------------------------

@pytest.mark.parametrize("seed, medfilt, nsigma", [
    (1, 7, 5.0), (2, 11, 3.0), (3, 5, 2.0)])
def test_get_noisier_channels_equals_jax(seed, medfilt, nsigma):
    data = _rfi_block(seed)
    ref = jclean.get_noisier_channels(data, medfilt, nsigma)
    ours = tclean.get_noisier_channels(torch.from_numpy(data), medfilt,
                                       nsigma)
    assert ours.dtype == torch.bool
    assert np.array_equal(ours.numpy(), ref) and ref[[5, 40]].all()


@pytest.mark.parametrize("seed, with_mask", [(1, False), (2, True),
                                             (4, True)])
def test_measure_channel_variability_equals_jax(seed, with_mask):
    data = _rfi_block(seed)
    mask = None
    if with_mask:
        mask = np.zeros(64, dtype=bool)
        mask[[2, 3, 60]] = True
    ref = jclean.measure_channel_variability(data, mask)
    ours = tclean.measure_channel_variability(
        torch.from_numpy(data), None if mask is None else
        torch.from_numpy(mask))
    assert np.array_equal(ours.numpy(), ref)
    assert ref[17] and ref[50]


def test_flaggers_on_float32_tensors_match_float64():
    data = _rfi_block(7)
    f32 = torch.from_numpy(data.astype(np.float32))
    assert np.array_equal(tclean.get_noisier_channels(f32).numpy(),
                          jclean.get_noisier_channels(data))
    assert np.array_equal(tclean.measure_channel_variability(f32).numpy(),
                          jclean.measure_channel_variability(data))


# -- inject_rfi --------------------------------------------------------------

@pytest.mark.parametrize("rng", [7, "generator", None])
def test_inject_rfi_equals_jax(rng):
    array = np.random.default_rng(3).standard_normal((16, 300))
    kw = dict(bad_channels=(2, 9), bad_channel_scale=7.0,
              impulse_times=(10, 299, 305), impulse_scale=3.0)
    if rng == "generator":
        ours = tsim.inject_rfi(array, rng=np.random.default_rng(5), **kw)
        theirs = jsim.inject_rfi(array, rng=np.random.default_rng(5), **kw)
        assert np.array_equal(ours, theirs)
    elif rng is None:
        ours = tsim.inject_rfi(array, **kw)
        assert ours.shape == array.shape and ours[:, 10].min() > \
            array[:, 10].min()
    else:
        assert np.array_equal(tsim.inject_rfi(array, rng=rng, **kw),
                              jsim.inject_rfi(array, rng=rng, **kw))
    assert np.array_equal(array, np.random.default_rng(3).standard_normal(
        (16, 300)))  # the input is not modified


# -- the spectral moments ----------------------------------------------------

def test_moments_on_arrays_equal_jax():
    blocks = [_rfi_block(s, nsamples=300) for s in (1, 2, 3)]
    ours = (np.zeros(64), np.zeros(64), 0)
    theirs = (np.zeros(64), np.zeros(64), 0)
    for b in blocks:
        ours = tstats.moment_accumulate(ours, b)
        theirs = jstats.moment_accumulate(theirs, b)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)
    mean, std = tstats.moments_to_spectra(*ours)
    jmean, jstd = jstats.moments_to_spectra(*theirs)
    assert np.array_equal(mean, jmean) and np.array_equal(std, jstd)


def test_moments_on_tensors_equal_the_arrays():
    blocks = [_rfi_block(s, nsamples=300) for s in (4, 5)]
    carry = (torch.zeros(64, dtype=torch.float64),
             torch.zeros(64, dtype=torch.float64), 0)
    jcarry = (np.zeros(64), np.zeros(64), 0)
    for b in blocks:
        carry = tstats.moment_accumulate(carry, torch.from_numpy(b))
        jcarry = jstats.moment_accumulate(jcarry, b)
    mean, std = tstats.moments_to_spectra(*carry)
    jmean, jstd = jstats.moments_to_spectra(*jcarry)
    assert np.allclose(mean.numpy(), jmean, rtol=1e-12)
    assert np.allclose(std.numpy(), jstd, rtol=1e-10)


@pytest.mark.parametrize("baseline", [0.0, 100.0])
def test_spectral_stats_scan_equals_jax(baseline):
    chunks = np.stack([_rfi_block(s, nsamples=512, dtype=np.float32)
                       for s in range(4)]) + np.float32(baseline)
    mean, std = tstats.spectral_stats_scan(torch.from_numpy(chunks))
    jmean, jstd = (np.asarray(x) for x in
                   jstats.spectral_stats_scan_jax(chunks))
    assert mean.dtype == std.dtype == torch.float32
    # float32 sums in different orders: within F32_RTOL of each other and
    # of the float64 truth
    assert np.allclose(mean.numpy(), jmean, rtol=F32_RTOL)
    assert np.allclose(std.numpy(), jstd, rtol=F32_RTOL)
    flat = chunks.astype(np.float64).transpose(1, 0, 2).reshape(64, -1)
    assert np.allclose(std.numpy(), flat.std(axis=1), rtol=F32_RTOL)
    # the flags of the scan's spectra equal those of the host scan
    flags = tstats.flag_bad_channels(mean.numpy(), std.numpy())
    assert np.array_equal(flags, tstats.flag_bad_channels(
        flat.mean(axis=1), flat.std(axis=1)))


# -- the top level -----------------------------------------------------------

def test_top_level_names_equal_jax():
    from pulsarutils_tpu_torch.parallel.stream import ring_dedisperse

    ours = set(P.__all__)
    theirs = set(J.__all__)
    # plan_survey is the port's own export; every JAX name is ported
    assert ours - {"plan_survey"} == theirs
    assert P._NOT_PORTED == {}
    for name in P.__all__:
        assert getattr(P, name) is not None, name
    assert P.ring_dedisperse is ring_dedisperse
    with pytest.raises(AttributeError, match="no attribute"):
        P.no_such_name  # noqa: B018
    assert P.__version__ == J.__version__


def test_test_runs_the_port_suite_in_a_subprocess(monkeypatch):
    calls = []

    def fake_run(cmd, cwd=None):
        calls.append((cmd, cwd))
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert P.test("-k nothing") == 0
    (cmd, cwd), = calls
    files = [c for c in cmd if c.endswith(".py")]
    assert cmd[1:3] == ["-m", "pytest"] and cmd[-2:] == ["-k", "nothing"]
    assert files and all("/tests/test_torch_" in f for f in files)
    assert cwd and files[0].startswith(cwd)


# -- progress= on both drivers -----------------------------------------------

@pytest.fixture(scope="module")
def small_file(tmp_path_factory):
    array, header = simulate_test_data_small()
    path = tmp_path_factory.mktemp("surface") / "pulse.fil"
    write_simulated_filterbank(str(path), array + 20.0, header,
                               descending=True, nbits=8)
    return str(path)


def simulate_test_data_small():
    return tsim.simulate_test_data(150.0, nsamples=8192, nchan=16,
                                   signal=10.0, noise=4.0, rng=5)


@pytest.mark.parametrize("progress", [True, False])
def test_drivers_take_progress(small_file, tmp_path, monkeypatch, caplog,
                               progress):
    import pulsarutils_tpu_torch.pipeline.search_pipeline as sp

    monkeypatch.setattr(sp, "PROGRESS_EVERY", 1)
    kw = dict(dmmin=100.0, dmmax=200.0, chunk_length=1.024,
              snr_threshold=6.0, device="cpu")
    with caplog.at_level(logging.INFO, logger="pulsarutils_tpu_torch"):
        search_by_chunks(small_file, output_dir=str(tmp_path / "s"),
                         make_plots=False, progress=progress, **kw)
        res = periodicity_search(small_file, output_dir=str(tmp_path / "p"),
                                 accel_max=0.0, n_accel=1, progress=progress,
                                 **kw)
    assert res["complete"]
    logged = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("processed ")]
    assert bool(logged) == progress
