"""The port's host tables equal the JAX package's: plan, shifts, offsets,
chunk grid, bad-channel mask and resume-ledger fingerprint."""
import numpy as np
import pytest
import torch

from pulsarutils_tpu.io.sigproc import write_simulated_filterbank as jax_write
from pulsarutils_tpu.ops import plan as jplan
from pulsarutils_tpu.ops.search import _offsets_for as jax_offsets_for
from pulsarutils_tpu.parallel import stream as jstream
from pulsarutils_tpu.pipeline.search_pipeline import plan_survey as jax_plan_survey
from pulsarutils_tpu.pipeline.spectral_stats import get_bad_chans as jax_bad_chans

from pulsarutils_tpu_torch.ops import plan as tplan
from pulsarutils_tpu_torch.parallel import stream as tstream
from pulsarutils_tpu_torch.pipeline.search_pipeline import plan_survey
from pulsarutils_tpu_torch.pipeline.spectral_stats import get_bad_chans

torch.set_num_threads(1)

GEOMETRIES = [
    # nchan, dmmin, dmmax, start_freq, bandwidth, tsamp, nsamples
    (1024, 300.0, 635.0, 1200.0, 200.0, 5e-4, 1 << 20),   # headline
    (64, 100.0, 200.0, 1200.0, 200.0, 5e-4, 16384),
    (48, 0.0, 80.0, 110.0, 60.0, 6.4e-5, 3000),           # low frequency
]


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_plan_and_offset_tables_equal(geom):
    nchan, dmmin, dmmax, f0, bw, tsamp, nsamples = geom
    dms = tplan.dedispersion_plan(nchan, dmmin, dmmax, f0, bw, tsamp)
    jdms = jplan.dedispersion_plan(nchan, dmmin, dmmax, f0, bw, tsamp)
    np.testing.assert_array_equal(dms, jdms)
    assert len(dms) == tplan.plan_size(nchan, dmmin, dmmax, f0, bw, tsamp)
    shifts = tplan.dedispersion_shifts_batch(dms, nchan, f0, bw, tsamp)
    np.testing.assert_array_equal(
        shifts, jplan.dedispersion_shifts_batch(jdms, nchan, f0, bw, tsamp))
    np.testing.assert_array_equal(
        tplan.normalize_shifts(shifts, nsamples),
        jplan.normalize_shifts(shifts, nsamples))
    off = tplan.offsets_for(dms, nchan, f0, bw, tsamp, nsamples)
    assert off.dtype == np.int32
    np.testing.assert_array_equal(
        off, jax_offsets_for(jdms, nchan, f0, bw, tsamp, nsamples))
    np.testing.assert_array_equal(
        tplan.dedispersion_shifts(nchan, dms[-1], f0, bw, tsamp),
        jplan.dedispersion_shifts(nchan, dms[-1], f0, bw, tsamp))
    assert tplan.dmmax_for_trials(dmmin, 512, f0, bw, tsamp) == \
        jplan.dmmax_for_trials(dmmin, 512, f0, bw, tsamp)


def test_headline_plan_has_514_trials():
    assert len(tplan.dedispersion_plan(1024, 300, 635, 1200, 200, 5e-4)) == 514


@pytest.mark.parametrize("args", [
    (16384, 5e-4, 100, 200, 1200.0, 1400.0, 200 / 64, None, None),
    (16384, 5e-4, 100, 200, 1200.0, 1400.0, -200 / 64, 0.5, None),
    (1 << 20, 5e-4, 300, 635, 1200.0, 1400.0, 200 / 1024, 65.536, None),
    (50000, 6.4e-5, 10, 80, 110.0, 170.0, 60 / 48, None, 2.6e-4),
])
def test_chunk_grid_equal(args):
    nsamples, tsamp = args[:2]
    plan = tstream.plan_chunks(*args[:7], chunk_length=args[7],
                               new_sample_time=args[8])
    jp = jstream.plan_chunks(*args[:7], chunk_length=args[7],
                             new_sample_time=args[8])
    assert (plan.step, plan.hop, plan.resample, plan.sample_time) == \
        (jp.step, jp.hop, jp.resample, jp.sample_time)
    for tmin in (0, 1.0):
        assert list(tstream.iter_chunk_starts(nsamples, plan, tmin, tsamp)) \
            == list(jstream.iter_chunk_starts(nsamples, jp, tmin, tsamp))


@pytest.fixture(scope="module")
def rfi_file(tmp_path_factory):
    rng = np.random.default_rng(3)
    nchan, nsamples = 64, 4096
    array = np.abs(rng.normal(0, 4.0, (nchan, nsamples))) + 40.0
    array[[5, 17, 40]] += np.abs(rng.normal(0, 40.0, (3, nsamples)))
    array[50] += 30.0
    sim_header = {"bandwidth": 200., "fbottom": 1200., "nchans": nchan,
                  "nsamples": nsamples, "tsamp": 5e-4, "foff": 200. / nchan}
    tmp = tmp_path_factory.mktemp("plan")
    path = str(tmp / "rfi.fil")
    jax_write(path, array, sim_header, descending=True, nbits=8)
    return path


def test_bad_channel_mask_equal(rfi_file, tmp_path):
    ours = get_bad_chans(rfi_file, cache=str(tmp_path / "ours.badchans"),
                         surelybad=(2,))
    ref = jax_bad_chans(rfi_file, cache=str(tmp_path / "ref.badchans"),
                        surelybad=(2,))
    np.testing.assert_array_equal(ours, ref)
    assert ours.sum() >= 4  # the injected channels are caught
    # the cache files are interchangeable
    assert (tmp_path / "ours.badchans").read_text() == \
        (tmp_path / "ref.badchans").read_text()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(chunk_length=0.5, zero_dm=True, surelybad=(3, 1)),
    dict(kernel="pallas", snr_threshold=7.5, fft_zap=True, cut_outliers=True),
])
def test_fingerprint_is_the_jax_fields_with_backend_torch(rfi_file, kw):
    ours = plan_survey(rfi_file, dmmin=100, dmmax=200, **kw)
    ref = jax_plan_survey(rfi_file, dmmin=100, dmmax=200, backend="torch",
                          **kw)
    assert ours["fingerprint"] == ref["fingerprint"]
    assert ours["chunk_starts"] == ref["chunk_starts"]
    assert ours["fingerprint"] != jax_plan_survey(
        rfi_file, dmmin=100, dmmax=200, backend="jax", **kw)["fingerprint"]
