"""The port's scorer, cleaning ops and search against the JAX package's
(``xp=jnp``, float32, as its device path runs them)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pulsarutils_tpu.ops import clean_ops as jclean
from pulsarutils_tpu.ops import robust as jrobust
from pulsarutils_tpu.ops.rebin import quick_resample as jax_quick_resample
from pulsarutils_tpu.ops.search import dedispersion_search as jax_search
from pulsarutils_tpu.ops.search import score_profiles_stacked

from pulsarutils_tpu_torch.models.simulate import simulate_test_data
from pulsarutils_tpu_torch.ops import clean_ops as tclean
from pulsarutils_tpu_torch.ops import robust as trobust
from pulsarutils_tpu_torch.ops.rebin import quick_resample
from pulsarutils_tpu_torch.ops.search import (dedispersion_search,
                                              score_profiles)

torch.set_num_threads(1)

# float32 reductions in another order than XLA's
RTOL = 1e-5
CLEAN_TOL = dict(rtol=1e-5, atol=1e-6)


def _plane(seed, ndm=48, t=4096, dc=0.0):
    rng = np.random.default_rng(seed)
    plane = rng.normal(dc, 1.0, (ndm, t)).astype(np.float32)
    plane[ndm // 3, 1234:1238] += 9.0    # a width-4 pulse
    plane[ndm // 2, t - 7] += 12.0       # a width-1 pulse
    return plane


@pytest.mark.parametrize("seed, t, dc", [(0, 4096, 0.0), (1, 3001, 0.0),
                                         (2, 2048, 3.0)])
def test_scorer_matches_jax(seed, t, dc):
    plane = _plane(seed, t=t, dc=dc)
    ref = np.asarray(score_profiles_stacked(jnp.asarray(plane), xp=jnp))
    m, s, snr, win, peak = (x.numpy() for x in
                            score_profiles(torch.from_numpy(plane)))
    np.testing.assert_array_equal(win, np.rint(ref[3]).astype(np.int32))
    np.testing.assert_array_equal(peak, np.rint(ref[4]).astype(np.int64))
    assert peak.dtype == np.int64
    assert np.argmax(snr) == np.argmax(ref[2])
    for ours, theirs in ((m, ref[0]), (s, ref[1]), (snr, ref[2])):
        np.testing.assert_allclose(ours, theirs, rtol=RTOL)


def _float64_scores(plane):
    """The scorer's definition in float64: centred on the exact mean,
    boxcar block sums of width 1, 2, 4, 8, first argmax, strict ``>``."""
    x = plane.astype(np.float64)
    x -= x.mean(axis=1, keepdims=True)
    best = np.zeros(len(x))
    windows = np.zeros(len(x), np.int64)
    peaks = np.zeros(len(x), np.int64)
    for w in (1, 2, 4, 8):
        n = x.shape[1] // w
        sums = x[:, :n * w].reshape(len(x), n, w).sum(axis=2)
        snr = sums.max(axis=1) / sums.std(axis=1)
        better = snr > best
        best = np.where(better, snr, best)
        windows = np.where(better, w, windows)
        peaks = np.where(better, sums.argmax(axis=1) * w, peaks)
    return x.max(axis=1), x.std(axis=1), best, windows, peaks


def test_direct_search_at_dc_1e4_matches_float64_truth():
    # the scorer centres each row on its float64 mean rounded to float32
    # once: at a DC offset of 1e4 a float32 mean is off by a few of its
    # ulps (~1e-3), which moves the maxima by ~1e-3 / 4 relative; the
    # rounded exact mean is off by at most half an ulp
    array, header = simulate_test_data(150.0, nsamples=4096, nchan=32,
                                       signal=2.0, noise=0.2, rng=11)
    array = array.astype(np.float32) + np.float32(1e4 / 32)
    args = (100.0, 200.0, header["fbottom"], header["bandwidth"],
            header["tsamp"])
    table, plane = dedispersion_search(array, *args, device="cpu", show=True)
    plane = plane.numpy()
    assert plane.mean() > 9e3 and plane.std(axis=1).max() < 2.0
    m, s, snr, win, peak = _float64_scores(plane)
    np.testing.assert_array_equal(table["rebin"], win)
    np.testing.assert_array_equal(table["peak"], peak)
    assert table.argbest() == int(np.argmax(snr))
    for ours, truth in ((table["max"], m), (table["std"], s),
                        (table["snr"], snr)):
        np.testing.assert_allclose(ours, truth, rtol=2e-4)


@pytest.mark.parametrize("n", [10, 11, 4096])
def test_median_is_numpys_at_even_and_odd_length(n):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    assert float(trobust.median(torch.from_numpy(x))) == \
        float(jnp.median(jnp.asarray(x)))
    two = x.reshape(2, -1) if n % 2 == 0 else x[:-1].reshape(2, -1)
    np.testing.assert_array_equal(
        trobust.median(torch.from_numpy(two), dim=1).numpy(),
        np.median(two, axis=1))
    # torch.median takes the lower middle value: not what the port uses
    if n % 2 == 0:
        assert float(torch.median(torch.from_numpy(x))) != float(np.median(x))


def test_robust_stats_match_jax():
    x = np.random.default_rng(5).normal(size=1000).astype(np.float32)
    np.testing.assert_allclose(float(trobust.mad(torch.from_numpy(x))),
                               float(jrobust.mad(jnp.asarray(x), xp=jnp)),
                               rtol=RTOL)
    np.testing.assert_allclose(
        float(trobust.ref_mad(torch.from_numpy(x), window=100)),
        float(jrobust.ref_mad(jnp.asarray(x), window=100, xp=jnp)),
        rtol=RTOL)
    np.testing.assert_array_equal(
        trobust.median_filter_1d(torch.from_numpy(x), 11).numpy(),
        np.asarray(jrobust.median_filter_1d(jnp.asarray(x), 11, xp=jnp)))
    prof = np.abs(x[:64]) * 10
    counts = trobust.digitize(torch.from_numpy(prof)).numpy()
    np.testing.assert_array_equal(counts, jrobust.digitize(prof))
    h, m = trobust.h_test(counts, nmax=20)
    jh, jm = jrobust.h_test(counts, nmax=20)
    assert int(m) == int(jm)
    np.testing.assert_allclose(float(h), float(jh), rtol=1e-12)
    np.testing.assert_allclose(float(trobust.z_n_test(counts, 6)),
                               float(jrobust.z_n_test(counts, 6)), rtol=1e-12)


@pytest.fixture(scope="module")
def chunk():
    """A cleaning input: bandpass, a slow baseline drift, a pulse."""
    rng = np.random.default_rng(11)
    nchan, t = 32, 6000
    bandpass = 20.0 + 5.0 * rng.random(nchan)[:, None]
    drift = 1.0 + 0.1 * np.sin(np.arange(t) / 700.0)[None, :]
    data = np.abs(rng.normal(0, 2.0, (nchan, t))) + bandpass * drift
    data[:, 2500] += 15.0
    data[:, 4000:4003] += 60.0            # a broadband outlier
    data += 3.0 * np.sin(np.arange(t) * 2 * np.pi * 0.05)[None, :]
    mask = np.zeros(nchan, bool)
    mask[[3, 20]] = True
    return data.astype(np.float32), mask


@pytest.mark.parametrize("cut_outliers", [False, True])
def test_renormalize_matches_jax(chunk, cut_outliers):
    data, mask = chunk
    ours = tclean.renormalize_data(torch.from_numpy(data),
                                   badchans_mask=torch.from_numpy(mask),
                                   cut_outliers=cut_outliers).numpy()
    ref = np.asarray(jclean.renormalize_data(
        jnp.asarray(data), badchans_mask=jnp.asarray(mask),
        cut_outliers=cut_outliers, xp=jnp))
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, **CLEAN_TOL)
    assert not ours[mask].any()


def test_zero_dm_resample_and_fft_zap_match_jax(chunk):
    data, mask = chunk
    # as the driver runs them: on the renormalised chunk
    renorm = np.array(jclean.renormalize_data(
        jnp.asarray(data), badchans_mask=jnp.asarray(mask), xp=jnp))
    x = torch.from_numpy(renorm)
    np.testing.assert_allclose(
        tclean.zero_dm_filter(x, torch.from_numpy(mask)).numpy(),
        np.asarray(jclean.zero_dm_filter(jnp.asarray(renorm),
                                         jnp.asarray(mask), xp=jnp)),
        **CLEAN_TOL)
    for factor in (2, 7):
        np.testing.assert_allclose(
            quick_resample(x, factor).numpy(),
            np.asarray(jax_quick_resample(jnp.asarray(renorm), factor,
                                          xp=jnp)), **CLEAN_TOL)
    cleaned, zap = tclean.fft_zap_time(torch.from_numpy(renorm))
    jcleaned, jzap = jclean.fft_zap_time(jnp.asarray(renorm), xp=jnp)
    np.testing.assert_array_equal(zap.numpy(), np.asarray(jzap))
    assert zap.any()    # the injected periodic signal is zapped
    np.testing.assert_allclose(cleaned.numpy(), np.asarray(jcleaned),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nsamples, dmmin, dmmax", [(2048, 100, 200),
                                                    (3000, 120, 180)])
def test_search_table_matches_jax_pallas(nsamples, dmmin, dmmax):
    array, header = simulate_test_data(150, nchan=32, nsamples=nsamples,
                                       rng=5)
    array = array.astype(np.float32)
    args = (dmmin, dmmax, header["fbottom"], header["bandwidth"],
            header["tsamp"])
    ours, plane = dedispersion_search(array, *args, device="cpu", show=True)
    ref, ref_plane = jax_search(array, *args, backend="jax",
                                kernel="pallas", capture_plane=True)
    assert ours.colnames == ["DM", "max", "std", "snr", "rebin", "peak"]
    np.testing.assert_array_equal(ours["DM"], ref["DM"])
    np.testing.assert_array_equal(ours["rebin"], ref["rebin"])
    np.testing.assert_array_equal(ours["peak"], ref["peak"])
    assert ours.argbest() == ref.argbest()
    assert np.isclose(ours["DM"][ours.argbest()], 150, atol=1)
    for col in ("max", "std", "snr"):
        np.testing.assert_allclose(ours[col], ref[col], rtol=RTOL)
    assert np.max(np.abs(plane.numpy() - np.asarray(ref_plane))) == 0.0


def test_search_kernel_names():
    array, header = simulate_test_data(150, nchan=16, nsamples=1024, rng=1)
    args = (120, 180., header["fbottom"], header["bandwidth"],
            header["tsamp"])
    a = dedispersion_search(array, *args, kernel="auto", device="cpu")
    b = dedispersion_search(array, *args, kernel="pallas", device="cpu")
    np.testing.assert_array_equal(a["snr"], b["snr"])
    for kernel in ("fdmt", "hybrid", "fourier"):
        table = dedispersion_search(array, *args, kernel=kernel,
                                    device="cpu")
        assert table.nrows and np.isfinite(table["snr"]).all()
    # an inverted DM range gives the FDD an empty grid: an empty table
    table, plane = dedispersion_search(array, 180, 120., *args[2:],
                                       kernel="fourier", show=True,
                                       device="cpu")
    assert table.nrows == 0 and tuple(plane.shape) == (0, 1024)
    # the gather and roll formulations find what the direct sweep finds;
    # roll adds the channels in the sweep's order (its scores equal)
    for kernel in ("gather", "roll"):
        table = dedispersion_search(array, *args, kernel=kernel,
                                    device="cpu")
        for col in ("DM", "rebin", "peak"):
            np.testing.assert_array_equal(table[col], a[col])
        np.testing.assert_allclose(table["snr"], a["snr"], rtol=1e-5)
        if kernel == "roll":
            np.testing.assert_array_equal(table["snr"], a["snr"])
    with pytest.raises(ValueError):
        dedispersion_search(array, *args, kernel="bogus", device="cpu")


def test_inverted_dm_range_gives_an_empty_table():
    array, header = simulate_test_data(150, nchan=16, nsamples=1024, rng=1)
    table, plane = dedispersion_search(
        array, 200, 100., header["fbottom"], header["bandwidth"],
        header["tsamp"], device="cpu", show=True)
    assert table.nrows == 0 and tuple(plane.shape) == (0, 1024)
    assert table["peak"].dtype == np.int64


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from pulsarutils_tpu_torch.pipeline.search_pipeline import \
        search_by_chunks

    array, header = simulate_test_data(150, nchan=16, nsamples=1024, rng=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dedispersion_search(array, 120, 180., header["fbottom"],
                            header["bandwidth"], header["tsamp"])
    with pytest.raises(RuntimeError, match="cuda"):
        search_by_chunks("never-opened.fil", dmmin=100, dmmax=200)


def _counting_score_plane(monkeypatch):
    """Count the calls that reach ``score_cuda.score_plane``."""
    from pulsarutils_tpu_torch.ops import score_cuda

    calls = []
    real = score_cuda.score_plane

    def counting(plane, with_cert=False):
        calls.append((tuple(plane.shape), with_cert))
        return real(plane, with_cert=with_cert)

    monkeypatch.setattr(score_cuda, "score_plane", counting)
    return calls


def test_direct_sweep_scores_through_the_one_pass_scorer(monkeypatch):
    # one scorer on the card: the direct sweep's superblocks go through
    # score_plane (B4 on a CUDA tensor); on the CPU its plain version
    # gives the table score_profiles gave
    from pulsarutils_tpu_torch.ops.dedisperse import dedisperse_plane_plain
    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan, offsets_for
    from pulsarutils_tpu_torch.ops import search as tsearch

    array, header = simulate_test_data(150.0, nsamples=2048, nchan=32,
                                       signal=2.0, noise=0.3, rng=3)
    args = (100.0, 200.0, header["fbottom"], header["bandwidth"],
            header["tsamp"])
    monkeypatch.setattr(tsearch, "SUPERBLOCK", 40)
    calls = _counting_score_plane(monkeypatch)
    table = dedispersion_search(array, *args, device="cpu")
    dms = dedispersion_plan(32, *args)
    assert [c[0][0] for c in calls] == [40] * (len(dms) // 40) \
        + ([len(dms) % 40] if len(dms) % 40 else [])
    assert not any(c[1] for c in calls)
    plane = dedisperse_plane_plain(
        torch.from_numpy(array.astype(np.float32)),
        offsets_for(dms, 32, *args[2:], 2048))
    for name, col in zip(("max", "std", "snr", "rebin", "peak"),
                         score_profiles(plane)):
        np.testing.assert_array_equal(table[name], col.numpy())
        assert table[name].dtype == col.numpy().dtype


def test_hybrid_rescore_scores_through_the_one_pass_scorer(monkeypatch):
    array, header = simulate_test_data(150.0, nsamples=2048, nchan=32,
                                       signal=2.0, noise=0.3, rng=4)
    args = (100.0, 200.0, header["fbottom"], header["bandwidth"],
            header["tsamp"])
    calls = _counting_score_plane(monkeypatch)
    table = dedispersion_search(array, *args, kernel="hybrid",
                                device="cpu")
    # the coarse plane with the certificate row, then one call per
    # rescore bucket (8, 16 or 32 trials)
    assert calls[0][1] and not any(c[1] for c in calls[1:])
    assert len(calls) > 1
    assert all(c[0][0] in (8, 16, 32) for c in calls[1:])
    best = table.argbest()
    assert table["exact"][best] and abs(table["DM"][best] - 150.0) < 1.5
    exact = dedispersion_search(array, *args, device="cpu")
    rows = np.flatnonzero(table["exact"])
    for name in ("max", "std", "snr", "rebin", "peak"):
        np.testing.assert_array_equal(table[name][rows], exact[name][rows])


def test_direct_sweep_offsets_are_computed_once_per_geometry():
    # the float64 shift table is built once per (trial grid, geometry, T)
    # and handed out read-only; a new T or grid builds a new one
    from pulsarutils_tpu_torch.ops import search as tsearch
    from pulsarutils_tpu_torch.ops.plan import dedispersion_plan, offsets_for

    array, header = simulate_test_data(150.0, nsamples=2048, nchan=32,
                                       signal=2.0, noise=0.3, rng=5)
    args = (100.0, 200.0, header["fbottom"], header["bandwidth"],
            header["tsamp"])
    tsearch._direct_sweep.cache_clear()
    first = dedispersion_search(array, *args, device="cpu")
    again = dedispersion_search(array, *args, device="cpu")
    info = tsearch._direct_sweep.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    for name in ("DM", "max", "std", "snr", "rebin", "peak"):
        np.testing.assert_array_equal(first[name], again[name])
    dms = dedispersion_plan(32, *args)
    cached = tsearch._direct_sweep(dms.tobytes(), 32, *map(float, args[2:]),
                                   2048, tsearch.SUPERBLOCK,
                                   torch.device("cpu"))
    assert all(not rows.flags.writeable and planned is None
               for rows, planned in cached)
    np.testing.assert_array_equal(np.concatenate([r for r, _ in cached]),
                                  offsets_for(dms, 32, *args[2:], 2048))
    dedispersion_search(array[:, :1024], *args, device="cpu")
    assert tsearch._direct_sweep.cache_info().misses == 2
