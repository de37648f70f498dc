"""The hybrid and FDMT searches: the port's copies of the certificate host
math equal the JAX package's; its guarantee loop asks for the same
rescores; ``dedispersion_search(kernel="hybrid"|"fdmt", device="cpu")``
equals the JAX package's CPU search (argbest, DM, rebin, peak, the
``exact`` column and the certificate meta equal, snr within rel 1e-5) on a
pulse chunk, a noise chunk certified at the certifiable floor and a floor
below it; ``search_by_chunks(kernel="hybrid")`` equals the JAX driver."""
import json
import logging
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pulsarutils_tpu.ops import certify as jcert
from pulsarutils_tpu.ops import search as jsearch
from pulsarutils_tpu.ops.fdmt import fdmt_transform as jax_fdmt_transform
from pulsarutils_tpu.ops.fdmt import fdmt_trial_dms as jax_fdmt_trial_dms
from pulsarutils_tpu.pipeline.search_pipeline import \
    plan_survey as jax_plan_survey
from pulsarutils_tpu.pipeline.search_pipeline import \
    search_by_chunks as jax_search_by_chunks

from pulsarutils_tpu_torch.io.sigproc import write_simulated_filterbank
from pulsarutils_tpu_torch.models.simulate import simulate_test_data
from pulsarutils_tpu_torch.ops import certify as tcert
from pulsarutils_tpu_torch.ops import search as tsearch
from pulsarutils_tpu_torch.ops.plan import (dedispersion_plan,
                                            dedispersion_shifts)
from pulsarutils_tpu_torch.pipeline.search_pipeline import (plan_survey,
                                                            search_by_chunks)

torch.set_num_threads(1)

GEOM = (1200.0, 200.0, 5e-4)
RTOL = 1e-5


@pytest.fixture(autouse=True)
def static_jax_kernel(monkeypatch):
    # the JAX rescore resolves its direct-sweep formulation through the
    # autotuner; the static choice keeps its runs deterministic
    monkeypatch.setenv("PUTPU_AUTOTUNE", "off")


# ---------------------------------------------------------------------------
# Host math
# ---------------------------------------------------------------------------

def test_certificate_scalars_equal_jax():
    for p in (0.5, 0.3, 0.1, 1e-3):
        assert tcert.cert_slack_for_miss_p(p) == jcert.cert_slack_for_miss_p(p)
    for slack in (None, 0.0, 0.5, 3.1):
        assert tcert.cert_miss_p_at_floor(slack) == \
            jcert.cert_miss_p_at_floor(slack)
    for args in ((True, 0.6, 12.0, None), (False, 0.6, None, 0.7),
                 (False, None, 8.0, None)):
        assert tcert.cert_meta(*args) == jcert.cert_meta(*args)
    for t, ndm in ((2048, 1), (4096, 154), (1 << 18, 514), (1 << 20, 512)):
        assert tcert.expected_noise_max_snr(t, ndm) == \
            jcert.expected_noise_max_snr(t, ndm)
        assert tcert.matched_snr_floor(t, ndm) == \
            jcert.matched_snr_floor(t, ndm)
        assert tcert.certifiable_snr_floor(t, ndm, 0.61) == \
            jcert.certifiable_snr_floor(t, ndm, 0.61)
    rng = np.random.default_rng(0)
    for _ in range(5):
        cert, coarse = rng.normal(3, 1, 50), rng.normal(3, 1, 50)
        for floor in (None, 6.0, 9.0):
            assert tcert.certify_noise_only(cert, floor, 0.6, coarse) == \
                jcert.certify_noise_only(cert, floor, 0.6, coarse)
        offsets = rng.integers(-3, 4, 64)
        assert tcert._retention_from_offsets(offsets, min_width=2) == \
            jcert._retention_from_offsets(offsets, min_width=2)
        assert tcert._cert_retention_from_offsets(offsets) == \
            jcert._cert_retention_from_offsets(offsets)
    with pytest.raises(ValueError):
        tcert.cert_slack_for_miss_p(1.5)


@pytest.mark.parametrize("nchan, dmmin, dmmax, f0, bw, tsamp, t", [
    (32, 100.0, 200.0, 1200.0, 200.0, 5e-4, 2048),
    (64, 300.0, 400.0, 1200.0, 200.0, 5e-4, 4096),
    (24, 5.0, 10.0, 110.0, 60.0, 1e-3, 8192),
])
def test_retention_bounds_equal_jax(nchan, dmmin, dmmax, f0, bw, tsamp, t):
    dms = dedispersion_plan(nchan, dmmin, dmmax, f0, bw, tsamp)
    args = (nchan, dms, f0, bw, tsamp, t)
    np.testing.assert_array_equal(tcert.cert_retention(*args),
                                  jcert.cert_retention(*args))
    np.testing.assert_array_equal(tcert.coarse_retention(*args),
                                  jcert.coarse_retention(*args))
    assert tcert.retention_bound(*args, cert=True) == \
        jcert.retention_bound(*args, cert=True)
    np.testing.assert_array_equal(tcert._track_deviations(*args),
                                  jcert._track_deviations(*args))


def test_rescore_helpers_equal_jax():
    rng = np.random.default_rng(1)
    grid = np.sort(rng.uniform(100, 200, 60))
    targets = rng.uniform(95, 205, 80)
    np.testing.assert_array_equal(tsearch.nearest_rows(grid, targets),
                                  jsearch.nearest_rows(grid, targets))
    for n in (1, 7, 8, 9, 33, 70):
        rows = np.arange(n) * 3
        ours = list(tsearch.iter_rescore_buckets(rows))
        ref = list(jsearch.iter_rescore_buckets(rows))
        assert len(ours) == len(ref)
        for (a, pa), (b, pb) in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(pa, pb)
    assert tsearch.HYBRID_RESCORE_BUCKETS == jsearch.HYBRID_RESCORE_BUCKETS
    assert tsearch.HYBRID_MAX_ROUNDS == jsearch.HYBRID_MAX_ROUNDS
    assert tsearch.HYBRID_COARSE_TRUST == jsearch.HYBRID_COARSE_TRUST
    assert tsearch.CERT_WINDOWS == jsearch.CERT_WINDOWS
    assert tcert.HYBRID_CERT_SLACK == jcert.HYBRID_CERT_SLACK


def _loop_calls(module, seed, **kwargs):
    """The rescore requests one guarantee loop makes on synthetic scores."""
    rng = np.random.default_rng(seed)
    truth = rng.normal(5, 1, 120)
    truth[40] += 6.0
    coarse = truth * rng.uniform(0.6, 1.0, 120)
    cert = coarse * 0.9
    snrs, exact = coarse.copy(), np.zeros(120, bool)
    calls = []

    def rescore(rows):
        calls.append(np.asarray(rows).tolist())
        snrs[rows] = truth[rows]
        exact[rows] = True

    if kwargs.pop("cert", False):
        kwargs.update(cert_scores=cert, rho_cert=0.6)
    module.hybrid_guarantee_loop(coarse, snrs, exact, rescore, **kwargs)
    return calls, exact


@pytest.mark.parametrize("kwargs", [{}, {"snr_floor": 7.0}, {"cert": True},
                                    {"cert": True, "snr_floor": 7.0},
                                    {"cert": True, "cert_slack": 2.0}])
def test_guarantee_loop_requests_the_same_rescores(kwargs):
    for seed in (0, 1, 2):
        ours, ours_exact = _loop_calls(tsearch, seed, **dict(kwargs))
        ref, ref_exact = _loop_calls(jsearch, seed, **dict(kwargs))
        assert ours == ref and ours
        np.testing.assert_array_equal(ours_exact, ref_exact)


# ---------------------------------------------------------------------------
# dedispersion_search against the JAX package's CPU search
# ---------------------------------------------------------------------------

def _chunk(kind, nchan=32, t=4096, seed=3):
    """A renormalised chunk, as the driver searches it: |N(0,1)| / 2 with
    an impulse dispersed at DM 150 ("pulse"), or without ("noise")."""
    rng = np.random.default_rng(seed)
    arr = np.abs(rng.standard_normal((nchan, t), dtype=np.float32)) * 0.5
    if kind == "pulse":
        arr[:, t // 2] += 1.5
        shifts = np.rint(dedispersion_shifts(nchan, 150.0, *GEOM)).astype(int)
        for c in range(nchan):
            arr[c] = np.roll(arr[c], shifts[c] % t)
    arr = (arr - arr.mean(1, keepdims=True)) / arr.std(1, keepdims=True)
    return arr.astype(np.float32)


def _certifiable_floor(nchan, t, dmmin=100.0, dmmax=200.0):
    dms = dedispersion_plan(nchan, dmmin, dmmax, *GEOM)
    rho = tcert.retention_bound(nchan, dms, GEOM[0], GEOM[1], GEOM[2], t,
                                cert=True)
    return tcert.certifiable_snr_floor(t, len(dms), rho)


def _assert_tables_equal(ours, ref, hybrid=True):
    assert ours.colnames == ref.colnames
    assert ours.argbest() == ref.argbest()
    for col in ("DM", "rebin", "peak") + (("exact",) if hybrid else ()):
        np.testing.assert_array_equal(ours[col], ref[col], err_msg=col)
    for col in ("snr", "max", "std") + (("cert",) if hybrid else ()):
        np.testing.assert_allclose(ours[col], ref[col], rtol=RTOL,
                                   err_msg=col)
    assert ours.meta == ref.meta


@pytest.mark.parametrize("case", ["pulse", "pulse_floor", "noise_certified",
                                  "noise_floor_below_certifiable"])
def test_hybrid_matches_jax(case):
    data = _chunk("pulse" if case.startswith("pulse") else "noise")
    kwargs = {}
    if case == "pulse_floor":
        kwargs["snr_floor"] = 8.0
    elif case == "noise_certified":
        kwargs["snr_floor"] = round(_certifiable_floor(32, 4096), 2)
    elif case == "noise_floor_below_certifiable":
        kwargs["snr_floor"] = 6.0
    args = (100.0, 200.0, *GEOM)
    ours = tsearch.dedispersion_search(data, *args, kernel="hybrid",
                                       device="cpu", **kwargs)
    ref = jsearch.dedispersion_search(data, *args, backend="jax",
                                      kernel="hybrid", **kwargs)
    _assert_tables_equal(ours, ref)
    assert ours.meta["certified"] == (case == "noise_certified")
    if case.startswith("pulse"):
        best = ours.best_row()
        assert best["exact"] and abs(best["DM"] - 150.0) < 1.0
    if case == "noise_floor_below_certifiable":
        # every row that could hold an above-floor detection is exact
        assert ours["exact"].sum() > ours.nrows // 2


def test_fdmt_search_matches_jax():
    data = _chunk("pulse")
    args = (100.0, 200.0, *GEOM)
    ours, plane = tsearch.dedispersion_search(data, *args, kernel="fdmt",
                                              device="cpu", show=True)
    ref = jsearch.dedispersion_search(data, *args, backend="jax",
                                      kernel="fdmt")
    _assert_tables_equal(ours, ref, hybrid=False)
    _, lo, hi = jax_fdmt_trial_dms(32, *args)
    ref_plane = np.asarray(jax_fdmt_transform(data, hi, GEOM[0], GEOM[1],
                                              use_pallas=False,
                                              min_delay=lo))
    assert np.max(np.abs(plane.numpy() - ref_plane)) == 0.0
    # an explicit grid only bounds the DM range
    again = tsearch.dedispersion_search(data, *args, kernel="fdmt",
                                        device="cpu",
                                        trial_dms=ours["DM"][3:-3])
    assert again.nrows <= ours.nrows - 4


def test_hybrid_captures_the_coarse_plane_on_the_plan_rows():
    data = _chunk("pulse")
    args = (100.0, 200.0, *GEOM)
    table, plane = tsearch.dedispersion_search(data, *args, kernel="hybrid",
                                               device="cpu", show=True)
    coarse_dms, lo, hi = jax_fdmt_trial_dms(32, *args)
    idx = jsearch.nearest_rows(coarse_dms, table["DM"])
    ref = np.asarray(jax_fdmt_transform(data, hi, GEOM[0], GEOM[1],
                                        use_pallas=False, min_delay=lo))
    assert plane.shape == (table.nrows, 4096)
    assert np.max(np.abs(plane.numpy() - ref[idx])) == 0.0


def test_rho_cert_false_drops_to_the_legacy_margins():
    data = _chunk("pulse")
    args = (100.0, 200.0, *GEOM)
    ours = tsearch.dedispersion_search(data, *args, kernel="hybrid",
                                       device="cpu", rho_cert=False)
    ref = jsearch.dedispersion_search(data, *args, backend="jax",
                                      kernel="hybrid", rho_cert=False)
    _assert_tables_equal(ours, ref)
    assert ours.meta["rho_cert"] is None


# ---------------------------------------------------------------------------
# search_by_chunks against the JAX driver
# ---------------------------------------------------------------------------

PULSE_DM = 150.0
NSAMPLES = 16384
SEARCH = dict(dmmin=100.0, dmmax=200.0, chunk_length=1.024)


@pytest.fixture(scope="module")
def pulse_file(tmp_path_factory):
    array, header = simulate_test_data(PULSE_DM, nsamples=NSAMPLES, nchan=32,
                                       signal=10.0, noise=4.0, rng=7)
    path = tmp_path_factory.mktemp("hybrid") / "pulse.fil"
    write_simulated_filterbank(str(path), array + 20.0, header,
                               descending=True, nbits=8)
    return str(path)


@pytest.mark.parametrize("threshold", ["certifiable", "auto", 6.0])
def test_plan_survey_resolves_floors_as_jax(pulse_file, threshold):
    ours = plan_survey(pulse_file, kernel="hybrid", snr_threshold=threshold,
                       **SEARCH)
    ref = jax_plan_survey(pulse_file, kernel="hybrid",
                          snr_threshold=threshold, **SEARCH)
    assert ours["snr_threshold"] == ref["snr_threshold"]
    assert ours["search_snr_floor"] == ref["search_snr_floor"]
    assert ours["chunk_starts"] == ref["chunk_starts"]
    forced = plan_survey(pulse_file, kernel="hybrid", snr_threshold=6.0,
                         exact_floor=True, **SEARCH)
    assert forced["search_snr_floor"] == 6.0
    with pytest.raises(ValueError, match="exact_floor"):
        plan_survey(pulse_file, exact_floor=1, **SEARCH)
    with pytest.raises(ValueError, match="snr_threshold"):
        plan_survey(pulse_file, snr_threshold="loose", **SEARCH)


def test_search_by_chunks_hybrid_matches_jax_driver(pulse_file, tmp_path,
                                                    caplog):
    kw = dict(kernel="hybrid", snr_threshold="certifiable", **SEARCH)
    with caplog.at_level(logging.INFO, logger="pulsarutils_tpu"):
        ref_hits, ref_store = jax_search_by_chunks(
            pulse_file, backend="jax", make_plots=False,
            output_dir=str(tmp_path / "jax"), **kw)
    found = re.findall(r"(\d+) noise-certified", caplog.text)
    summary = {}
    hits, store = search_by_chunks(pulse_file, device="cpu",
                                   output_dir=str(tmp_path / "torch"),
                                   summary=summary, **kw)
    assert hits, "the injected pulse was not found"
    assert [(h[0], h[1]) for h in hits] == [(h[0], h[1]) for h in ref_hits]
    for (_, _, info, table), (_, _, rinfo, rtable) in zip(hits, ref_hits):
        best, rbest = table.best_row(), rtable.best_row()
        for col in ("DM", "rebin", "peak", "exact"):
            assert best[col] == rbest[col]
        np.testing.assert_allclose(best["snr"], rbest["snr"], rtol=RTOL)
        np.testing.assert_array_equal(table["exact"], rtable["exact"])
        assert info.dm == rinfo.dm and info.width == rinfo.width
    assert store.done_chunks == ref_store.done_chunks
    ledger = json.loads(Path(store._ledger_path).read_text())
    assert ledger["done"] == ref_store.done_chunks
    assert summary["searched"] == len(store.done_chunks)
    assert summary["snr_floor"] == summary["snr_threshold"]
    assert found and int(found[-1]) == summary["certified"] > 0
