"""The FDAS acceleration backend (``accel_backend="fdas"``): the port's
copies of the template bank and the backends' equivalence check equal the
JAX package's; ``fdas_search(device="cpu")`` equals the JAX package's
jitted ``fdas_search`` on the same plane (discrete fields equal, sigma
within rel 1e-5: both correlate in complex64, with their own FFT and
summation order; on this plane they differ by ~7e-7); the time-stretch
and FDAS backends recover the same injected jerked cell; the periodicity
job and its CLI run with it."""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pulsarutils_tpu.io.sigproc import \
    write_simulated_filterbank as jax_write_filterbank
from pulsarutils_tpu.models.simulate import \
    simulate_accel_pulsar_data as jax_simulate_accel
from pulsarutils_tpu.ops import zresponse as jz
from pulsarutils_tpu.periodicity.accel import C_M_S as JAX_C_M_S
from pulsarutils_tpu.periodicity.driver import \
    periodicity_search as jax_periodicity_search
from pulsarutils_tpu.periodicity.fdas import _band_slice as jax_band_slice
from pulsarutils_tpu.periodicity.fdas import fdas_search as jax_fdas_search
from pulsarutils_tpu.pipeline.search_pipeline import \
    plan_survey as jax_plan_survey
from pulsarutils_tpu.tuning import autotune as jtune

from pulsarutils_tpu_torch.cli import period_main
from pulsarutils_tpu_torch.obs.metrics import REGISTRY
from pulsarutils_tpu_torch.ops import zresponse as tz
from pulsarutils_tpu_torch.periodicity import fdas as tfdas
from pulsarutils_tpu_torch.periodicity import fdas_search
from pulsarutils_tpu_torch.periodicity.accel import C_M_S, accel_search
from pulsarutils_tpu_torch.periodicity.driver import periodicity_search
from pulsarutils_tpu_torch.pipeline.search_pipeline import plan_survey
from pulsarutils_tpu_torch.tuning import autotune as ttune

torch.set_num_threads(1)

TSAMP = 0.0005
NSAMPLES = 16384
NDM = 6
K0 = int(round(0.175 * NSAMPLES))
F0 = K0 / (NSAMPLES * TSAMP)
ACCELS = np.linspace(-2.0e5, 2.0e5, 9)
JERKS = np.linspace(-5.0e4, 5.0e4, 5)
#: synthetic_accel_plane injects at DM row ndm // 3
INJ_DM, INJ_A, INJ_J = NDM // 3, 6, 3
KW = dict(jerks=JERKS, max_harmonics=1, fmax=1.25 * F0, topk=8)
SIGMA_RTOL = 1e-5
DISCRETE = ("dm_index", "accel_index", "jerk_index", "freq_bin", "nharm")


def _counter(name):
    return sum(r["value"] for r in REGISTRY.snapshot() if r["name"] == name)


@pytest.fixture(scope="module")
def plane():
    return ttune.synthetic_accel_plane(NDM, NSAMPLES, TSAMP, ACCELS[INJ_A],
                                       jerk=JERKS[INJ_J])


@pytest.fixture(scope="module")
def ours(plane):
    return fdas_search(plane, TSAMP, ACCELS, device="cpu", **KW)


def _assert_tables_equal(ours, ref, rtol=SIGMA_RTOL):
    for k in DISCRETE:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    for k in ("accel", "jerk"):
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    for k in ("sigma", "power", "freq", "log_sf"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=rtol, err_msg=k)


# ---------------------------------------------------------------------------
# Host tables
# ---------------------------------------------------------------------------

def test_speed_of_light_pinned():
    assert tz._C_M_S == C_M_S == JAX_C_M_S == jz._C_M_S


def test_fresnel_and_responses_equal_jax():
    x = np.linspace(-9.0, 9.0, 401)
    for a, b in zip(tz.fresnel(x), jz.fresnel(x)):
        np.testing.assert_array_equal(a, b)
    q = np.arange(-30, 31)
    for z in (0.0, 5e-4, 2e-3, -3.5, 37.3):
        np.testing.assert_array_equal(tz.z_response(z, q.astype(float)),
                                      jz.z_response(z, q.astype(float)))
    for z, w in ((3.0, 10.0), (-7.0, -40.0)):
        np.testing.assert_array_equal(tz.zw_response(z, w, q),
                                      jz.zw_response(z, w, q))
    for a, b in zip(tz.response_bank([0.0, 2.0, -5.0], [0.0, 8.0], 12),
                    jz.response_bank([0.0, 2.0, -5.0], [0.0, 8.0], 12)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tz.response_bank_pairs([0.0, 2.0], [0.0, 8.0], 12),
                    jz.response_bank_pairs([0.0, 2.0], [0.0, 8.0], 12)):
        np.testing.assert_array_equal(a, b)
    assert tz.MAX_HALF_WIDTH == jz.MAX_HALF_WIDTH
    assert tz.Z_SMALL == jz.Z_SMALL
    with pytest.raises(ValueError, match="integer"):
        tz.zw_response(3.0, 10.0, np.array([0.5]))


@pytest.mark.parametrize("accels, jerks, nbins", [
    ((0.0,), (0.0,), 64),
    (tuple(np.repeat(ACCELS, 5)), tuple(np.tile(JERKS, 9)), 3000),
    ((-1e5, 0.0, 1e5), (0.0, 0.0, 0.0), 8193)])
def test_bank_for_trials_equals_jax(accels, jerks, nbins):
    ours = tz.bank_for_trials(accels, jerks, nbins, TSAMP, NSAMPLES)
    ref = jz.bank_for_trials(accels, jerks, nbins, TSAMP, NSAMPLES)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_bank_half_width_cap_warns():
    with pytest.warns(UserWarning, match="half-width"):
        tab = tz.bank_for_trials((5.0e6,), (0.0,), 8193, TSAMP, NSAMPLES)
    assert tab["half_width"] == tz.MAX_HALF_WIDTH


def test_band_slice_equals_jax():
    t_accels = np.repeat(ACCELS, 5)
    t_jerks = np.tile(JERKS, 9)
    for fmax, h in ((None, 16), (1.25 * F0, 1), (100.0, 16), (900.0, 4)):
        assert tfdas._band_slice(NSAMPLES // 2 + 1, NSAMPLES, TSAMP, fmax, h,
                                 t_accels, t_jerks) \
            == jax_band_slice(NSAMPLES // 2 + 1, NSAMPLES, TSAMP, fmax, h,
                              t_accels, t_jerks)


def test_equivalence_check_and_probe_plane_equal_jax():
    assert ttune.ACCEL_SIGMA_RTOL == jtune.ACCEL_SIGMA_RTOL
    np.testing.assert_array_equal(
        ttune.synthetic_accel_plane(5, 2048, TSAMP, 1e5, jerk=2e4),
        jtune.synthetic_accel_plane(5, 2048, TSAMP, 1e5, jerk=2e4))

    def table(**kw):
        base = {"dm_index": np.array([2]), "accel_index": np.array([6]),
                "jerk_index": np.array([3]), "nharm": np.array([1]),
                "freq": np.array([350.0]), "sigma": np.array([30.0])}
        base.update({k: np.array([v]) for k, v in kw.items()})
        return base

    for cand in (table(), table(sigma=31.0), table(sigma=40.0),
                 table(accel_index=5), table(freq=350.01), table(nharm=2),
                 {"sigma": np.array([])}, None):
        assert ttune.accel_tables_match(table(), cand) \
            == jtune.accel_tables_match(table(), cand)


# ---------------------------------------------------------------------------
# fdas_search against the JAX package's
# ---------------------------------------------------------------------------

def test_fdas_search_equals_jax(plane, ours):
    ref = jax_fdas_search(plane, TSAMP, ACCELS, xp=jnp, **KW)
    _assert_tables_equal(ours, ref)


def test_fdas_search_full_band_equals_jax(plane):
    # no fmax: the whole spectrum and wider templates; two rows, the
    # three middle accelerations
    kw = dict(max_harmonics=4, topk=6)
    ours = fdas_search(plane[1:3], TSAMP, ACCELS[3:6], device="cpu", **kw)
    ref = jax_fdas_search(plane[1:3], TSAMP, ACCELS[3:6], xp=jnp, **kw)
    _assert_tables_equal(ours, ref)


@pytest.mark.parametrize("budget", [8 * 17 * 6, 8 * 17 * 2, 8 * 17 * 6 * 5])
def test_correlation_blocks_equal_one_block(budget, monkeypatch):
    """The blocked correlation (rows and bins) equals one whole block."""
    gen = torch.Generator().manual_seed(0)
    spec_t = torch.randn(300, NDM, dtype=torch.complex64, generator=gen)
    filt = torch.randn(7, 17, dtype=torch.complex64, generator=gen)
    gidx = torch.randint(-20, 320, (300,), generator=gen, dtype=torch.int32)
    tidx = torch.randint(0, 7, (300,), generator=gen, dtype=torch.int32)
    assert tfdas._blocks(NDM, 300, 17) == (NDM, 300)
    whole = tfdas.correlate(spec_t, filt, gidx, tidx)
    monkeypatch.setattr(tfdas, "WINDOW_BYTES", budget)
    assert tfdas._blocks(NDM, 300, 17) != (NDM, 300)
    blocked = tfdas.correlate(spec_t, filt, gidx, tidx)
    torch.testing.assert_close(blocked, whole, rtol=0, atol=0)
    # the window's taps outside the spectrum are zero, not wrapped
    cols = gidx[:, None].long() + torch.arange(17) - 8
    taps = filt[tidx.long()] * ((cols >= 0) & (cols < 300))
    ref = (spec_t[cols.clamp(0, 299)] * taps[..., None]).sum(dim=1)
    torch.testing.assert_close(whole, ref, rtol=1e-5, atol=1e-4)


def test_zero_trial_is_plain_spectral_scoring(plane):
    kw = dict(max_harmonics=4, fmin=4.0 / (NSAMPLES * TSAMP), topk=8,
              device="cpu")
    p32 = np.asarray(plane, dtype=np.float32)
    t_f = fdas_search(p32, TSAMP, [0.0], **kw)
    t_s = accel_search(p32, TSAMP, [0.0], **kw)
    for k in DISCRETE:
        np.testing.assert_array_equal(t_f[k], t_s[k], err_msg=k)
    for k in ("freq", "power", "log_sf", "sigma"):
        np.testing.assert_allclose(t_f[k], t_s[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_both_backends_recover_the_jerked_cell(plane, ours):
    stretch = accel_search(plane, TSAMP, ACCELS, device="cpu", **KW)
    for name, tbl in (("time_stretch", stretch), ("fdas", ours)):
        assert int(tbl["dm_index"][0]) == INJ_DM, name
        assert int(tbl["accel_index"][0]) == INJ_A, name
        assert int(tbl["jerk_index"][0]) == INJ_J, name
        assert abs(int(tbl["freq_bin"][0]) - K0) <= 1, name
    assert ttune.accel_tables_match(stretch, ours)


def test_fdas_metrics_tick(plane):
    t0 = _counter("putpu_fdas_trials_total")
    b0 = _counter("putpu_fdas_bank_entries_total")
    fdas_search(plane[:2], TSAMP, np.array([0.0, ACCELS[INJ_A]]),
                max_harmonics=1, fmax=1.25 * F0, topk=4, device="cpu")
    assert _counter("putpu_fdas_trials_total") == t0 + 4
    assert _counter("putpu_fdas_bank_entries_total") > b0


def test_fdas_search_on_the_card_needs_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU contract does not apply")
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        fdas_search(np.zeros((2, 64), np.float32), TSAMP, [0.0])


# ---------------------------------------------------------------------------
# The periodicity job with accel_backend="fdas"
# ---------------------------------------------------------------------------

E2E_TSAMP, E2E_NSAMPLES, E2E_NCHAN = 0.0005, 16384, 32
E2E_DM = 150.0
E2E_F0 = 492 / (E2E_NSAMPLES * E2E_TSAMP)
#: the JAX package's jerked binary, searched on a 3 x 3 grid whose
#: corner is the injected cell, over a narrower DM range
E2E_ACCEL, E2E_JERK = 4.5e5, 4.4e5
JOB = dict(dmmin=140.0, dmmax=160.0, accel_max=E2E_ACCEL, n_accel=3,
           jerk_max=E2E_JERK, n_jerk=3, sigma_threshold=8.0,
           chunk_length=4096 * E2E_TSAMP, snr_threshold=8.0,
           accel_backend="fdas")


@pytest.fixture(scope="module")
def jerk_pulsar_file(tmp_path_factory):
    arr, hdr = jax_simulate_accel(
        freq=E2E_F0, dm=E2E_DM, accel=E2E_ACCEL, jerk=E2E_JERK,
        tsamp=E2E_TSAMP, nsamples=E2E_NSAMPLES, nchan=E2E_NCHAN, rng=17)
    path = tmp_path_factory.mktemp("jerkpsr") / "jerky.fil"
    jax_write_filterbank(str(path), arr, hdr, descending=True)
    return str(path)


def _cands(res):
    return [(c["dm"], c["accel"], c["jerk"], c["freq_bin"], c["nharm"])
            for c in res["candidates"]]


def test_periodicity_job_fdas_equals_jax_driver(jerk_pulsar_file, tmp_path):
    ref = jax_periodicity_search(jerk_pulsar_file,
                                 output_dir=str(tmp_path / "j"),
                                 progress=False, **JOB)
    res = periodicity_search(jerk_pulsar_file, output_dir=str(tmp_path / "t"),
                             device="cpu", **JOB)
    assert res["complete"] and ref["complete"]
    assert res["accel_backend"] == ref["accel_backend"] == "fdas"
    # both drivers fold the same keys into the fingerprint (the port's
    # names its own backend, so the digests themselves differ)
    extra = {"workload": "periodicity", "accel_max": E2E_ACCEL,
             "jerk_max": E2E_JERK}
    survey = dict(dmmin=JOB["dmmin"], dmmax=JOB["dmmax"],
                  chunk_length=JOB["chunk_length"], snr_threshold=8.0,
                  fingerprint_extra=extra)
    assert res["fingerprint"] == plan_survey(jerk_pulsar_file,
                                             **survey)["fingerprint"]
    assert ref["fingerprint"] == jax_plan_survey(jerk_pulsar_file,
                                                 **survey)["fingerprint"]
    assert _cands(res) == _cands(ref) and res["candidates"]
    np.testing.assert_allclose([c["sigma"] for c in res["candidates"]],
                               [c["sigma"] for c in ref["candidates"]],
                               rtol=1e-4)
    best = res["candidates"][0]
    assert best["accel"] == E2E_ACCEL and best["jerk"] == E2E_JERK
    assert abs(best["freq_bin"] - 492) <= 1
    # the candidate file records the backend and the jerk axis
    from pulsarutils_tpu.periodicity.candidates import load_candidates

    _, meta = load_candidates(res["candidates_path"])
    assert meta["accel_backend"] == "fdas" and meta["n_jerk"] == 3
    assert meta["jerk_max"] == E2E_JERK


def test_period_cli_runs_fdas(jerk_pulsar_file, tmp_path, capsys):
    rc = period_main.main([jerk_pulsar_file, "--dmmin", "140", "--dmmax",
                           "160", "--accel-max", str(E2E_ACCEL),
                           "--n-accel", "3", "--jerk-max",
                           str(E2E_JERK), "--n-jerk", "3",
                           "--accel-backend", "fdas", "--chunk-length",
                           "2.048", "--snr-threshold", "8", "--output-dir",
                           str(tmp_path), "--device", "cpu", "--json"])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert lines and abs(lines[0]["freq_bin"] - 492) <= 1
    assert lines[0]["jerk"] == E2E_JERK
    assert list(tmp_path.glob("period_cands_*.npz"))
