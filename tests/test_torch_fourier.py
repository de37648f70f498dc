"""The port's Fourier-domain dedispersion against the JAX package's: the
host limb tables, the rotate-accumulate recurrence against the Pallas
kernel in interpret mode, B5's fused plain version (spectrum + limbs)
against the composition it replaces, the planes against the float64
oracle, and ``kernel="fourier"`` through the search façade, the chunk pipeline
and the CLI."""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pulsarutils_tpu.ops import fourier as jf
from pulsarutils_tpu.ops.fourier_pallas import \
    fdd_superblock_spectra as jax_fdd_superblock_spectra
from pulsarutils_tpu.ops.search import dedispersion_search as jax_search

from pulsarutils_tpu_torch.ops import fourier as tf
from pulsarutils_tpu_torch.ops import fourier_cuda
from pulsarutils_tpu_torch.ops.search import dedispersion_search
from pulsarutils_tpu_torch.models.simulate import simulate_test_data
from pulsarutils_tpu_torch.utils import nvcc

torch.set_num_threads(1)

GEOM = (1200.0, 200.0, 0.0005)
#: the JAX package's own tolerance between its FDD paths and the float64
#: oracle, on unit-normal data (tests/test_fourier.py)
ORACLE_ATOL = 2e-3
#: plain B5 against the Pallas kernel: float32 sums of the same terms in
#: another channel order (the JAX package's unit test allows 2e-4)
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("nchan, t, dms", [
    (32, 4096, np.linspace(50, 400, 9)),
    (1000, 1 << 20, np.linspace(300, 635, 514)),
    (7, 513, np.array([123.4])),
])
def test_limb_tables_equal_jax(nchan, t, dms):
    np.testing.assert_array_equal(
        tf.fractional_delays(dms, nchan, *GEOM[:2]),
        jf.fractional_delays(dms, nchan, *GEOM[:2]))
    delays = tf.fractional_delays(dms, nchan, *GEOM[:2])
    np.testing.assert_array_equal(tf._phase_limbs(delays, GEOM[2], t),
                                  jf._phase_limbs(delays, GEOM[2], t))
    np.testing.assert_array_equal(tf._step_limbs(delays[0], GEOM[2], t),
                                  jf._step_limbs(delays[0], GEOM[2], t))
    step = tf._uniform_spacing(dms)
    assert step == jf._uniform_spacing(dms)
    for ours, theirs in zip(
            tf._uniform_fourier_inputs(dms, step, nchan, *GEOM, t, 64),
            jf._uniform_fourier_inputs(dms, step, nchan, *GEOM, t, 64)):
        np.testing.assert_array_equal(ours, theirs)


def test_limb_products_in_int64_equal_wrapping_int32():
    # k * limb masked: the int64 products the port forms equal the JAX
    # package's wrapping int32 products after the mask, wrap or not
    rng = np.random.default_rng(0)
    k = np.arange(0, 1 << 25, 4099, dtype=np.int64)
    limb = rng.integers(0, 1 << 12, 64).astype(np.int64)
    prod64 = k[:, None] * limb[None, :]
    prod32 = (k[:, None].astype(np.int32) * limb[None, :].astype(np.int32))
    assert (prod64 >= 2 ** 31).any()     # the int32 products do wrap
    for mask in (0xFFF, 0xFFFFFF):
        np.testing.assert_array_equal(prod64 & mask,
                                      (prod32 & mask).astype(np.int64))


@pytest.mark.parametrize("nchan, nbin, nsb", [(5, 300, 16), (12, 1025, 8),
                                              (3, 64, 40)])
def test_plain_rotate_accumulate_matches_pallas_kernel(nchan, nbin, nsb):
    rng = np.random.default_rng(nchan * nbin)
    u = (rng.normal(size=(nchan, nbin))
         + 1j * rng.normal(size=(nchan, nbin))).astype(np.complex64)
    step = np.exp(1j * rng.uniform(0, 2 * np.pi, size=(nchan, nbin))) \
        .astype(np.complex64)
    ref = np.asarray(jax_fdd_superblock_spectra(
        jnp.asarray(u), jnp.asarray(step), nsb, interpret=True))
    got = fourier_cuda.fdd_superblock_spectra_plain(
        torch.from_numpy(u), torch.from_numpy(step), nsb).numpy()
    np.testing.assert_allclose(got, ref, **KERNEL_TOL)
    # and the naive geometric sum in float64
    n = np.arange(nsb)[:, None, None]
    naive = (u.astype(np.complex128)[None]
             * step.astype(np.complex128)[None] ** n).sum(axis=1)
    np.testing.assert_allclose(got, naive, rtol=1e-4, atol=1e-4)
    # with an accumulator: acc + sum, in place
    acc = torch.full((nsb, nbin), 1 + 2j, dtype=torch.complex64)
    out = fourier_cuda.fdd_superblock_spectra_plain(
        torch.from_numpy(u), torch.from_numpy(step), nsb, acc=acc)
    assert out is acc
    np.testing.assert_allclose(out.numpy(), got + (1 + 2j), **KERNEL_TOL)


def _fused_inputs(nchan, nbin, seed=0):
    rng = np.random.default_rng(seed)
    spec = torch.from_numpy((rng.normal(size=(nchan, nbin))
                             + 1j * rng.normal(size=(nchan, nbin)))
                            .astype(np.complex64))
    anchor = torch.from_numpy(rng.integers(0, 1 << 12, (3, nchan))
                              .astype(np.int32))
    step = torch.from_numpy(rng.integers(0, 1 << 12, (4, nchan))
                            .astype(np.int32))
    return spec, anchor, step


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the wrapper built or loaded the library")
    monkeypatch.setattr(nvcc, "build", refuse)
    monkeypatch.setattr(nvcc, "load", refuse)


def test_kernel_wrapper_refuses_bad_inputs(no_build):
    spec, anchor, step = _fused_inputs(4, 10)
    with pytest.raises(TypeError):
        fourier_cuda.fdd_superblock_spectra_cuda(spec.real.contiguous(),
                                                 anchor, step, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fourier_cuda.fdd_superblock_spectra_cuda(spec, anchor, step, 8)
    with pytest.raises(ValueError, match="contiguous"):
        fourier_cuda.fdd_superblock_spectra_cuda(spec.t(), anchor, step, 8)
    with pytest.raises(ValueError, match="out of range"):
        fourier_cuda.fdd_superblock_spectra_cuda(spec, anchor, step, 0)


@pytest.mark.parametrize("which, table, exc, match", [
    ("anchor", lambda a: a.to(torch.int64), TypeError, "int32"),
    ("anchor", lambda a: a[:2].contiguous(), ValueError, r"\(3, 4\)"),
    ("anchor", lambda a: a[:, :3].contiguous(), ValueError, "limb table"),
    ("anchor", lambda a: a.t().contiguous().t(), ValueError, "contiguous"),
    ("anchor", lambda a: a.to("meta"), ValueError, "is on meta"),
    ("step", lambda a: a.to(torch.float32), TypeError, "int32"),
    ("step", lambda a: a[:3].contiguous(), ValueError, r"\(4, 4\)"),
    ("step", lambda a: a.to("meta"), ValueError, "is on meta"),
])
def test_wrapper_refuses_bad_limb_tables_without_building(
        no_build, which, table, exc, match):
    # the limb tables are checked before the spectrum's device
    spec, anchor, step = _fused_inputs(4, 10)
    tables = dict(anchor=anchor, step=step)
    tables[which] = table(tables[which])
    before = fourier_cuda.launches
    with pytest.raises(exc, match=match):
        fourier_cuda.fdd_superblock_spectra_cuda(spec, tables["anchor"],
                                                 tables["step"], 8)
    assert fourier_cuda.launches == before


@pytest.mark.parametrize("nchan, nbin, nsb, chan_block", [
    (5, 300, 16, 128), (12, 1025, 8, 4), (3, 64, 40, 2), (130, 257, 64, 128),
])
def test_fused_plain_equals_the_composition_bit_for_bit(nchan, nbin, nsb,
                                                        chan_block):
    spec, anchor, step = _fused_inputs(nchan, nbin, seed=nchan + nbin)
    got = fourier_cuda.fdd_superblock_spectra(spec, anchor, step, nsb,
                                              chan_block=chan_block)
    # the composition the fused kernel replaces: phasors from the limbs
    # in int64, u = spec * rot0, the recurrence added per channel block
    k = torch.arange(nbin, dtype=torch.int64)
    kf = k.to(torch.float32)
    want = torch.zeros((nsb, nbin), dtype=torch.complex64)
    for lo in range(0, nchan, chan_block):
        hi = min(lo + chan_block, nchan)
        rot0 = tf.limb_phase(anchor[:, lo:hi].to(torch.int64), k, kf)
        ramp = tf.limb_phase(step[:, lo:hi].to(torch.int64), k, kf)
        want = fourier_cuda.fdd_superblock_spectra_plain(
            spec[lo:hi] * rot0, ramp, nsb, acc=want)
    assert torch.equal(got, want)
    # against the float64 geometric sum of the same phases
    a = anchor.numpy().astype(np.float64)
    b = step.numpy().astype(np.float64)
    f = np.arange(nbin, dtype=np.float64)
    pa = (a[0][:, None] * 2.0 ** -12 + a[1][:, None] * 2.0 ** -24
          + a[2][:, None] * 2.0 ** -36) * f
    pb = (b[0][:, None] * 2.0 ** -12 + b[1][:, None] * 2.0 ** -24
          + b[2][:, None] * 2.0 ** -36 + b[3][:, None] * 2.0 ** -48) * f
    n = np.arange(nsb)[:, None, None]
    naive = (spec.numpy().astype(np.complex128)[None]
             * np.exp(2j * np.pi * (pa[None] + n * pb[None]))).sum(axis=1)
    scale = np.abs(naive).max()
    assert np.abs(got.numpy() - naive).max() <= 1e-4 * scale


def test_fused_wrapper_runs_plain_on_cpu_without_launching(no_build):
    spec, anchor, step = _fused_inputs(6, 33)
    before = fourier_cuda.launches
    out = fourier_cuda.fdd_superblock_spectra(spec, anchor, step, 5)
    assert out.shape == (5, 33) and out.dtype == torch.complex64
    assert fourier_cuda.launches == before
    with pytest.raises(ValueError, match="no FDD kernel"):
        fourier_cuda.fdd_superblock_spectra(spec.to("meta"), anchor, step,
                                            5)


@pytest.mark.parametrize("nchan, t, dms, dm_block, chan_block", [
    (16, 512, np.linspace(90, 210, 11), 8, 8),
    # channels not a multiple of the channel block, odd T
    (20, 511, np.linspace(100, 200, 13), None, 8),
    # one trial; a superblock larger than the grid
    (8, 256, np.array([150.0]), None, None),
    (8, 256, np.linspace(100, 120, 5), 64, None),
])
def test_dedisperse_fourier_matches_float64_oracle(nchan, t, dms, dm_block,
                                                   chan_block):
    rng = np.random.default_rng(nchan + t)
    data = rng.normal(size=(nchan, t)).astype(np.float32)
    ref = jf.dedisperse_fourier(data, dms, *GEOM, xp=np)
    got = tf.dedisperse_fourier(data, dms, *GEOM, dm_block=dm_block,
                                chan_block=chan_block, device="cpu")
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ORACLE_ATOL)


def test_port_matches_jax_pallas_path(monkeypatch):
    # the JAX package's rotate-accumulate through its Pallas kernel
    # (interpret mode): same anchors, same step ramp; channel sums in
    # other orders, so a float32 tolerance
    monkeypatch.setenv("PUTPU_FDD_PALLAS", "1")
    rng = np.random.default_rng(3)
    data = rng.normal(size=(16, 512)).astype(np.float32)
    dms = np.linspace(90, 210, 11)
    ref = np.asarray(jf.dedisperse_fourier(data, dms, *GEOM, xp=jnp,
                                           dm_block=8, chan_block=8))
    got = tf.dedisperse_fourier(data, dms, *GEOM, dm_block=8, chan_block=8,
                                device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_uniform_and_fallback_paths_agree():
    rng = np.random.default_rng(5)
    nchan, t = 8, 512
    data = rng.normal(size=(nchan, t)).astype(np.float32)
    dms = np.linspace(100, 200, 9)
    jagged = dms.copy()
    jagged[4] += 3.0
    assert tf._uniform_spacing(jagged) is None
    uni = tf.dedisperse_fourier(data, dms, *GEOM, dm_block=4,
                                device="cpu").numpy()
    fb = tf.dedisperse_fourier(data, jagged, *GEOM, device="cpu").numpy()
    np.testing.assert_allclose(fb[:4], uni[:4], atol=ORACLE_ATOL)
    ref = jf.dedisperse_fourier(data, jagged, *GEOM, xp=np)
    np.testing.assert_allclose(fb, ref, atol=ORACLE_ATOL)
    # the fallback never runs the rotate-accumulate kernel's wrapper
    calls = []
    real = fourier_cuda.fdd_superblock_spectra

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    fourier_cuda.fdd_superblock_spectra = counting
    try:
        tf.dedisperse_fourier(data, jagged, *GEOM, device="cpu")
        assert not calls
        tf.dedisperse_fourier(data, dms, *GEOM, dm_block=4, device="cpu")
        assert len(calls) == 3    # superblocks of 4, 4, 1; one chan block
    finally:
        fourier_cuda.fdd_superblock_spectra = real


def test_phase_limbs_exact_at_long_t():
    # the limb phases stay exact where float32 f * tau loses ~0.1 rad: a
    # 2^20-sample series advanced by half its length plus a quarter
    # sample splits its impulse between bins T - 1 and 0
    t = 1 << 20
    data = torch.zeros((1, t), dtype=torch.float32)
    data[0, t // 2] = 1.0
    delays = np.array([[524288.25 * GEOM[2]]])
    _, planes = tf._fallback_run(data, tf._phase_limbs(delays, GEOM[2], t),
                                 1, 1, with_scores=False, keep_plane=True)
    plane = planes[0].numpy()
    top2 = np.sort(np.argsort(plane[0])[-2:])
    assert np.array_equal(top2, [0, t - 1]), top2
    assert np.isclose(plane.sum(), 1.0, atol=1e-3)


def test_blocking_shrinks_to_the_budget_like_jax():
    budget = tf.fdd_budget_bytes("cpu")
    assert budget == jf._fdd_hbm_budget() == 12 << 30
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = tf._auto_fdd_blocks(1024, 1 << 20, 512, 1024, budget=budget)
        want = jf._auto_fdd_blocks(1024, 1 << 20, 512, 1024)
    assert got == want and got != (512, 1024)
    assert len(caught) == 2
    for cross in (False, True):
        assert tf._fdd_live_bytes(1000, 300007, 64, 128, cross) \
            == jf._fdd_live_bytes(1000, 300007, 64, 128, cross)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert tf._auto_fdd_blocks(
            1024, 1 << 20, tf.FOURIER_SUPERBLOCK, tf.FOURIER_CHAN_BLOCK,
            budget=budget) == (tf.FOURIER_SUPERBLOCK, tf.FOURIER_CHAN_BLOCK)
    assert not caught


@pytest.fixture(scope="module")
def pulse_case():
    array, header = simulate_test_data(150, nchan=64, nsamples=2048,
                                       signal=2.0, noise=0.3, rng=13)
    args = (100, 200.0, header["fbottom"], header["bandwidth"],
            header["tsamp"])
    return array, args


def test_search_fourier_recovers_dm_like_jax(pulse_case):
    array, args = pulse_case
    ref = jax_search(array, *args, backend="jax", kernel="fourier")
    table = dedispersion_search(array, *args, kernel="fourier",
                                device="cpu")
    assert abs(table.best_row()["DM"] - 150) <= 1.5
    assert table.argbest() == ref.argbest()
    for col in ("DM", "rebin", "peak"):
        np.testing.assert_array_equal(table[col], ref[col])
    for col in ("max", "std", "snr"):
        np.testing.assert_allclose(table[col], ref[col], rtol=1e-5)
    # plane capture
    t2, plane = dedispersion_search(array, *args, kernel="fourier",
                                    show=True, device="cpu")
    assert plane.shape == (t2.nrows, 2048)
    np.testing.assert_array_equal(t2["snr"], table["snr"])


def test_fourier_options(pulse_case):
    array, args = pulse_case
    with pytest.raises(ValueError, match="memmap"):
        dedispersion_search(array, *args, kernel="fourier",
                            capture_plane="memmap", device="cpu")
    # an explicit non-uniform grid takes the fallback and still scores
    dms = np.array([120.0, 140.0, 150.0, 151.0, 170.0])
    table = dedispersion_search(array, *args, kernel="fourier",
                                trial_dms=dms, device="cpu")
    assert table.nrows == 5 and table.best_row()["DM"] in (150.0, 151.0)
