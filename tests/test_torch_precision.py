"""The port's precision policies against the JAX package's: the policy
module (strategies, exactness domain, names, the environment variable,
the compensated and pairwise sums bit for bit), the gather and roll
direct-sweep formulations under every policy, ``dedispersion_search``
with ``kernel="gather"|"roll"`` and ``precision=``, its rejection cases,
and ``search_by_chunks(kernel="gather")`` under ``PUTPU_PRECISION``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pulsarutils_tpu import precision as jprec
from pulsarutils_tpu.ops import dedisperse as jdd
from pulsarutils_tpu.ops.search import \
    dedispersion_search as jax_dedispersion_search
from pulsarutils_tpu.pipeline.search_pipeline import \
    search_by_chunks as jax_search_by_chunks

from pulsarutils_tpu_torch import precision as tprec
from pulsarutils_tpu_torch.io.sigproc import write_simulated_filterbank
from pulsarutils_tpu_torch.models.simulate import simulate_test_data
from pulsarutils_tpu_torch.ops import dedisperse as tdd
from pulsarutils_tpu_torch.ops.search import (auto_chan_block,
                                              dedispersion_search)
from pulsarutils_tpu_torch.pipeline.search_pipeline import search_by_chunks

torch.set_num_threads(1)

POLICIES = ("f32", "f32_compensated", "split_f32", "bf16_operand_f32_accum")

#: the gather's plain and bf16 channel sums: XLA's reduce order is its own
GATHER_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _static_choices(monkeypatch):
    """The JAX package's static choices (no autotuner) and no policy from
    the environment unless a test sets one."""
    monkeypatch.setenv("PUTPU_AUTOTUNE", "off")
    monkeypatch.delenv("PUTPU_PRECISION", raising=False)


# -- the policy module ------------------------------------------------------

def test_strategies_match_jax():
    assert list(tprec.STRATEGIES) == list(jprec.STRATEGIES)
    for name, strat in tprec.STRATEGIES.items():
        ref = jprec.STRATEGIES[name]
        assert (strat.name, strat.operand_dtype, strat.accumulator,
                strat.score_rtol, strat.summary) == (
            ref.name, ref.operand_dtype, ref.accumulator, ref.score_rtol,
            ref.summary)
        for n in (0, 1, 2, 17, 1024, 1 << 24, (1 << 24) + 1):
            assert strat.error_bound(n) == ref.error_bound(n)
    assert (tprec.EPS_F32, tprec.EPS_BF16, tprec.F32_EXACT_INT_BOUND) == (
        jprec.EPS_F32, jprec.EPS_BF16, jprec.F32_EXACT_INT_BOUND)


def test_exactness_domain_matches_jax():
    for nchan in (1, 16, 1024, 4096, (1 << 15) - 1, 1 << 15, 1 << 22,
                  1 << 24):
        for nsamples in (0, 1 << 20, 1 << 24, (1 << 24) + 1, 1 << 26):
            for nbits in (None, 1, 2, 4, 8, 15, 16):
                got = tprec.exactness_domain(nchan, nsamples, nbits)
                assert tuple(got) == tuple(jprec.exactness_domain(
                    nchan, nsamples, nbits))


def test_overflow_averted_is_counted():
    key = ("putpu_precision_overflow_averted_total", None)
    before = tprec.COUNTS[key]
    assert tprec.exactness_domain(1 << 24, nbits=1).accum_dtype is None
    assert tprec.COUNTS[key] == before + 1
    tprec.exactness_domain(1024, nbits=8)
    assert tprec.COUNTS[key] == before + 1


@pytest.mark.parametrize("name", [None, "", "f32", "auto", *POLICIES[1:],
                                  "f64", "bf16"])
def test_policy_name_matches_jax(name):
    try:
        want = jprec.policy_name(name)
    except ValueError:
        with pytest.raises(ValueError, match="unknown precision policy"):
            tprec.policy_name(name)
    else:
        assert tprec.policy_name(name) == want
        # the port's callers take "auto" as the static f32 pairing
        assert tprec.static_policy(name) == ("f32" if want == "auto"
                                             else want)
        assert tprec.strategy(name) == (None if want in ("f32", "auto")
                                        else tprec.STRATEGIES[want])


@pytest.mark.parametrize("env", [None, "f32", "split_f32",
                                 "bf16_operand_f32_accum", "auto",
                                 "not-a-policy"])
@pytest.mark.parametrize("explicit", [None, "f32_compensated"])
def test_resolve_policy_matches_jax(env, explicit, monkeypatch):
    if env is not None:
        monkeypatch.setenv("PUTPU_PRECISION", env)
    try:
        want = jprec.resolve_policy(explicit)
    except ValueError:
        with pytest.raises(ValueError):
            tprec.resolve_policy(explicit)
        return
    key = ("putpu_precision_policy_resolutions_total", want)
    before = tprec.COUNTS[key]
    assert tprec.resolve_policy(explicit) == want
    assert tprec.COUNTS[key] == before + 1


def test_engage_counts_non_plain_accumulators_only():
    for name in (None, "auto", *POLICIES):
        key = ("putpu_precision_compensated_engagements_total",
               name or "f32")
        before = tprec.COUNTS[key]
        assert tprec.engage(name) == jprec.policy_name(name)
        plain = name in (None, "auto", "f32", "bf16_operand_f32_accum")
        assert tprec.COUNTS[key] == before + (0 if plain else 1)


def test_cast_operand():
    x = torch.linspace(0.0, 3.0, 101)
    for name in ("f32", "f32_compensated", "split_f32"):
        assert tprec.cast_operand(x, name) is x
    y = tprec.cast_operand(x, "bf16_operand_f32_accum")
    assert y.dtype == torch.bfloat16
    want = np.asarray(jprec.cast_operand(jnp.asarray(x.numpy()),
                                         "bf16_operand_f32_accum", jnp)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(y.to(torch.float32).numpy(), want)


def _adversaries(n):
    """A large DC offset and alternating-sign cancellation (the JAX
    package's own adversaries of plain float32 summation)."""
    rng = np.random.default_rng(171)
    dc = (1e7 + rng.standard_normal(n)).astype(np.float32)
    alt = rng.standard_normal(n).astype(np.float32)
    alt[::2] *= -1.0
    alt *= 1e4
    return {"dc_offset": dc, "alternating": alt}


@pytest.mark.parametrize("n", [1 << 12, 4097, 1])
@pytest.mark.parametrize("case", ["dc_offset", "alternating"])
def test_compensated_and_split_sums_bit_identical(case, n):
    x = _adversaries(n)[case]
    for tfn, jfn in ((tprec.neumaier_sum, jprec.neumaier_sum),
                     (tprec.split_sum, jprec.split_sum)):
        got = tfn(torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jfn(x, axis=-1, xp=np))
        np.testing.assert_array_equal(
            got, np.asarray(jfn(jnp.asarray(x), axis=-1, xp=jnp)))
    # along an inner axis, elementwise over the others
    x2 = x[: (n // 4) * 4].reshape(4, -1) if n >= 4 else x[None]
    for tfn, jfn in ((tprec.neumaier_sum, jprec.neumaier_sum),
                     (tprec.split_sum, jprec.split_sum)):
        np.testing.assert_array_equal(tfn(torch.from_numpy(x2), dim=0),
                                      jfn(x2, axis=0, xp=np))


def test_empty_sums_are_zero():
    x = torch.zeros((0, 3))
    for fn in (tprec.neumaier_sum, tprec.split_sum):
        assert torch.equal(fn(x, dim=0), torch.zeros(3))


# -- the formulations --------------------------------------------------------

def _block(seed=3, nchan=24, nsamples=1000, ndm=7, dc=0.0):
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal((nchan, nsamples)) * 50 + dc).astype(
        np.float32)
    offsets = rng.integers(0, nsamples, (ndm, nchan)).astype(np.int32)
    return data, offsets


def _jax_policy(policy):
    return None if policy == "f32" else policy


@pytest.mark.parametrize("dc", [0.0, 1e4])
@pytest.mark.parametrize("policy", POLICIES)
def test_roll_bit_identical_to_jax(policy, dc):
    data, offsets = _block(dc=dc)
    got = tdd.dedisperse_block_roll(torch.from_numpy(data), offsets,
                                    policy=policy)
    want = jax.jit(lambda d, o: jdd.dedisperse_block_roll_jax(
        d, o, policy=_jax_policy(policy)))(data, offsets)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and through dedisperse_block(formulation="roll")
    np.testing.assert_array_equal(
        tdd.dedisperse_block(torch.from_numpy(data), offsets, "roll",
                             policy=policy).numpy(), np.asarray(want))
    if policy == "f32":
        # channel 0 as the seed, then ascending: the direct sweep's plane
        np.testing.assert_array_equal(
            got.numpy(), tdd.dedisperse_plane_plain(
                torch.from_numpy(data), offsets).numpy())


def test_roll_wraps_raw_shifts():
    data, offsets = _block()
    raw = offsets.astype(np.int64) - 3 * data.shape[1]
    np.testing.assert_array_equal(
        tdd.dedisperse_block_roll(torch.from_numpy(data), raw).numpy(),
        np.asarray(jdd.dedisperse_block_roll_jax(data, raw)))


@pytest.mark.parametrize("chan_block", [None, 4])
@pytest.mark.parametrize("policy", POLICIES)
def test_gather_matches_jax(policy, chan_block):
    data, offsets = _block(dc=1e3)
    got = tdd.dedisperse_block_chunked(torch.from_numpy(data), offsets,
                                       chan_block=chan_block,
                                       formulation="gather",
                                       policy=policy).numpy()
    want = np.asarray(jax.jit(lambda d, o: jdd.dedisperse_block_chunked_jax(
        d, o, chan_block, formulation="gather",
        policy=_jax_policy(policy)))(data, offsets))
    if policy in ("f32_compensated", "split_f32"):
        # a fixed sequential walk, a fixed tree: the same floats
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=GATHER_RTOL)


def test_chunked_roll_ignores_chan_block():
    data, offsets = _block()
    for policy in POLICIES:
        got = tdd.dedisperse_block_chunked(torch.from_numpy(data), offsets,
                                           chan_block=4, formulation="roll",
                                           policy=policy)
        want = tdd.dedisperse_block_roll(torch.from_numpy(data), offsets,
                                         policy=policy)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="chan_block"):
        tdd.dedisperse_block_chunked(torch.from_numpy(data), offsets,
                                     chan_block=5, formulation="gather")


@pytest.mark.parametrize("formulation", ["gather", "roll"])
def test_integer_inputs_ignore_the_policy(formulation):
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 255, (32, 512)).astype(np.int16)
    offsets = rng.integers(0, 512, (5, 32)).astype(np.int32)
    want = np.asarray(jdd.dedisperse_block_jax(codes, offsets,
                                               formulation=formulation))
    for policy in POLICIES:
        got = tdd.dedisperse_block(torch.from_numpy(codes), offsets,
                                   formulation=formulation, policy=policy)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), want)


def test_auto_chan_block_matches_jax():
    from pulsarutils_tpu.ops.search import \
        auto_chan_block as jax_auto_chan_block

    for nchan in (64, 1000, 1024, 4096):
        for nsamples in (1 << 10, 1 << 18, 1 << 20):
            for dm_block in (1, 8, 32):
                assert auto_chan_block(nchan, nsamples, dm_block) == \
                    jax_auto_chan_block(nchan, nsamples, dm_block)


# -- dedispersion_search ----------------------------------------------------

def _problem(seed=5, nchan=32, nsamples=4096, ndm=12):
    """The JAX package's precision test problem, a pulse injected."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((nchan, nsamples)).astype(np.float32)
    data[:, 1000:1003] += 6.0
    dms = np.linspace(300.0, 330.0, ndm)
    return data, dms, (1200.0, 200.0, 0.0005)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kernel", ["roll", "gather"])
def test_search_matches_jax_under_every_policy(kernel, policy):
    data, dms, geom = _problem()
    want = jax_dedispersion_search(data, None, None, *geom, backend="jax",
                                   trial_dms=dms, kernel=kernel,
                                   precision=policy)
    got = dedispersion_search(data, None, None, *geom, trial_dms=dms,
                              kernel=kernel, precision=policy,
                              device="cpu")
    for col in ("DM", "rebin", "peak"):
        np.testing.assert_array_equal(got[col], np.asarray(want[col]))
    rtol = tprec.STRATEGIES[policy].score_rtol
    np.testing.assert_allclose(got["snr"], np.asarray(want["snr"]),
                               rtol=rtol)
    assert got.argbest() == want.argbest()


@pytest.mark.parametrize("kernel", ["roll", "gather"])
def test_search_blocks_and_capture(kernel):
    # blocks of 5 trials (a padded last block) and of 8 channels give the
    # table of the default blocks; the captured plane is the roll plane
    data, dms, geom = _problem()
    whole, plane = dedispersion_search(
        data, None, None, *geom, trial_dms=dms, kernel=kernel,
        precision="f32_compensated", capture_plane=True, device="cpu")
    blocked = dedispersion_search(
        data, None, None, *geom, trial_dms=dms, kernel=kernel,
        precision="f32_compensated", dm_block=5, chan_block=8, device="cpu")
    for col in ("DM", "rebin", "peak"):
        np.testing.assert_array_equal(blocked[col], whole[col])
    np.testing.assert_allclose(blocked["snr"], whole["snr"], rtol=1e-6)
    assert tuple(plane.shape) == (len(dms), data.shape[1])
    if kernel == "roll":
        from pulsarutils_tpu_torch.ops.plan import offsets_for

        offsets = offsets_for(dms, data.shape[0], *geom, data.shape[1])
        np.testing.assert_array_equal(
            plane.numpy(), tdd.dedisperse_block_roll(
                torch.from_numpy(data), offsets,
                policy="f32_compensated").numpy())


def test_env_policy_reaches_the_search(monkeypatch):
    data, dms, geom = _problem()
    monkeypatch.setenv("PUTPU_PRECISION", "bf16_operand_f32_accum")
    got = dedispersion_search(data, None, None, *geom, trial_dms=dms,
                              kernel="gather", device="cpu")
    explicit = dedispersion_search(data, None, None, *geom, trial_dms=dms,
                                   kernel="gather",
                                   precision="bf16_operand_f32_accum",
                                   device="cpu")
    plain = dedispersion_search(data, None, None, *geom, trial_dms=dms,
                                kernel="gather", precision="f32",
                                device="cpu")
    np.testing.assert_array_equal(got["snr"], explicit["snr"])
    assert not np.array_equal(got["snr"], plain["snr"])
    # "auto" is the static f32 pairing, as the JAX package's with its
    # autotuner off
    auto = dedispersion_search(data, None, None, *geom, trial_dms=dms,
                               kernel="gather", precision="auto",
                               device="cpu")
    np.testing.assert_array_equal(auto["snr"], plain["snr"])


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("env", [None, "f32_compensated", "not-a-policy"])
@pytest.mark.parametrize("precision", [None, "f32", "auto", "split_f32",
                                       "bf16_operand_f32_accum", "f64"])
@pytest.mark.parametrize("kernel", ["pallas", "gather", "roll", "fdmt",
                                    "hybrid", "fourier"])
def test_rejections_match_jax(kernel, precision, env, monkeypatch):
    if env is not None:
        monkeypatch.setenv("PUTPU_PRECISION", env)
    data, dms, geom = _problem(nchan=16, nsamples=1024, ndm=4)
    trial = None if kernel == "fdmt" else dms
    jax_raises = _raises(lambda: jax_dedispersion_search(
        data, 300.0, 330.0, *geom, backend="jax", trial_dms=trial,
        kernel=kernel, precision=precision))
    port_raises = _raises(lambda: dedispersion_search(
        data, 300.0, 330.0, *geom, trial_dms=trial, kernel=kernel,
        precision=precision, device="cpu"))
    assert port_raises == jax_raises


@pytest.mark.parametrize("env", [None, "split_f32"])
@pytest.mark.parametrize("precision", [None, "f32", "auto",
                                       "f32_compensated", "f64"])
def test_direct_sweep_is_float32_only(precision, env, monkeypatch):
    # the port's "auto" is its direct sweep, the JAX package's "pallas":
    # it takes f32 and "auto" only, from the argument or the environment
    if env is not None:
        monkeypatch.setenv("PUTPU_PRECISION", env)
    data, dms, geom = _problem(nchan=16, nsamples=1024, ndm=4)
    effective = precision or env or "f32"
    if effective in ("f32", "auto"):
        table = dedispersion_search(data, None, None, *geom, trial_dms=dms,
                                    precision=precision, device="cpu")
        assert table.nrows == len(dms)
    else:
        with pytest.raises(ValueError):
            dedispersion_search(data, None, None, *geom, trial_dms=dms,
                                precision=precision, device="cpu")


def test_gather_rejects_memmap_capture():
    data, dms, geom = _problem(nchan=16, nsamples=1024, ndm=4)
    for kernel in ("gather", "roll"):
        with pytest.raises(ValueError, match="memmap"):
            dedispersion_search(data, None, None, *geom, trial_dms=dms,
                                kernel=kernel, capture_plane="memmap",
                                device="cpu")


def test_empty_plan_gives_an_empty_table():
    data, _, geom = _problem(nchan=16, nsamples=1024)
    for kernel in ("gather", "roll"):
        table, plane = dedispersion_search(data, 330.0, 300.0, *geom,
                                           kernel=kernel, show=True,
                                           device="cpu")
        assert table.nrows == 0 and tuple(plane.shape) == (0, 1024)


# -- search_by_chunks under PUTPU_PRECISION ---------------------------------

SEARCH = dict(dmmin=100.0, dmmax=200.0, chunk_length=1.024,
              snr_threshold=6.0)


@pytest.mark.parametrize("policy", ["f32_compensated",
                                    "bf16_operand_f32_accum"])
def test_search_by_chunks_gather_matches_jax(policy, tmp_path,
                                             monkeypatch):
    array, header = simulate_test_data(150.0, nsamples=16384, nchan=32,
                                       signal=10.0, noise=4.0, rng=7)
    path = str(tmp_path / "pulse.fil")
    write_simulated_filterbank(path, array + 20.0, header, descending=True,
                               nbits=8)
    monkeypatch.setenv("PUTPU_PRECISION", policy)
    ref_hits, ref_store = jax_search_by_chunks(
        path, backend="jax", kernel="gather", make_plots=False,
        output_dir=str(tmp_path / "jax"), **SEARCH)
    key = ("putpu_precision_policy_resolutions_total", policy)
    before = tprec.COUNTS[key]
    hits, store = search_by_chunks(path, kernel="gather", device="cpu",
                                   output_dir=str(tmp_path / "port"),
                                   **SEARCH)
    assert tprec.COUNTS[key] > before
    assert hits, "the injected pulse was not found"
    assert store.done_chunks == ref_store.done_chunks
    assert [(h[0], h[1]) for h in hits] == [(h[0], h[1]) for h in ref_hits]
    rtol = tprec.STRATEGIES[policy].score_rtol
    for (_, _, info, table), (_, _, rinfo, rtable) in zip(hits, ref_hits):
        best, rbest = table.best_row(), rtable.best_row()
        for col in ("DM", "rebin", "peak"):
            assert best[col] == rbest[col]
        np.testing.assert_allclose(best["snr"], rbest["snr"], rtol=rtol)
        assert info.dm == rinfo.dm and info.width == rinfo.width
