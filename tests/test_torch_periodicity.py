"""The port's periodicity search against the JAX package's: the scoring
chain (B6's plain version) against the XLA chain and the Pallas kernel in
interpret mode, a host replay of the CUDA kernel's radix-select median
and stack, folding and the per-chunk period search, the acceleration
search on a shared plane, the accumulator, the sift, candidate files
carried across, and the ``PUperiod`` driver end to end."""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pulsarutils_tpu.io.sigproc import \
    write_simulated_filterbank as jax_write_filterbank
from pulsarutils_tpu.models import simulate as jsim
from pulsarutils_tpu.ops import periodicity as jp
from pulsarutils_tpu.ops import robust as jrobust
from pulsarutils_tpu.ops.harmonic_pallas import spectral_search_pallas
from pulsarutils_tpu.ops.rebin import stretch_resample as jax_stretch
from pulsarutils_tpu.parallel.stream import ChunkPlan as JaxChunkPlan
from pulsarutils_tpu.periodicity import accel as jaccel
from pulsarutils_tpu.periodicity import accumulate as jacc
from pulsarutils_tpu.periodicity import candidates as jcands
from pulsarutils_tpu.periodicity.driver import \
    periodicity_search as jax_periodicity_search
from pulsarutils_tpu.pipeline.search_pipeline import \
    search_by_chunks as jax_search_by_chunks
from pulsarutils_tpu.tuning.autotune import harmonic_packs_match

from pulsarutils_tpu_torch.cli import period_main
from pulsarutils_tpu_torch.models import simulate as tsim
from pulsarutils_tpu_torch.ops import harmonic_cuda
from pulsarutils_tpu_torch.ops import periodicity as tp
from pulsarutils_tpu_torch.ops import robust as trobust
from pulsarutils_tpu_torch.ops.rebin import stretch_resample
from pulsarutils_tpu_torch.parallel.stream import ChunkPlan
from pulsarutils_tpu_torch.periodicity import accel as taccel
from pulsarutils_tpu_torch.periodicity import accumulate as tacc
from pulsarutils_tpu_torch.periodicity import candidates as tcands
from pulsarutils_tpu_torch.periodicity.driver import periodicity_search
from pulsarutils_tpu_torch.precision import STRATEGIES
from pulsarutils_tpu_torch.pipeline.search_pipeline import (plan_survey,
                                                            search_by_chunks)

torch.set_num_threads(1)

TSAMP = 1e-3
#: the JAX package's cross-program rule (harmonic_packs_match): depth and
#: frequency bin exact, scores within rtol 1e-5
HARM_RTOL = 1e-5

#: the harmonic stack's precision policies
POLICIES = ("f32", "f32_compensated", "split_f32", "bf16_operand_f32_accum")


def _plane(rows=13, t=4096, seed=11):
    """Noise rows, a strong pulse-train row, a weak tone row and an
    all-zero row."""
    rng = np.random.default_rng(seed)
    plane = rng.standard_normal((rows, t)).astype(np.float32)
    tt = np.arange(t) * TSAMP
    f0 = 200 / (t * TSAMP)
    plane[2] += 1.5 * np.square(np.sin(np.pi * f0 * tt))
    plane[7] += 0.4 * np.sin(2 * np.pi * f0 * tt)
    plane[5] = 0.0
    return plane


def _host(spec):
    return {k: np.asarray(v) for k, v in spec.items()}


@pytest.mark.parametrize("t, max_harmonics, fmin, fmax", [
    (4096, 16, None, None),        # even median length (2048)
    (4095, 16, None, None),        # odd median length
    (4096, 4, 5.0, 40.0),          # a band, truncated depths
    (4096, 1, None, None),
    (4096, 16, 600.0, None),       # fmin above Nyquist: an empty band
])
def test_scoring_chain_matches_xla_and_pallas(t, max_harmonics, fmin, fmax):
    plane = _plane(t=t)
    kw = dict(max_harmonics=max_harmonics, fmin=fmin, fmax=fmax)
    got = _host(tp.spectral_search(torch.from_numpy(plane), TSAMP, **kw))
    xla = _host(jp.spectral_search(jnp.asarray(plane), TSAMP, xp=jnp, **kw))
    pallas = _host(spectral_search_pallas(plane, TSAMP, interpret=True,
                                          **kw))
    for ref in (xla, pallas):
        assert harmonic_packs_match(ref, got, rtol=HARM_RTOL,
                                    bin_scale=t * TSAMP)
    assert got["nharm"].dtype == np.int32
    # the all-zero row: median 0 divides by 1, every depth peaks at bin 0
    assert got["freq"][5] == 0.0 and got["nharm"][5] == 0


def _score_rtol(policy):
    """The JAX package's tolerance between its Pallas and XLA harmonic
    scorers under a policy (``tests/test_harmonic_pallas.py``)."""
    if policy in (None, "f32"):
        return 1e-5
    return max(1e-5, STRATEGIES[policy].score_rtol * 1e-2)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("t, max_harmonics, fmin, fmax", [
    (4096, 16, None, None),
    (4095, 8, 5.0, 40.0),    # odd median length, a band, 8 harmonics
])
def test_harmonic_stack_policies_match_jax(policy, t, max_harmonics, fmin,
                                           fmax):
    plane = _plane(rows=8, t=t)
    kw = dict(max_harmonics=max_harmonics, fmin=fmin, fmax=fmax)
    jpolicy = None if policy == "f32" else policy
    power = tp.power_spectrum(torch.from_numpy(plane))
    norm = tp.normalize_power(power)
    jpower = jp.power_spectrum(jnp.asarray(plane), xp=jnp)
    jnorm = jp.normalize_power(jpower, xp=jnp)
    pairs = [
        (tp.score_normalized_power(norm, t, TSAMP, policy=policy, **kw),
         jp.score_normalized_power(jnorm, t, TSAMP, xp=jnp, policy=jpolicy,
                                   **kw)),
        (tp.spectral_search(torch.from_numpy(plane), TSAMP, policy=policy,
                            **kw),
         spectral_search_pallas(plane, TSAMP, policy=jpolicy,
                                interpret=True, **kw)),
    ]
    scale = t * TSAMP
    for got, want in pairs:
        got, want = _host(got), _host(want)
        np.testing.assert_array_equal(got["nharm"], want["nharm"])
        np.testing.assert_array_equal(np.rint(got["freq"] * scale),
                                      np.rint(want["freq"] * scale))
        for col in ("power", "log_sf", "sigma"):
            np.testing.assert_allclose(got[col], want[col],
                                       rtol=_score_rtol(policy), atol=1e-6,
                                       err_msg=col)
    # the harmonic sum alone, on the same normalised spectra: the same
    # adds in the same order
    for nharm in (1, 5, 16):
        np.testing.assert_array_equal(
            tp.harmonic_sum(norm, nharm, policy=policy).numpy(),
            np.asarray(jp.harmonic_sum(jnp.asarray(norm.numpy()), nharm,
                                       xp=jnp, policy=jpolicy)))


def test_policies_other_than_f32_are_not_ported():
    # every policy of the JAX package is ported now: each runs, and a name
    # outside them raises ValueError, as policy_name does there
    for policy in (None, "auto", *STRATEGIES):
        spec = tp.spectral_search(torch.zeros(2, 64), TSAMP, policy=policy)
        assert spec["nharm"].shape == (2,)
    with pytest.raises(ValueError, match="precision policy"):
        tp.spectral_search(torch.zeros(2, 64), TSAMP, policy="f64")


def _keys(values):
    bits = np.asarray(values, np.float32).view(np.uint32).astype(np.int64)
    return np.where(bits & 0x80000000, ~bits & 0xFFFFFFFF,
                    bits | 0x80000000)


def _value(key):
    b = key & 0x7FFFFFFF if key & 0x80000000 else ~key & 0xFFFFFFFF
    return np.array([b], np.uint32).view(np.float32)[0]


#: the cluster branch's stack batches by the harmonics in range of their
#: first bin: (more than this many harmonics, chunks a batch, harmonics
#: read)
_BATCHES = ((8, 1, 16), (4, 2, 8), (2, 4, 4), (1, 8, 2), (0, 8, 1))


def _bf16(x):
    """float32 values rounded to bfloat16 (to nearest even), as float32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _replay_harmonic(power, depths, lo, hi, cluster=1,
                     candidates=harmonic_cuda.CLUSTER_CANDIDATES,
                     policy="f32"):
    """The CUDA kernel's algorithm on the host, branch by branch.

    ``cluster`` 1 is the global branch: one block holds the row, the radix
    select scans it three times, thread ``t`` takes bins ``t, t + 512,
    ...`` and divides each harmonic as it reads it.  Above 1, the cluster
    branch: block ``b`` holds bins ``[b*S, (b+1)*S)`` (``S =
    slice_bins``, a multiple of 32).  The radix select's histograms (11,
    11, 10 bits of order-preserving keys) are each block's own, summed
    share by share (block ``b`` sums bins ``[b*share, (b+1)*share)`` over
    the blocks, then every block gathers the other shares); after the
    first pass a block keeps its keys in the chosen bucket (at most
    ``candidates`` of them, else it scans its slice again) and its least
    key above the bucket, and the later passes and the upper middle
    value's look (only when the lower one ends its run of equal keys) run
    over those.  Each block divides its slice by the median (IEEE) and
    writes harmonic ``j``'s array ``D_j[i] = norm[i*j]`` for the ``i*j``
    it holds.  Chunk ``c`` of 32 bins goes to block ``c % cluster`` and
    warp ``c // cluster % 16``, which takes its chunks in batches sized by
    the harmonics the batch's first bin has in range (:data:`_BATCHES`);
    the stack adds ``D_j[i]`` (0 where ``i*j`` is out of range) in
    ascending ``j``; each thread keeps its first strict maximum over its
    bins in ascending order, and the reductions take the larger value,
    then the smaller bin.  ``policy``: under ``bf16_operand_f32_accum``
    each block rounds its divided slice to bfloat16; under
    ``f32_compensated`` and ``split_f32`` each add is a TwoSum step beside
    a carry and a depth scores ``acc + comp``."""
    code = harmonic_cuda.POLICY_CODES[policy]
    power = np.asarray(power, dtype=np.float32)
    rows, nbins = power.shape
    s_bins = nbins if cluster == 1 else harmonic_cuda.slice_bins(nbins,
                                                                 cluster)
    nblk = -(-nbins // s_bins)
    share = -(-2048 // cluster)
    hmax = depths[-1]
    vals = np.zeros((rows, len(depths)), np.float32)
    bins = np.zeros((rows, len(depths)), np.int32)
    for r in range(rows):
        p = power[r]
        slices = [p[b * s_bins:(b + 1) * s_bins] for b in range(nblk)]
        keys = [_keys(sl) for sl in slices]
        keys[0] = keys[0][1:]                     # p[1:]: no DC bin
        n = nbins - 1
        k = (n - 1) // 2
        prefix, pmask, above = 0, 0, []
        for pas, (shift, width) in enumerate(((21, 11), (10, 11), (0, 10))):
            hists = [np.bincount(
                (kb[(kb & pmask) == prefix] >> shift) & ((1 << width) - 1),
                minlength=2048) for kb in keys]
            full = np.zeros(2048, np.int64)
            for b in range(max(cluster, 1)):      # each block's share
                part = slice(b * share, min(2048, (b + 1) * share))
                full[part] = sum(h[part] for h in hists)
            below = np.cumsum(full) - full
            bucket = int(np.flatnonzero(below + full > k)[0])
            k -= int(below[bucket])
            last = int(full[bucket])
            if pas == 0 and cluster > 1:
                # each block: its keys in the bucket, or all of them where
                # they are more than it keeps, and its least key above
                above = [kb[(kb >> 21) > bucket] for kb in keys]
                keys = [kb[(kb >> 21) == bucket]
                        if hists[b][bucket] <= candidates else kb
                        for b, kb in enumerate(keys)]
            prefix |= bucket << shift
            pmask |= ((1 << width) - 1) << shift
        key_lo = key_hi = prefix
        if n % 2 == 0 and last - 1 - k == 0:
            key_hi = min(int(kk.min()) for kk in
                         [kb[kb > key_lo] for kb in keys] + above
                         if kk.size)
        med = (_value(key_lo) + _value(key_hi)) * np.float32(0.5)
        div = (med / np.float32(np.log(2.0)) if med > 0
               else np.float32(1.0))
        norm = [sl / div for sl in slices]        # in place, per block
        if code == 2:
            norm = [_bf16(sl) for sl in norm]
        # harmonic j's arrays, written block by block
        arrays = {}
        for j in range(1, hmax + 1):
            dj = np.full(-(-nbins // j), np.nan, np.float32)
            for b in range(nblk):
                base, size = b * s_bins, len(norm[b])
                for i in range(-(-base // j), -(-(base + size) // j)):
                    assert np.isnan(dj[i])
                    dj[i] = norm[b][i * j - base]
            assert not np.isnan(dj).any()
            arrays[j] = dj
        # (thread, chunk) in the order each thread visits its chunks
        nchunks, warps = -(-nbins // 32), harmonic_cuda.THREADS // 32
        step = max(cluster, 1) * warps
        visits = []
        for b in range(max(cluster, 1)):
            for w in range(warps):
                c = b + max(cluster, 1) * w
                while c < nchunks:
                    first = 32 * c
                    jw = hmax if first == 0 else min(hmax,
                                                     (nbins - 1) // first)
                    size = 1 if cluster == 1 else next(
                        g for lim, g, _ in _BATCHES if jw > lim)
                    visits += [((b, w), cc) for cc in
                               range(c, c + size * step, step)
                               if cc < nchunks]
                    c += size * step
        best = {}
        seen = np.zeros(nbins, np.int64)
        for thread, c in visits:
            for lane in range(32):
                i = 32 * c + lane
                if i >= nbins:
                    continue
                seen[i] += 1
                band = np.float32(1.0 if lo <= i < hi else 0.0)
                acc = comp = np.float32(0.0)
                d = 0
                for j in range(1, hmax + 1):
                    v = arrays[j][i] if i * j < nbins else np.float32(0.0)
                    if code == 1:
                        s = np.float32(acc + v)
                        bp = np.float32(s - acc)
                        comp = np.float32(comp + np.float32(
                            np.float32(acc - np.float32(s - bp))
                            + np.float32(v - bp)))
                        acc = s
                    else:
                        acc = np.float32(acc + v)
                    if j == depths[d]:
                        total = np.float32(acc + comp) if code == 1 else acc
                        h = np.float32(total * band)
                        key = (thread, lane, d)
                        if key not in best or h > best[key][0]:
                            best[key] = (h, i)
                        d += 1
        assert (seen == 1).all()
        for d in range(len(depths)):
            v, i = max(((h, -i) for (t, ln, dd), (h, i) in best.items()
                        if dd == d))
            vals[r, d], bins[r, d] = v, -i
    return vals, bins


def _harmonic_power(t, seed):
    plane = _plane(rows=9, t=t, seed=seed)
    power = tp.power_spectrum(torch.from_numpy(plane))
    power[3, power.shape[1] // 2:] = 0.0    # many equal keys
    power[6, 1:40] = power[6, 40]           # a run of equal values
    return power


@pytest.mark.parametrize("t, lo_hi", [(4096, None), (4095, None),
                                      (4096, (30, 700))])
def test_kernel_replay_equals_plain_bit_for_bit(t, lo_hi):
    _check_global_replay(t, lo_hi, "f32")


@pytest.mark.parametrize("policy", POLICIES[1:])
@pytest.mark.parametrize("t, lo_hi", [(4096, None), (4095, None),
                                      (4096, (30, 700))])
def test_kernel_replay_policies_bit_for_bit(t, lo_hi, policy):
    _check_global_replay(t, lo_hi, policy)


def _check_global_replay(t, lo_hi, policy):
    """The global branch's replay and the wrapper's CPU path against the
    plain version under ``policy``."""
    power = _harmonic_power(t, t)
    nbins = power.shape[1]
    lo, hi = lo_hi or (1, nbins)
    depths = tp.harmonic_depths(16)
    pv, pb = tp.harmonic_peaks_plain(tp.normalize_power(power), depths, lo,
                                     hi, policy=policy)
    rv, rb = _replay_harmonic(power.numpy(), depths, lo, hi, policy=policy)
    np.testing.assert_array_equal(rb, pb.numpy())
    np.testing.assert_array_equal(rv, pv.numpy())
    # the wrapper's CPU path is the plain version
    wv, wb = harmonic_cuda.harmonic_peaks(power, depths, lo, hi,
                                          policy=policy)
    assert torch.equal(wv, pv) and torch.equal(wb, pb)


@pytest.mark.parametrize("cluster", harmonic_cuda.CLUSTER_SIZES)
@pytest.mark.parametrize("t, lo_hi, depth, candidates", [
    (4096, None, 16, None),      # even median length (2048 bins of p[1:])
    (4095, None, 16, None),      # odd median length
    (2050, (30, 700), 4, None),  # a band, 4 harmonics
    (1024, None, 1, None),       # one harmonic
    # blocks with more keys in the first bucket than they keep scan their
    # slice in the later passes
    (4096, None, 16, 8),
])
def test_cluster_replay_equals_plain_bit_for_bit(cluster, t, lo_hi, depth,
                                                 candidates):
    power = _harmonic_power(t, t + cluster)
    nbins = power.shape[1]
    # a zero tail that starts inside one slice and runs over the next
    s_bins = harmonic_cuda.slice_bins(nbins, cluster)
    power[8, s_bins - 5:] = 0.0
    lo, hi = lo_hi or (1, nbins)
    depths = tp.harmonic_depths(depth)
    pv, pb = tp.harmonic_peaks_plain(tp.normalize_power(power), depths, lo,
                                     hi)
    rv, rb = _replay_harmonic(power.numpy(), depths, lo, hi, cluster,
                              candidates or harmonic_cuda.CLUSTER_CANDIDATES)
    np.testing.assert_array_equal(rb, pb.numpy())
    np.testing.assert_array_equal(rv, pv.numpy())


@pytest.mark.parametrize("policy", POLICIES[1:])
@pytest.mark.parametrize("cluster", harmonic_cuda.CLUSTER_SIZES)
@pytest.mark.parametrize("t, lo_hi, depth", [
    (4096, None, 16),        # every stack batch, a zero tail across slices
    (2050, (30, 700), 4),    # a band, 4 harmonics
])
def test_cluster_replay_policies_bit_for_bit(cluster, t, lo_hi, depth,
                                             policy):
    power = _harmonic_power(t, t + cluster)
    nbins = power.shape[1]
    power[8, harmonic_cuda.slice_bins(nbins, cluster) - 5:] = 0.0
    lo, hi = lo_hi or (1, nbins)
    depths = tp.harmonic_depths(depth)
    pv, pb = tp.harmonic_peaks_plain(tp.normalize_power(power), depths, lo,
                                     hi, policy=policy)
    rv, rb = _replay_harmonic(power.numpy(), depths, lo, hi, cluster,
                              policy=policy)
    np.testing.assert_array_equal(rb, pb.numpy())
    np.testing.assert_array_equal(rv, pv.numpy())


def test_cluster_replay_middle_values_in_two_slices():
    # an even-length median whose two middle values sit in different
    # slices, and one whose lower middle value ends a run of equal keys
    # (the least-key-above pass over every block)
    nbins = 1025
    p = np.zeros((2, nbins), np.float32)
    p[0, 1], p[0, 1023] = 100.0, 101.0    # ranks 511 and 512
    p[0, 2:513] = np.linspace(1.0, 99.0, 511)
    p[0, 513:1023] = np.linspace(102.0, 199.0, 510)
    p[0, 1024] = 200.0
    p[1, 1:513] = 3.0
    p[1, 513:] = 5.0 + np.arange(512, dtype=np.float32)
    power = torch.from_numpy(p)
    depths = tp.harmonic_depths(16)
    pv, pb = tp.harmonic_peaks_plain(tp.normalize_power(power), depths, 1,
                                     nbins)
    for cluster in harmonic_cuda.CLUSTER_SIZES:
        # bin 1 in the first slice, bin 1023 in the last
        s_bins = harmonic_cuda.slice_bins(nbins, cluster)
        assert 1023 // s_bins == -(-nbins // s_bins) - 1 > 0
        for candidates in (harmonic_cuda.CLUSTER_CANDIDATES, 1):
            rv, rb = _replay_harmonic(p, depths, 1, nbins, cluster,
                                      candidates)
            np.testing.assert_array_equal(rb, pb.numpy())
            np.testing.assert_array_equal(rv, pv.numpy())
    med = tp.normalize_power(power)
    assert float(power[1, 1] / med[1, 1]) == pytest.approx(4.0 / np.log(2))


def test_cluster_plan():
    # the main paths' rows: 8 blocks a period_search row (two blocks an
    # SM), 16 for its 2-row tail and the longer rows; rows no cluster
    # holds take the global branch
    sms = 132
    assert harmonic_cuda.choose_cluster(131073, 512, sms) == 8
    assert harmonic_cuda.choose_cluster(131073, 2, sms) == 16
    assert harmonic_cuda.choose_cluster(327681, 514, sms) == 16
    assert harmonic_cuda.choose_cluster(524289, 512, sms) == 16
    assert harmonic_cuda.choose_cluster(1048577, 512, sms) == 1
    for nbins in (2, 33, 4097, 131073, 524289, 834000):
        for c in harmonic_cuda.CLUSTER_SIZES:
            s_bins = harmonic_cuda.slice_bins(nbins, c)
            assert s_bins % 32 == 0 and c * s_bins >= nbins
            assert harmonic_cuda.cluster_fits(nbins, c) == (
                harmonic_cuda.cluster_smem_bytes(s_bins)
                <= harmonic_cuda.SMEM_PER_BLOCK)
    assert harmonic_cuda.cluster_smem_bytes(harmonic_cuda.MAX_SLICE) <= (
        harmonic_cuda.SMEM_PER_BLOCK) < harmonic_cuda.cluster_smem_bytes(
        harmonic_cuda.MAX_SLICE + 1)


def test_harmonic_wrapper_refuses_bad_inputs():
    with pytest.raises(ValueError, match="prefix"):
        harmonic_cuda.harmonic_peaks(torch.ones(2, 64), (1, 4), 1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        harmonic_cuda.harmonic_peaks_cuda(torch.ones(2, 64), (1, 2), 1, 64)
    with pytest.raises(ValueError, match="nbins"):
        harmonic_cuda.harmonic_peaks_cuda(torch.ones(2, 1), (1,), 1, 1)


def test_false_alarm_chain_matches_jax():
    p = np.array([0.0, 1e-3, 0.5, 3.0, 40.0, 900.0], np.float32)
    for nsum in (1, 2, 16):
        np.testing.assert_allclose(
            tp.power_sf_log(torch.from_numpy(p), nsum=nsum).numpy(),
            np.asarray(jp.power_sf_log(jnp.asarray(p), nsum=nsum, xp=jnp)),
            rtol=1e-6, atol=3e-7, equal_nan=True)  # -p + lse cancels near 1
        np.testing.assert_allclose(
            tp.power_sf_log(p.astype(np.float64), nsum=nsum).numpy(),
            jp.power_sf_log(p.astype(np.float64), nsum=nsum), rtol=1e-12,
            atol=1e-15, equal_nan=True)
    lsf = np.array([-1e4, -50.0, -1.0, 0.0])
    np.testing.assert_allclose(tp.sf_log_to_sigma(lsf).numpy(),
                               jp.sf_log_to_sigma(lsf), rtol=1e-12)
    np.testing.assert_array_equal(
        tp.harmonic_sum(torch.from_numpy(p[None]), 3).numpy(),
        jp.harmonic_sum(p[None], 3))


def test_h_test_batch_and_folding_match_jax():
    rng = np.random.default_rng(2)
    series = rng.standard_normal(20000).astype(np.float32)
    series[::97] += 3.0
    freqs = jp.refine_grid(1 / (97 * TSAMP), TSAMP, series.size)
    profiles, hits = tp.fold_batch(torch.from_numpy(series), freqs, TSAMP)
    jprof, jhits = jp.fold_batch(jnp.asarray(series), freqs, TSAMP, xp=jnp)
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jhits))
    np.testing.assert_allclose(profiles.numpy(), np.asarray(jprof),
                               rtol=1e-5, atol=1e-4)
    h, m, _ = tp.epoch_folding_search(torch.from_numpy(series), TSAMP, freqs)
    # the JAX package's eager fold + score: the same bins, H within float32
    # reduction order
    jh, jm = jp._epoch_fold_score(jnp.asarray(series), jprof, jhits, 8, jnp)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5)
    # its jitted program may contract the phase arithmetic (FMA) and bin
    # a few samples of other trials elsewhere; the best trial and its m
    # agree
    jh, jm, _ = jp.epoch_folding_search(jnp.asarray(series), TSAMP, freqs,
                                        xp=jnp)
    best = int(torch.argmax(h))
    assert best == int(np.argmax(np.asarray(jh)))
    assert int(m[best]) == int(np.asarray(jm)[best])
    one, _ = tp.fold(torch.from_numpy(series), freqs[3], TSAMP)
    np.testing.assert_array_equal(one.numpy(), profiles[3].numpy())
    prof = np.abs(rng.normal(size=(5, 32))) * 10
    for total in (None, 123.0):
        ht, mt = trobust.h_test_batch(torch.from_numpy(prof), nmax=8,
                                      total=total)
        hj, mj = jrobust.h_test_batch(prof, nmax=8, total=total)
        np.testing.assert_allclose(ht.numpy(), hj, rtol=1e-12)
        np.testing.assert_array_equal(mt.numpy(), mj)


def test_period_search_plane_matches_jax():
    rng = np.random.default_rng(4)
    t = 8192
    plane = rng.standard_normal((24, t)).astype(np.float32)
    period = 0.0371
    phase = (np.arange(t) * TSAMP / period) % 1.0
    plane[9] += 2.0 * np.exp(-0.5 * (np.minimum(phase, 1 - phase)
                                     / 0.03) ** 2)
    kw = dict(fmin=4.0 / (t * TSAMP), refine_top=1)
    got = tp.period_search_plane(torch.from_numpy(plane), TSAMP, **kw)
    ref = jp.period_search_plane(jnp.asarray(plane), TSAMP, xp=jnp, **kw)
    assert got["best_dm_index"] == ref["best_dm_index"] == 9
    assert got["best_freq"] == ref["best_freq"]
    assert got["best_m"] == ref["best_m"]
    np.testing.assert_allclose(got["best_h"], ref["best_h"], rtol=1e-3)
    np.testing.assert_allclose(got["best_sigma"], ref["best_sigma"],
                               rtol=1e-3)
    np.testing.assert_array_equal(got["nharm"], ref["nharm"])


def test_stretch_tables_and_grids_equal_jax():
    accels = np.array([-3e5, 0.0, 2.5e5])
    for jerks in (None, np.array([1e3])):
        np.testing.assert_array_equal(
            taccel.stretch_index_table(accels, 50000, 5e-4, jerks=jerks),
            jaccel.stretch_index_table(accels, 50000, 5e-4, jerks=jerks))
    np.testing.assert_array_equal(taccel.accel_grid(1e5, 5e-4, 1 << 16),
                                  jaccel.accel_grid(1e5, 5e-4, 1 << 16))
    np.testing.assert_array_equal(taccel.jerk_grid(5e3, 5e-4, 1 << 16),
                                  jaccel.jerk_grid(5e3, 5e-4, 1 << 16))
    for ours, theirs in zip(taccel.trial_product(accels, [0.0, 1.0]),
                            jaccel.trial_product(accels, [0.0, 1.0])):
        np.testing.assert_array_equal(ours, theirs)
    x = np.arange(12.0).reshape(2, 6)
    idx = np.array([0, 2, 2, 5])
    np.testing.assert_array_equal(stretch_resample(torch.from_numpy(x),
                                                   idx).numpy(),
                                  jax_stretch(x, idx))
    series = np.random.default_rng(0).normal(size=4000)
    np.testing.assert_array_equal(
        taccel.fractional_resample(series, 4e5, 5e-4),
        jaccel.fractional_resample(series, 4e5, 5e-4))


def test_accel_search_matches_jax_cell_for_cell():
    arr, _ = jsim.simulate_accel_pulsar_data(
        freq=60.0, accel=2e5, nsamples=8192, nchan=8, rng=3)
    plane = (arr[:, :] - arr.mean()).astype(np.float32)
    accels = np.linspace(-4e5, 4e5, 5)
    kw = dict(max_harmonics=8, fmin=5.0, topk=12)
    ref = jaccel.accel_search(plane, 5e-4, accels, xp=jnp, **kw)
    got = taccel.accel_search(plane, 5e-4, accels, device="cpu", **kw)
    assert got.keys() == ref.keys()
    for key in ref:
        if np.asarray(ref[key]).dtype.kind in "iu":
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5,
                                       err_msg=key)


def test_accumulator_plane_byte_equal_and_snapshots(tmp_path):
    plan = ChunkPlan(step=4096, hop=2048, resample=2, sample_time=1e-3)
    jplan = JaxChunkPlan(step=4096, hop=2048, resample=2, sample_time=1e-3)
    starts = [0, 2048, 4096, 6144]
    nsamples = 9000
    ours = tacc.DMTimeAccumulator(plan, nsamples, starts, 6, rebin=4)
    ref = jacc.DMTimeAccumulator(jplan, nsamples, starts, 6, rebin=4)
    rng = np.random.default_rng(1)
    planes = {s: rng.standard_normal(
        (6, min(4096, nsamples - s) // 2)).astype(np.float32)
        for s in starts}
    for s in (2048, 0, 6144):   # any order
        assert ours.consume(s, torch.from_numpy(planes[s]))
        ref.consume(s, planes[s])
    assert not ours.consume(0, torch.from_numpy(planes[0]))   # de-duplicated
    np.testing.assert_array_equal(ours.plane, ref.plane)
    assert ours.plane.tobytes() == ref.plane.tobytes()
    # a snapshot round-trips, and each package reads the other's
    ours.save(tmp_path / "ours.npz")
    ref.save(tmp_path / "ref.npz")
    back = tacc.DMTimeAccumulator(plan, nsamples, starts, 6, rebin=4)
    assert back.restore(tmp_path / "ref.npz")
    jback = jacc.DMTimeAccumulator(jplan, nsamples, starts, 6, rebin=4)
    assert jback.restore(tmp_path / "ours.npz")
    for acc in (back, jback):
        np.testing.assert_array_equal(acc.plane, ours.plane)
        assert acc.seen == {0, 2048, 6144}
    back.consume(4096, torch.from_numpy(planes[4096]))
    ref.consume(4096, planes[4096])
    assert back.complete and back.coverage == 1.0
    np.testing.assert_array_equal(back.plane, ref.plane)
    (tmp_path / "torn.npz").write_bytes(b"PK\x03\x04torn")
    assert not back.restore(tmp_path / "torn.npz")
    assert (tmp_path / "torn.npz.corrupt").exists()
    assert tacc.choose_rebin(4096, 1 << 24, 1 << 12, budget_bytes=1 << 28) \
        == jacc.choose_rebin(4096, 1 << 24, 1 << 12, budget_bytes=1 << 28)
    assert tacc.default_budget_bytes("cpu") == jacc.DEFAULT_HOST_PLANE_BYTES


def _cands(seed=0, n=40):
    rng = np.random.default_rng(seed)
    base = [10.0, 23.7, 50.0, 61.3]
    out = []
    for i in range(n):
        f = base[i % 4] * rng.choice([1, 1, 2, 3, 0.5]) \
            + rng.normal(0, 0.002)
        out.append({"dm_index": int(rng.integers(0, 30)),
                    "dm": float(rng.uniform(100, 200)),
                    "accel_index": int(rng.integers(0, 3)), "accel": 0.0,
                    "jerk_index": 0, "jerk": 0.0, "freq": float(f),
                    "freq_bin": int(f * 100), "nharm": 4,
                    "power": 10.0, "log_sf": -30.0,
                    "sigma": float(rng.uniform(8, 40))})
    return out


def test_sift_and_zap_equal_jax(tmp_path):
    zap = tcands.ZapList()
    zap.add(50.0, 0.05, harmonics=2, note="mains")
    zap.save(tmp_path / "zap.json")
    jzap = jcands.ZapList.load(tmp_path / "zap.json")
    assert jzap.entries == zap.entries
    jzap.save(tmp_path / "jzap.json")
    assert (tmp_path / "jzap.json").read_bytes() \
        == (tmp_path / "zap.json").read_bytes()
    assert tcands.ZapList.load(tmp_path / "missing.json").entries == []
    for freq_tol in (None, 0.01):
        kept, stats = tcands.sift_candidates(_cands(), zap=zap,
                                             freq_tol=freq_tol)
        jkept, jstats = jcands.sift_candidates(_cands(), zap=jzap,
                                               freq_tol=freq_tol)
        assert stats == jstats
        assert [(c["freq"], c["dm_index"]) for c in kept] \
            == [(c["freq"], c["dm_index"]) for c in jkept]
    for pair in ((10.0, 20.02), (30.0, 10.0), (10.0, 10.0), (0.0, 3.0)):
        assert tcands.harmonic_ratio(*pair) == jcands.harmonic_ratio(*pair)
    table = {k: np.asarray([c[k] for c in _cands(1, 10)])
             for k in _cands()[0]}
    table["freq"][2] = 0.0
    assert tcands.candidate_list(table, None, 20.0) \
        == jcands.candidate_list(table, None, 20.0)


def test_candidate_files_carry_across(tmp_path):
    cands = _cands(2, 5)
    for i, c in enumerate(cands):
        c.update(freq_refined=c["freq"] + 1e-4, h=50.0 + i, m=3,
                 profile=np.arange(16, dtype=np.float32) * i)
    meta = {"fname": "x.fil", "n_accel": 5}
    tcands.save_candidates(tmp_path / "ours.npz", cands, meta=meta)
    jcands.save_candidates(tmp_path / "ref.npz", cands, meta=meta)
    for loader, path in ((jcands.load_candidates, "ours.npz"),
                         (tcands.load_candidates, "ref.npz")):
        got, got_meta = loader(tmp_path / path)
        assert got_meta == meta
        for a, b in zip(got, cands):
            assert a["freq"] == b["freq"] and a["m"] == b["m"]
            np.testing.assert_array_equal(a["profile"], b["profile"])
    assert (tmp_path / "ours.npz").read_bytes() \
        == (tmp_path / "ref.npz").read_bytes()


def test_simulators_equal_jax():
    a, h = tsim.simulate_pulsar_data(nsamples=2048, nchan=16, rng=5)
    b, g = jsim.simulate_pulsar_data(nsamples=2048, nchan=16, rng=5)
    np.testing.assert_array_equal(a, b)
    assert h == g
    a, h = tsim.simulate_accel_pulsar_data(accel=3e5, jerk=1e3,
                                           nsamples=2048, rng=6)
    b, g = jsim.simulate_accel_pulsar_data(accel=3e5, jerk=1e3,
                                           nsamples=2048, rng=6)
    np.testing.assert_array_equal(a, b)
    assert h == g


# ---------------------------------------------------------------------------
# the drivers end to end
# ---------------------------------------------------------------------------

PSR_TSAMP, PSR_NCHAN, PSR_NSAMPLES = 0.0005, 32, 16384
PSR_DM, PSR_F0, PSR_ACCEL = 150.0, 492 / (16384 * 0.0005), 9.0e5
JOB = dict(dmmin=130.0, dmmax=170.0, accel_max=1.8e6, n_accel=9,
           sigma_threshold=8.0, chunk_length=4096 * PSR_TSAMP,
           snr_threshold=8.0)


@pytest.fixture(scope="module")
def pulsar_file(tmp_path_factory):
    arr, hdr = jsim.simulate_accel_pulsar_data(
        freq=PSR_F0, dm=PSR_DM, accel=PSR_ACCEL, tsamp=PSR_TSAMP,
        nsamples=PSR_NSAMPLES, nchan=PSR_NCHAN, rng=13)
    path = tmp_path_factory.mktemp("psr") / "binary.fil"
    jax_write_filterbank(str(path), arr, hdr, descending=True)
    return str(path)


def _top(res):
    best = res["candidates"][0]
    return (best["dm"], best["accel"], best["freq_bin"], best["nharm"])


def test_periodicity_driver_matches_jax(pulsar_file, tmp_path):
    ref = jax_periodicity_search(pulsar_file, output_dir=str(tmp_path / "j"),
                                 progress=False, **JOB)
    res = periodicity_search(pulsar_file, output_dir=str(tmp_path / "t"),
                             device="cpu", **JOB)
    assert res["complete"] and _top(res) == _top(ref)
    assert abs(res["candidates"][0]["accel"] - PSR_ACCEL) < 1.0
    assert res["candidates"][0]["freq_bin"] == 492
    # the candidate file loads in the JAX package
    cands, meta = jcands.load_candidates(res["candidates_path"])
    assert meta["accel_backend"] == "time_stretch"
    assert (cands[0]["dm"], cands[0]["freq_bin"]) == _top(res)[::2]
    # resume: every chunk is in the ledger and the snapshot; nothing
    # streams again and the answer is the same
    calls = []
    again = periodicity_search(pulsar_file, output_dir=str(tmp_path / "t"),
                               device="cpu", chunk_cb=calls.append, **JOB)
    assert calls == [] and _top(again) == _top(res)
    # the canary is recovered and its rows leave the science list
    canary = periodicity_search(pulsar_file,
                                output_dir=str(tmp_path / "canary"),
                                device="cpu", canary=True, **JOB)
    assert canary["canary"]["recovered"]
    assert _top(canary) == _top(res)


def test_periodicity_driver_refuses_what_is_not_ported(pulsar_file):
    # fdas and the mesh are ported (tests/test_torch_fdas.py,
    # tests/test_torch_mesh_period.py); an unknown backend, and a mesh
    # without the axes the chunk search needs, are refused
    from pulsarutils_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="accel_backend"):
        periodicity_search(pulsar_file, accel_backend="stretch",
                           device="cpu")
    with pytest.raises(ValueError, match="must include"):
        periodicity_search(pulsar_file, device="cpu", mesh=make_mesh(
            (2,), ("dm",), devices=[torch.device("cpu")] * 2))
    # the service hooks are ported (tests/test_torch_service.py), and so
    # is the fleet's epoch fence (tests/test_torch_fleet_recovery.py): a
    # fenced call is refused only for what the driver owns
    with pytest.raises(ValueError, match="owned"):
        periodicity_search(pulsar_file, fence=1, period_search=True,
                           device="cpu")
    with pytest.raises(ValueError, match="owned"):
        periodicity_search(pulsar_file, period_search=True, device="cpu")


def test_period_cli(pulsar_file, tmp_path, capsys):
    rc = period_main.main([pulsar_file, "--dmmin", "130", "--dmmax", "170",
                           "--accel-max", "1.8e6", "--n-accel", "9",
                           "--chunk-length", "2.048", "--snr-threshold", "8",
                           "--output-dir", str(tmp_path), "--device", "cpu",
                           "--json"])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert lines and lines[0]["freq_bin"] == 492
    assert list(tmp_path.glob("period_cands_*.npz"))


def test_per_chunk_period_search_matches_jax(pulsar_file, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv("PUTPU_AUTOTUNE", "off")
    kw = dict(dmmin=130.0, dmmax=170.0, chunk_length=4096 * PSR_TSAMP,
              snr_threshold=50.0, period_search=True,
              period_sigma_threshold=8.0)
    ref, _ = jax_search_by_chunks(pulsar_file, output_dir=str(tmp_path / "j"),
                                  backend="jax", kernel="pallas",
                                  make_plots=False, progress=False, **kw)
    hits, store = search_by_chunks(pulsar_file, device="cpu",
                                   output_dir=str(tmp_path / "t"), **kw)
    assert [h[0] for h in hits] == [h[0] for h in ref] and hits
    for (_, _, info, _), (_, _, rinfo, _) in zip(hits, ref):
        assert info.period_freq == rinfo.period_freq
        assert info.period_dm == rinfo.period_dm
        assert info.period_M == rinfo.period_M
        np.testing.assert_allclose(info.period_sigma, rinfo.period_sigma,
                                   rtol=1e-3)
        assert info.fold_profile.shape == rinfo.fold_profile.shape
    # the persisted record carries the periodic fields
    info, _ = store.load_candidate("binary", hits[0][0], hits[0][1])
    assert info.period_freq == hits[0][2].period_freq


def test_fingerprint_hashes_period_search_and_extra(pulsar_file):
    base = dict(dmmin=130.0, dmmax=170.0, chunk_length=2.048)
    plain = plan_survey(pulsar_file, **base)["fingerprint"]
    assert plan_survey(pulsar_file, **base)["fingerprint"] == plain
    periodic = plan_survey(pulsar_file, period_search=True,
                           **base)["fingerprint"]
    loose = plan_survey(pulsar_file, period_search=True,
                        period_sigma_threshold=6.0, **base)["fingerprint"]
    extra = plan_survey(pulsar_file, fingerprint_extra={"workload": "p"},
                        **base)["fingerprint"]
    assert len({plain, periodic, loose, extra}) == 4


def test_plane_consumer_and_chunk_subset(pulsar_file, tmp_path):
    seen = []

    def consumer(istart, plane, table):
        assert plane.shape == (table.nrows, 8192)
        seen.append(istart)

    starts = plan_survey(pulsar_file, chunk_length=2.048)["chunk_starts"]
    assert starts == [0, 4096, 8192]
    _, store = search_by_chunks(
        pulsar_file, dmmin=130.0, dmmax=170.0, chunk_length=2.048,
        plane_consumer=consumer, chunks=[8192, 4096, 999], device="cpu",
        output_dir=str(tmp_path))
    assert seen == [4096, 8192] and store.done_chunks == [4096, 8192]


def _period_series(registry):
    return {(m["name"], tuple(sorted(m["labels"].items()))): m["value"]
            for m in registry.snapshot()
            if m["name"] in ("putpu_period_chunks_accumulated_total",
                             "putpu_period_snapshot_writes_total",
                             "putpu_period_sift_rejected_total",
                             "putpu_period_folds_total")}


def test_periodicity_job_series_equal_jax(pulsar_file, tmp_path):
    """A periodicity job in each package: the chunks accumulated, the
    snapshot writes, the sift's rejections by reason and the folds are
    counted alike."""
    from pulsarutils_tpu.obs.metrics import REGISTRY as JAX_REGISTRY
    from pulsarutils_tpu_torch.obs.metrics import REGISTRY

    JAX_REGISTRY.reset()
    REGISTRY.reset()
    ref = jax_periodicity_search(pulsar_file, output_dir=str(tmp_path / "j"),
                                 progress=False, **JOB)
    res = periodicity_search(pulsar_file, output_dir=str(tmp_path / "t"),
                             device="cpu", **JOB)
    assert _top(res) == _top(ref)
    ours, theirs = _period_series(REGISTRY), _period_series(JAX_REGISTRY)
    assert ours == theirs
    assert ours[("putpu_period_chunks_accumulated_total", ())] > 1
    assert ours[("putpu_period_snapshot_writes_total", ())] > 1
    assert ours[("putpu_period_folds_total", ())] >= 1
    assert any(name == "putpu_period_sift_rejected_total"
               for name, _ in ours)
    JAX_REGISTRY.reset()
    REGISTRY.reset()
