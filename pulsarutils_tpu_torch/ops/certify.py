"""Per-config soundness bounds for the hybrid search (host math).

A copy of the JAX package's ``ops/certify.py``: a lower bound on how
much of a real pulse's exact S/N the coarse (FDMT) sweep retains,
computed exactly per search configuration from the transform's own merge
tables (:func:`~.fdmt.fdmt_tracks`), and the noise
certificate built on it.  Float64 NumPy on the host; the tests pin every
function's values equal to the reference's.

Signal model: **impulsive signals** — one coherent pulse per channel
riding a dispersion track, width >= ``min_width`` samples, any alignment.

Noise certificate: for a detection floor ``s``, any pulse with exact S/N
>= ``s`` shows a sliding certificate score >= ``rho * s - slack``; when
no coarse row reaches that level the chunk is certified signal-free at
``s`` and the exact rescoring is skipped.  The slack absorbs the
Gaussian noise cross-term (sd <= 1 S/N unit): an at-floor worst-phase
pulse evades the certificate with probability up to ``Phi(-slack)``
(:func:`cert_miss_p_at_floor`), recorded in ``table.meta``.

Detection floors at long chunks: :func:`expected_noise_max_snr` /
:func:`matched_snr_floor` compute the statistically matched floor for a
chunk geometry, :func:`certifiable_snr_floor` the lowest floor whose
certificate fires on typical signal-free chunks.
"""

from __future__ import annotations

import functools

import numpy as np


def _windows():
    """The detection scorer's boxcar widths — imported lazily from the
    single source of truth so the bounds can never silently diverge
    from the scorer."""
    from .search import SEARCH_WINDOWS

    return SEARCH_WINDOWS


#: absolute S/N slack in the certificate inequality
#: ``coarse >= rho * exact - HYBRID_CERT_SLACK``: the allowance for the
#: stochastic noise cross-term (the pulse's scattered energy interacting
#: with the noise already in its bins) and sub-sample pulse phase.  The
#: cross-term is Gaussian-tailed with sd <= 1 in S/N units, so this
#: value IS a z-score, not a hard bound: an at-floor worst-case-phase
#: pulse evades the certificate with probability up to ``Phi(-slack)``
#: (~0.31 at 0.5) — see :func:`cert_slack_for_miss_p` to derive the
#: slack from a target miss probability instead.  The 0.5 default is the
#: JAX package's empirically supported operating point, chosen to keep
#: ``certifiable_snr_floor`` low; it is NOT a proof.
HYBRID_CERT_SLACK = 0.5

#: upper bound on the certificate noise cross-term's standard deviation
#: in S/N units (see :func:`cert_slack_for_miss_p` for the argument)
CERT_CROSS_TERM_SD = 1.0


def cert_slack_for_miss_p(miss_p):
    """Certificate slack achieving an at-floor miss probability <= ``miss_p``.

    Derivation: write the coarse row's certificate score for a pulse of
    exact S/N ``s`` as ``cert = rho_realised * s + Z`` where
    ``rho_realised >= rho`` (the computed deterministic retention bound)
    and ``Z`` is the noise already in the certificate's best capture
    window.  For a width-``w`` sliding window, ``Z`` is a sum of ``w``
    iid unit-variance noise samples divided by ``std * sqrt(w)`` — unit
    variance; taking the max over windows and alignments only *raises*
    the realised score, so ``P(cert < rho * s - slack) <=
    P(Z < -slack) = Phi(-slack / CERT_CROSS_TERM_SD)``.  Hence
    ``slack = CERT_CROSS_TERM_SD * Phi^{-1}(1 - miss_p)`` guarantees an
    at-floor miss probability <= ``miss_p`` *for the worst-case phase
    and width*; pulses above the floor gain ``rho * (s - floor)`` extra
    margin on top.

    Note the cost: a 1e-3 target needs slack ~3.1, which raises
    :func:`certifiable_snr_floor` by ``(3.1 - 0.5) / rho`` (~4.3 S/N at
    rho = 0.6) over the default operating point — the price of a stated
    guarantee instead of an empirical allowance.
    """
    from statistics import NormalDist

    if not 0.0 < miss_p < 1.0:
        raise ValueError(f"miss_p={miss_p!r}: expected a probability in "
                         "(0, 1)")
    return CERT_CROSS_TERM_SD * NormalDist().inv_cdf(1.0 - float(miss_p))


def cert_miss_p_at_floor(slack=None):
    """At-floor worst-case miss probability implied by ``slack``
    (``Phi(-slack / CERT_CROSS_TERM_SD)``, the inverse of
    :func:`cert_slack_for_miss_p`) — the residual-risk number recorded
    in ``table.meta`` alongside ``certified``."""
    from statistics import NormalDist

    if slack is None:
        slack = HYBRID_CERT_SLACK
    return NormalDist().cdf(-float(slack) / CERT_CROSS_TERM_SD)


def cert_meta(certified, rho_cert, snr_floor, cert_slack=None):
    """The hybrid search's certificate block of ``table.meta``.

    ``cert_miss_p_at_floor`` is recorded only when there was actually a
    floor for the number to refer to (``snr_floor`` set and the bound
    computed); ``cert_slack`` is always recorded — the skip criterion
    uses it even on floorless runs.
    """
    slack_used = (HYBRID_CERT_SLACK if cert_slack is None
                  else float(cert_slack))
    return {"certified": certified, "rho_cert": rho_cert,
            "snr_floor": snr_floor, "cert_slack": slack_used,
            "cert_miss_p_at_floor": (
                round(cert_miss_p_at_floor(slack_used), 4)
                if rho_cert is not None and snr_floor is not None
                else None)}


def _retention_from_offsets(offsets, weights=None, min_width=1):
    """Worst-case coarse/exact S/N ratio given per-channel track offsets.

    ``offsets`` is the signed per-channel deviation (samples) of the
    coarse track from the exact track for one trial.  A width-``W`` pulse
    (amplitude spread uniformly over ``W`` samples per channel) that the
    exact kernel sees as a clean ``W``-sample box becomes, in the coarse
    row, the box convolved with the offset histogram.  Both series are
    scored identically (block sums of widths 1/2/4/8, ``max/std``), so
    the retention at pulse phase ``p`` is the ratio of the best
    block-capture of the scattered mass to the best block-capture of the
    clean box; the bound takes the worst phase.  Noise std is identical
    in both series (each channel contributes exactly one sample per bin
    in either kernel), so S/N ratio == capture ratio.
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    offsets = offsets - offsets.min()
    if weights is None:
        weights = np.full(offsets.shape, 1.0 / len(offsets))
    span = int(offsets.max()) + 1
    h = np.zeros(span)
    np.add.at(h, offsets, weights)
    h /= h.sum()
    w_pulse = int(min_width)
    # mass distributions over absolute bins, pulse starting at phase p:
    # exact = box of width W at [p, p+W); coarse = same box convolved
    # with h -> support [p, p + W + span - 1)
    box = np.full(w_pulse, 1.0 / w_pulse)
    coarse_mass = np.convolve(h, box)
    worst = np.inf
    for p in range(8):  # lcm of the window widths
        def best_score(mass):
            best = 0.0
            for w in _windows():
                bins = p + np.arange(len(mass))
                blocks = bins // w
                cap = np.zeros(blocks[-1] + 1)
                np.add.at(cap, blocks, mass)
                best = max(best, cap.max() / np.sqrt(w))
            return best

        exact_score = best_score(box)
        coarse_score = best_score(coarse_mass)
        worst = min(worst, coarse_score / exact_score)
    return float(worst)


@functools.lru_cache(maxsize=64)
def _exact_best_phase(width):
    """Best block-boxcar score of a clean width-``width`` box (in total-
    mass units), over all windows AND phases — the soundness-relevant
    denominator of the certificate ratio.  Depends on ``width`` alone,
    so it is memoised (cert_retention evaluates it once per trial x
    width otherwise — a multi-second host stall at multi-thousand-trial
    configs)."""
    box = np.full(width, 1.0 / width)
    best = 0.0
    for w in _windows():
        # best phase: the box starts on a block boundary; blocks
        # capture min(w, width)/width contiguously
        for p in range(8):
            bins = p + np.arange(width)
            blocks = bins // w
            cap = np.zeros(blocks[-1] + 1)
            np.add.at(cap, blocks, box)
            best = max(best, cap.max() / np.sqrt(w))
    return best


def _cert_retention_from_offsets(offsets, max_width=16):
    """Worst-case ``cert_score / exact_snr`` ratio for one trial's track.

    The certificate numerator is the *sliding* window-2/4 capture
    (:func:`~pulsarutils_tpu.ops.search.cert_profile_scores`) — phase
    invariant, so no worst-phase minimisation applies to it; the
    denominator is the exact kernel's best detection score of the same
    pulse, taken at the pulse's *best* phase (the soundness-relevant
    worst case: the exact sweep scoring the pulse as well as it possibly
    can while the coarse row still must flag it).  Minimised over pulse
    widths 1..``max_width``; beyond the scorer's largest block (8) both
    sides decay ~1/W and the ratio tends to a constant ~0.7, so the
    minimum always sits at small widths.
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    offsets = offsets - offsets.min()
    span = int(offsets.max()) + 1
    h = np.zeros(span)
    np.add.at(h, offsets, 1.0 / len(offsets))

    from .search import CERT_WINDOWS

    def sliding_capture(mass, w):
        if len(mass) <= w:
            return mass.sum()
        kernel = np.ones(w)
        return np.convolve(mass, kernel).max()

    worst = np.inf
    for width in range(1, max_width + 1):
        mass = np.convolve(h, np.full(width, 1.0 / width))
        cert = max(sliding_capture(mass, w) / np.sqrt(w)
                   for w in CERT_WINDOWS)
        worst = min(worst, cert / _exact_best_phase(width))
    return float(worst)


def _track_deviations(nchan, trial_dms, start_freq, bandwidth, sample_time,
                      nsamples):
    """Signed per-channel deviation of each plan trial's mapped coarse
    row from the exact kernel's integer offsets: ``(ndm, nchan)``."""
    from .fdmt import fdmt_plan, fdmt_tracks, fdmt_trial_dms
    from .plan import dedispersion_shifts_batch, normalize_shifts
    from .search import nearest_rows

    trial_dms = np.asarray(trial_dms, dtype=np.float64)
    fdmt_dms, n_lo, n_hi = fdmt_trial_dms(
        nchan, float(trial_dms.min()), float(trial_dms.max()), start_freq,
        bandwidth, sample_time)
    plan = fdmt_plan(nchan, float(start_freq), float(bandwidth), n_hi, n_lo)
    tracks = fdmt_tracks(plan)[:, :nchan]
    idx = nearest_rows(fdmt_dms, trial_dms)

    shifts = dedispersion_shifts_batch(trial_dms, nchan, start_freq,
                                       bandwidth, sample_time)
    exact = normalize_shifts(shifts, nsamples).astype(np.int64)
    dev = (tracks[idx] % nsamples) - exact
    # wrap to signed: a track and an offset that agree mod T are the
    # same gather; centre the deviation on the dominant branch
    return (dev + nsamples // 2) % nsamples - nsamples // 2


@functools.lru_cache(maxsize=32)
def _retention_cached(nchan, dms_key, start_freq, bandwidth, sample_time,
                      nsamples, min_width, cert):
    trial_dms = np.frombuffer(dms_key, dtype=np.float64)
    dev = _track_deviations(nchan, trial_dms, start_freq, bandwidth,
                            sample_time, nsamples)
    rho = np.empty(len(trial_dms))
    for j in range(len(trial_dms)):
        if cert:
            rho[j] = _cert_retention_from_offsets(dev[j])
        else:
            rho[j] = _retention_from_offsets(dev[j], min_width=min_width)
    return rho


def coarse_retention(nchan, trial_dms, start_freq, bandwidth, sample_time,
                     nsamples, min_width=1):
    """Per-trial worst-case ``coarse_snr / exact_snr`` retention (block
    detection scorer on both sides).

    Computed exactly from the transform's merge tables (no data, no
    noise); see the module docstring for the signal model.  ``min_width``
    is the narrowest pulse width (samples) the bound must cover — wider
    pulses always retain more, so 1 is fully conservative.  This is the
    quantity that justifies (and per-config recalibrates)
    ``search.HYBRID_COARSE_TRUST``.

    Returns a ``(ndm,)`` float array in ``(0, 1]``.
    """
    trial_dms = np.ascontiguousarray(trial_dms, dtype=np.float64)
    return _retention_cached(int(nchan), trial_dms.tobytes(),
                             float(start_freq), float(bandwidth),
                             float(sample_time), int(nsamples),
                             int(min_width), False)


def cert_retention(nchan, trial_dms, start_freq, bandwidth, sample_time,
                   nsamples):
    """Per-trial worst-case ``cert_score / exact_snr`` retention (the
    sliding certificate scorer as numerator — phase-invariant, so much
    tighter than :func:`coarse_retention` at the same track scatter:
    ~0.6 vs ~0.44 at the benchmark config).  Returns ``(ndm,)``."""
    trial_dms = np.ascontiguousarray(trial_dms, dtype=np.float64)
    return _retention_cached(int(nchan), trial_dms.tobytes(),
                             float(start_freq), float(bandwidth),
                             float(sample_time), int(nsamples), 1, True)


def retention_bound(nchan, trial_dms, start_freq, bandwidth, sample_time,
                    nsamples, min_width=1, cert=False):
    """``min`` over trials of :func:`coarse_retention` (or
    :func:`cert_retention` with ``cert=True``) — the single per-config
    constant the hybrid's margin and certificate use."""
    fn = cert_retention if cert else functools.partial(coarse_retention,
                                                       min_width=min_width)
    return float(fn(nchan, trial_dms, start_freq, bandwidth, sample_time,
                    nsamples).min())


def fused_cert_params(nchan, trial_dms, start_freq, bandwidth, sample_time,
                      nsamples, snr_floor=None, rho_cert=None,
                      cert_slack=None):
    """The ``(rho, slack, floor)`` float32 operand of the hybrid's fused
    seed program (``ops/search.py:_fused_seed``), whose need stage it
    parameterises: ``rho = +inf`` disables the device's certificate
    terms (the consistency guards still fire), ``floor = +inf`` the floor
    terms.  ``rho_cert=None`` computes the retention bound, the same
    cached computation the certificate gate performs, under the
    ``search/cert_floor`` budget bucket so a cache miss cannot hide
    inside the fused search."""
    from ..utils.logging_utils import budget_bucket

    if rho_cert is False:
        rho_val = np.inf
    elif rho_cert is not None:
        rho_val = float(rho_cert)
    else:
        with budget_bucket("search/cert_floor"):
            rho_val = retention_bound(nchan, trial_dms, start_freq,
                                      bandwidth, sample_time, nsamples,
                                      cert=True)
    slack_val = (HYBRID_CERT_SLACK if cert_slack is None
                 else float(cert_slack))
    floor_val = np.inf if snr_floor is None else float(snr_floor)
    return np.asarray([rho_val, slack_val, floor_val], np.float32)


def certify_noise_only(cert_scores, snr_floor, rho_cert_min,
                       coarse_snrs=None, slack=None):
    """True iff the coarse sweep certifies no pulse reaches ``snr_floor``
    (under the stated impulsive-signal model, up to the Gaussian noise
    cross-term the ``slack`` absorbs — see the module docstring's *Miss
    risk* section for the residual probability).

    The certificate inequality: an impulsive signal with exact S/N ``s``
    shows a sliding certificate score ``>= rho_cert_min * s - slack``
    (up to the cross-term); when every trial's certificate score sits
    below ``rho_cert_min * snr_floor - slack``, no trial's exact S/N
    reaches the floor.  ``slack`` defaults to :data:`HYBRID_CERT_SLACK`;
    derive it from a target miss probability with
    :func:`cert_slack_for_miss_p`.

    ``coarse_snrs`` (the block detection scores), when given, add a
    consistency guard: a chunk whose coarse BLOCK score already reaches
    the floor is never certified, whatever the sliding scores say.  For
    impulsive signals the sliding capture dominates and the guard is
    redundant; for non-impulsive junk (e.g. a single-sample spike
    flanked by negative dips after aggressive RFI filtering — outside
    the signal model) it prevents the absurd state of a chunk counted
    signal-free while its own table shows an above-floor score.
    """
    if snr_floor is None:
        return False
    if slack is None:
        slack = HYBRID_CERT_SLACK
    threshold = rho_cert_min * float(snr_floor) - float(slack)
    ok = bool(np.max(cert_scores) < threshold)
    if ok and coarse_snrs is not None:
        ok = bool(np.max(coarse_snrs) < float(snr_floor))
    return ok


def certifiable_snr_floor(nsamples, ndm, rho_cert_min, margin=0.75,
                          slack=None):
    """The smallest detection floor whose noise certificate actually
    fires on typical signal-free chunks of this geometry.

    The certificate threshold ``rho * floor - slack`` must clear the
    chunk's expected signal-free certificate-score maximum (plus
    ``margin`` Gumbel spread); below this floor the certificate is still
    *valid* but never triggers, and the hybrid pays the full
    exact-argbest localisation on every chunk.  ``slack`` defaults to
    :data:`HYBRID_CERT_SLACK`; a slack derived from a stricter miss
    probability (:func:`cert_slack_for_miss_p`) raises the floor
    proportionally.
    """
    if slack is None:
        slack = HYBRID_CERT_SLACK
    ceiling = expected_noise_max_snr(nsamples, ndm) + float(margin)
    return (ceiling + float(slack)) / float(rho_cert_min)


# ---------------------------------------------------------------------------
# Matched detection floors for long chunks
# ---------------------------------------------------------------------------

def expected_noise_max_snr(nsamples, ndm=1):
    """Expected maximum certificate score of a signal-free chunk.

    Gumbel location for an effective count ``m = 6 * nsamples * ndm``.
    The multiplier was FIT to seeded half-normal-noise simulation of the
    full hybrid coarse+cert scorer; it bundles the sliding-window
    multiplicity, the boxcar family, and the noise skew.  The Gumbel
    scale is ``1 / sqrt(2 ln m)`` (~0.15-0.19 at these sizes), so
    chunk-to-chunk maxima spread by a few tenths.

    FIT DOMAIN (extrapolate with care): half-normal iid noise after the
    pipeline's renormalisation, T = 4k-32k, ndm ~ 60-300 (original fit
    T = 8k/16k/32k x 154 trials, measured means 5.17/5.21/5.40 vs this
    formula's 5.16/5.28/5.41; re-validated in
    ``tests/test_certify.py::TestNoiseCeiling`` at a second trial count).
    Outside it — strongly correlated channels after aggressive RFI
    cleaning, non-Gaussian residuals, very large ndm — the effective
    count ``m`` drifts and the location can be off by a few tenths;
    ``snr_threshold="auto"`` additionally clamps to the reference's 6.0
    floor so small chunks never resolve below the reference default.
    """
    m = 6.0 * float(nsamples) * max(1.0, float(ndm))
    a = np.sqrt(2.0 * np.log(m))
    return float(a - (np.log(np.log(m)) + np.log(4.0 * np.pi)) / (2.0 * a))


def matched_snr_floor(nsamples, ndm=1, margin=1.0):
    """A detection floor matched to the chunk's noise statistics.

    ``expected_noise_max_snr + margin``: the same "clearly above the
    noise maximum" philosophy as the reference's fixed ``snr > 6``
    (tuned for its ~1e3-sample chunks), adapted to the chunk geometry.
    ``margin = 1.0`` puts the per-chunk false-alarm probability at the
    sub-percent level (Gumbel scale ``1/sqrt(2 ln m)`` ~ 0.19 at 2^20
    samples).
    """
    return expected_noise_max_snr(nsamples, ndm) + float(margin)
