"""Folded period search: power spectra, harmonic summing, phase folding.

The port of the JAX package's ``ops/periodicity.py``:

* the power spectrum of a dedispersed plane ``(ndm, T)`` is one batched
  ``torch.fft.rfft`` (DC bin zeroed);
* spectra are median-normalised (the median of an Exp(1) variable is
  ``ln 2``), so an ``h``-harmonic sum is Erlang(h) under the null and
  :func:`power_sf_log` gives its false-alarm probability in closed form;
* the normalise + incremental harmonic stack + per-depth peak is the
  scoring core: :func:`~.harmonic_cuda.score_power` launches its CUDA
  kernel on the card and runs the plain chain here on the CPU;
* phase folding over a grid of trial frequencies is a scatter-add from
  host float64 phase anchors, scored with the H-test
  (:func:`~.robust.h_test_batch`).

Everything runs on the device of the tensor it is given; numpy input
becomes a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..precision import cast_operand, strategy
from ..utils.device import to_numpy
from .robust import h_test_batch, median, ref_mad

#: harmonic-sum depths tried by the search (PRESTO-style powers of two)
HARMONIC_SUMS = (1, 2, 4, 8, 16)

_LN2 = float(np.log(2.0))

#: rows of the stacked spectral result, in order
_SPEC_KEYS = ("freq", "power", "nharm", "log_sf", "sigma")


# ---------------------------------------------------------------------------
# Power spectra
# ---------------------------------------------------------------------------

def power_spectrum(series):
    """Raw rFFT power of ``series`` (..., T) -> (..., T//2 + 1), the DC
    bin zeroed."""
    series = torch.as_tensor(series)
    power = torch.abs(torch.fft.rfft(series, dim=-1)) ** 2
    mask = torch.ones(power.shape[-1], dtype=power.dtype,
                      device=power.device)
    mask[0] = 0.0
    return power * mask


def normalize_power(power):
    """Median-normalise each spectrum (last axis) so white-noise bins are
    ~Exp(1): ``p / (med / ln2)``, the median over bins ``[1:]`` (NumPy's
    even-length convention), divisor 1 where the median is not positive.
    Both divides are tensor divides (IEEE), as the CUDA kernel's."""
    power = torch.as_tensor(power)
    med = median(power[..., 1:], dim=-1, keepdim=True)
    ln2 = torch.full_like(med, _LN2)
    return power / torch.where(med > 0, med / ln2, 1.0)


# ---------------------------------------------------------------------------
# Harmonic summing and the scoring chain
# ---------------------------------------------------------------------------

def _harmonic_addend(power, j):
    """Harmonic ``j`` of every fundamental bin: ``power[i*j]`` where ``i*j <
    nbins``, else 0."""
    strided = power[..., ::j]
    v = torch.zeros_like(power)
    v[..., :strided.shape[-1]] = strided
    return v


def _add_harmonic(acc, power, j):
    """``acc[i] += power[i*j]`` where ``i*j < nbins``, else ``+= 0``."""
    return acc + _harmonic_addend(power, j)


def _add_harmonic_comp(acc, comp, power, j):
    """The compensated (TwoSum) :func:`_add_harmonic`: returns ``(acc,
    comp)``, the add's rounding error carried in ``comp`` (the
    ``f32_compensated`` and ``split_f32`` policies' stack: the harmonic
    count is small, so the two share the sequential form)."""
    v = _harmonic_addend(power, j)
    s = acc + v
    bp = s - acc
    comp = comp + ((acc - (s - bp)) + (v - bp))
    return s, comp


def _compensated(policy):
    strat = strategy(policy)
    return strat is not None and strat.accumulator != "plain"


def _operand(norm, policy):
    """The stack's addends under ``policy``: ``norm`` rounded to bfloat16
    (and held in float32) under ``bf16_operand_f32_accum``, else
    ``norm``."""
    strat = strategy(policy)
    if strat is not None and strat.operand_dtype == "bfloat16":
        return cast_operand(norm, strat.name).to(norm.dtype)
    return norm


def harmonic_sum(power, nharm, policy=None):
    """``out[..., i] = sum_{j=1..nharm} power[..., i * j]`` (out-of-range
    harmonics contribute zero), ``j`` ascending; under ``f32_compensated``
    and ``split_f32`` with a TwoSum carry, returning ``out + comp``."""
    power = torch.as_tensor(power)
    out = torch.zeros_like(power)
    if _compensated(policy):
        comp = torch.zeros_like(power)
        for j in range(1, int(nharm) + 1):
            out, comp = _add_harmonic_comp(out, comp, power, j)
        return out + comp
    for j in range(1, int(nharm) + 1):
        out = _add_harmonic(out, power, j)
    return out


def band_edges(nbins, nsamples, tsamp, fmin=None, fmax=None):
    """The scored bins ``[lo, hi)`` of an ``nsamples``-long series."""
    t = int(nsamples)
    lo = 1 if fmin is None else max(1, int(np.ceil(fmin * t * tsamp)))
    hi = nbins if fmax is None else min(nbins, int(fmax * t * tsamp) + 1)
    return lo, hi


def harmonic_depths(max_harmonics):
    """The depths of :data:`HARMONIC_SUMS` up to ``max_harmonics``."""
    return tuple(h for h in HARMONIC_SUMS if h <= int(max_harmonics))


def harmonic_peaks_plain(norm, depths, lo, hi, policy=None):
    """Peak value and first argmax of ``acc_h * band`` per depth ``h`` of
    the incremental harmonic stack of normalised spectra ``norm`` (rows,
    nbins): ``(vals (rows, ndepth) float32, bins (rows, ndepth) int32)``.
    The plain version of the harmonic kernel's stack, under ``policy``:
    ``f32_compensated`` and ``split_f32`` add with a TwoSum carry beside
    each bin and score ``acc + comp``; ``bf16_operand_f32_accum`` adds the
    bins rounded to bfloat16 (the first harmonic's too) in float32."""
    nbins = norm.shape[-1]
    band = torch.zeros(nbins, dtype=norm.dtype, device=norm.device)
    band[lo:hi] = 1.0
    compensated = _compensated(policy)
    addends = _operand(norm, policy)
    acc = torch.zeros_like(norm)
    comp = torch.zeros_like(norm) if compensated else None
    vals, bins = [], []
    depth = 0
    for h in depths:
        for j in range(depth + 1, h + 1):
            if compensated:
                acc, comp = _add_harmonic_comp(acc, comp, norm, j)
            else:
                acc = _add_harmonic(acc, addends, j)
        depth = h
        hsum = (acc + comp if compensated else acc) * band
        peak = torch.argmax(hsum, dim=-1)
        vals.append(torch.gather(hsum, -1, peak[..., None])[..., 0])
        bins.append(peak.to(torch.int32))
    return torch.stack(vals, dim=-1), torch.stack(bins, dim=-1)


def power_sf_log(power, nsum=1):
    """``log`` survival function of an Erlang(``nsum``) harmonic sum,
    ``P(S > p) = exp(-p) sum_{k<nsum} p^k / k!``, in log space.  A float
    tensor keeps its dtype; other input becomes float64."""
    power = torch.as_tensor(power)
    if not power.is_floating_point():
        power = power.to(torch.float64)
    logp = torch.log(torch.where(power > 0, power, 1e-300))
    terms = [k * logp - _log_factorial(k) for k in range(int(nsum))]
    stacked = torch.stack(terms)
    m = torch.max(stacked, dim=0).values
    lse = m + torch.log(torch.sum(torch.exp(stacked - m), dim=0))
    return -power + lse


def _log_factorial(k):
    return float(np.sum(np.log(np.arange(1, k + 1)))) if k > 1 else 0.0


def sf_log_to_sigma(log_sf):
    """Gaussian-equivalent significance of a log false-alarm probability:
    ``sqrt(u - log u)``, ``u = -2 log(sf) - log(2 pi)`` floored at 1."""
    log_sf = torch.as_tensor(log_sf)
    if not log_sf.is_floating_point():
        log_sf = log_sf.to(torch.float64)
    u = -2.0 * log_sf - float(np.log(2.0 * np.pi))
    u = torch.where(u > 1.0, u, 1.0)
    return torch.sqrt(u - torch.log(u))


def best_depth(vals, bins, depths, nsamples, tsamp):
    """The per-row best depth of per-depth peaks ``vals``/``bins`` (rows,
    ndepth), by the smallest false-alarm probability: the dict ``freq,
    power, nharm, log_sf, sigma`` (the JAX package's chain, float32 on
    float32 peaks)."""
    rows = vals.shape[:-1]
    dev = vals.device
    scale = torch.tensor(int(nsamples) * float(tsamp), dtype=vals.dtype,
                         device=dev)
    best_logsf = torch.full(rows, float("inf"), dtype=vals.dtype,
                            device=dev)
    best_freq = torch.zeros(rows, dtype=vals.dtype, device=dev)
    best_power = torch.zeros(rows, dtype=vals.dtype, device=dev)
    best_nharm = torch.zeros(rows, dtype=torch.int32, device=dev)
    for k, h in enumerate(depths):
        pval = vals[..., k]
        log_sf = power_sf_log(pval, nsum=h)
        better = log_sf < best_logsf
        freq = bins[..., k].to(vals.dtype) / scale
        best_logsf = torch.where(better, log_sf, best_logsf)
        best_freq = torch.where(better, freq, best_freq)
        best_power = torch.where(better, pval, best_power)
        best_nharm = torch.where(better, h, best_nharm).to(torch.int32)
    return {"freq": best_freq, "power": best_power, "nharm": best_nharm,
            "log_sf": best_logsf, "sigma": sf_log_to_sigma(best_logsf)}


def score_normalized_power(power, nsamples, tsamp, max_harmonics=16,
                           fmin=None, fmax=None, policy=None):
    """Harmonic-sum scoring of an already Exp(1)-normalised spectrum
    ``power`` (..., nbins) of a length-``nsamples`` series, plain PyTorch
    on any device, the stack under the :mod:`..precision` ``policy``
    (:func:`harmonic_peaks_plain`): the dict ``freq, power, nharm,
    log_sf, sigma``."""
    power = torch.as_tensor(power)
    lo, hi = band_edges(power.shape[-1], nsamples, tsamp, fmin, fmax)
    depths = harmonic_depths(max_harmonics)
    vals, bins = harmonic_peaks_plain(power, depths, lo, hi, policy=policy)
    return best_depth(vals, bins, depths, nsamples, tsamp)


def spectral_search(series, tsamp, max_harmonics=16, fmin=None, fmax=None,
                    policy=None):
    """FFT periodicity search of ``series`` (..., T): per row the best of
    every harmonic depth up to ``max_harmonics``, as the dict ``freq``
    (Hz), ``power``, ``nharm``, ``log_sf``, ``sigma``.  The scoring runs
    through :func:`~.harmonic_cuda.score_power` (the kernel on the card),
    its harmonic stack under the :mod:`..precision` ``policy``."""
    from .harmonic_cuda import score_power

    series = torch.as_tensor(series)
    t = series.shape[-1]
    return score_power(power_spectrum(series), t, tsamp,
                       max_harmonics=max_harmonics, fmin=fmin, fmax=fmax,
                       policy=policy)


def spectral_stacked(series, tsamp, max_harmonics=16, fmin=None,
                     fmax=None, policy=None):
    """:func:`spectral_search` packed as one ``(5, rows)`` float32 tensor
    on the series' device (rows in :data:`_SPEC_KEYS` order)."""
    spec = spectral_search(series, tsamp, max_harmonics=max_harmonics,
                           fmin=fmin, fmax=fmax, policy=policy)
    return torch.stack([spec[k].to(torch.float32) for k in _SPEC_KEYS])


def _spectral_chunk(plane_chunk, tsamp, max_harmonics, fmin, fmax,
                    kernel="auto", policy=None):
    """Spectral-search one row chunk; a host dict out, one readback.

    ``kernel`` names the scoring chain as the JAX package does:
    ``"pallas"`` the harmonic kernel (B6), ``"xla"`` the plain chain, or
    ``"auto"``, resolved by :func:`~..tuning.autotune.
    resolve_harmonic_kernel` — B6 on the card and the plain chain on the
    CPU, the one variant that applies on each.  The chain runs on the
    chunk's device through :func:`~.harmonic_cuda.score_power`, so a name
    the device cannot run raises: the plain chain never scores on the
    card."""
    plane_chunk = torch.as_tensor(plane_chunk)
    if kernel == "auto":
        from ..tuning.autotune import resolve_harmonic_kernel

        rows, t = plane_chunk.shape[-2], plane_chunk.shape[-1]
        kernel = resolve_harmonic_kernel(
            rows, t, float(tsamp), max_harmonics=int(max_harmonics),
            fmin=fmin, fmax=fmax, policy=policy, device=plane_chunk.device)
    expected = "pallas" if plane_chunk.device.type == "cuda" else "xla"
    if kernel != expected:
        raise ValueError(
            f"kernel={kernel!r} does not run on {plane_chunk.device.type}: "
            f"its scoring chain there is {expected!r}")
    stacked = to_numpy(spectral_stacked(plane_chunk, tsamp,
                                        max_harmonics=max_harmonics,
                                        fmin=fmin, fmax=fmax, policy=policy))
    out = dict(zip(_SPEC_KEYS, stacked))
    out["nharm"] = np.rint(out["nharm"]).astype(np.int32)
    return out


# ---------------------------------------------------------------------------
# Phase folding
# ---------------------------------------------------------------------------

#: samples per phase-anchor block: within a block the device extrapolates
#: the phase in float32 from the block's float64 anchor
_FOLD_BLOCK = 4096


def _phase_anchors(nsamples, freqs, tsamp, t0):
    """Host float64 phase at every anchor block's start: ``(anchors
    (nfreq, nblocks) in [0, 1), step_frac (nfreq,))``."""
    freqs = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
    nblocks = -(-int(nsamples) // _FOLD_BLOCK)
    starts = np.arange(nblocks, dtype=np.float64) * _FOLD_BLOCK
    step = freqs * float(tsamp)
    anchors = ((starts[None, :] * step[:, None])
               + float(t0) * freqs[:, None]) % 1.0
    return anchors, step % 1.0


def _fold_anchored(series, anchors, step_frac, nbin):
    """Fold ``series`` (T,) at every trial of ``anchors`` (nfreq, nblocks)
    / ``step_frac`` (nfreq,) (tensors of the series' dtype and device):
    ``(profiles, hits)``, each ``(nfreq, nbin)``."""
    t = series.shape[0]
    nfreq = anchors.shape[0]
    i = torch.arange(_FOLD_BLOCK, dtype=series.dtype, device=series.device)
    phase = torch.remainder(anchors[:, :, None]
                            + i[None, None, :] * step_frac[:, None, None],
                            1.0)
    bins = torch.remainder((phase * nbin).to(torch.int32), nbin)
    bins = bins.reshape(nfreq, -1)[:, :t].to(torch.int64)
    profiles = torch.zeros((nfreq, nbin), dtype=series.dtype,
                           device=series.device)
    profiles.scatter_add_(1, bins, series[None, :].expand(nfreq, t))
    hits = torch.zeros_like(profiles)
    hits.scatter_add_(1, bins, torch.ones_like(profiles[:, :1])
                      .expand(nfreq, t))
    return profiles, hits


def _as_series(series):
    series = torch.as_tensor(series)
    if not series.is_floating_point():
        series = series.to(torch.float32)
    return series


def fold(series, freq, tsamp, nbin=32, t0=0.0):
    """Fold ``series`` (T,) at ``freq`` into ``nbin`` phase bins:
    ``(profile, hits)`` (per-bin sums and sample counts)."""
    profiles, hits = fold_batch(series, [float(freq)], tsamp, nbin=nbin,
                                t0=t0)
    return profiles[0], hits[0]


def fold_batch(series, freqs, tsamp, nbin=32, t0=0.0):
    """Fold one series at many host trial frequencies: ``(profiles,
    hits)``, each ``(nfreq, nbin)``."""
    series = _as_series(series)
    anchors, step_frac = _phase_anchors(series.shape[0], freqs, tsamp, t0)
    kw = dict(dtype=series.dtype, device=series.device)
    return _fold_anchored(series, torch.as_tensor(anchors, **kw),
                          torch.as_tensor(step_frac, **kw), int(nbin))


def _epoch_fold_score(series, profiles, hits, nmax):
    """Exposure-correct folded profiles and H-test them under the
    Gaussian normalisation ``total = T sigma^2``."""
    mean_rate = profiles.sum(dim=-1, keepdim=True) / torch.clamp(
        hits.sum(dim=-1, keepdim=True), min=1.0)
    corrected = profiles - hits * mean_rate
    sigma = ref_mad(series)
    total = series.shape[0] * torch.clamp(sigma * sigma, min=1e-30)
    return h_test_batch(corrected, nmax=nmax, total=total)


def epoch_folding_search(series, tsamp, freqs, nbin=32, nmax=8):
    """Fold ``series`` at every trial frequency (host values),
    exposure-correct the profiles and H-test them: ``(h_stats, m_best,
    profiles)`` tensors on the series' device."""
    series = _as_series(series)
    profiles, hits = fold_batch(series, np.asarray(freqs, np.float64),
                                tsamp, nbin=nbin)
    h, m = _epoch_fold_score(series, profiles, hits, int(nmax))
    return h, m, profiles


def refine_grid(freq, tsamp, nsamples, oversample=8, half_width_bins=2):
    """Trial frequencies around ``freq`` spanning +-``half_width_bins``
    Fourier bins at ``oversample`` trials per bin."""
    df = 1.0 / (nsamples * tsamp)
    n = 2 * half_width_bins * oversample + 1
    return freq + np.linspace(-half_width_bins * df, half_width_bins * df, n)


# ---------------------------------------------------------------------------
# The folded period search of one plane
# ---------------------------------------------------------------------------

def period_search_plane(plane, tsamp, max_harmonics=16, fmin=None, fmax=None,
                        nbin=32, oversample=8, refine_top=1, row_chunk=None):
    """Folded period search over a dedispersed plane ``(ndm, T)`` (a
    tensor on its device, or an array).

    Stage 1: the spectral search per DM trial, ``row_chunk`` rows at a
    time (each chunk one readback).  Stage 2: for the ``refine_top``
    most significant rows, fold on a fine frequency grid around the
    spectral candidate and H-test.  Returns the per-row spectral results
    (host arrays) plus ``best_dm_index``, ``best_freq``, ``best_h``,
    ``best_m``, ``best_sigma`` (from the H tail ``P(>H) ~ exp(-0.4 H)``)
    and ``best_profile``.

    ``plane`` may also be a dm-sharded :class:`~..parallel.sharded_plane.
    ShardedPlane` (the mesh route): stage 1 then runs shard by shard on
    the devices (its ``spectral_scores``) and stage 2 reads its refine
    rows back one at a time, as in the JAX package.
    """
    if hasattr(plane, "spectral_scores"):
        ndm, t = plane.shape
        spec = plane.spectral_scores(tsamp, max_harmonics=max_harmonics,
                                     fmin=fmin, fmax=fmax)
    else:
        plane = torch.as_tensor(plane)
        ndm, t = plane.shape
        if row_chunk is None:
            row_chunk = max(16, (1 << 27) // max(1, t))
        chunks = [_spectral_chunk(plane[lo:lo + row_chunk], tsamp,
                                  max_harmonics, fmin, fmax)
                  for lo in range(0, ndm, row_chunk)]
        spec = {k: np.concatenate([c[k] for c in chunks])
                for k in chunks[0]}

    order = np.argsort(spec["log_sf"])
    best = {}
    for rank in range(min(int(refine_top), ndm)):
        d = int(order[rank])
        f0 = float(spec["freq"][d])
        if f0 <= 0:
            continue
        grid = refine_grid(f0, tsamp, t, oversample=oversample)
        h, m, profiles = epoch_folding_search(plane[d], tsamp, grid,
                                              nbin=nbin)
        h = to_numpy(h)
        k = int(np.argmax(h))
        cand = {"dm_index": d, "freq": float(grid[k]), "h": float(h[k]),
                "m": int(to_numpy(m)[k]),
                "profile": to_numpy(profiles[k])}
        if not best or cand["h"] > best["h"]:
            best = cand

    best_h = best.get("h", 0.0)
    best_sigma = (float(sf_log_to_sigma(np.asarray(-0.4 * best_h)))
                  if best_h > 0 else float(spec["sigma"][order[0]]))
    return {
        **spec,
        "best_dm_index": best.get("dm_index", int(order[0])),
        "best_freq": best.get("freq", float(spec["freq"][order[0]])),
        "best_h": best_h,
        "best_m": best.get("m", 0),
        "best_sigma": best_sigma,
        "best_profile": best.get("profile"),
    }
