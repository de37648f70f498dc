"""Fourier-domain acceleration/jerk response templates (host float64).

A copy of the JAX package's ``ops/zresponse.py`` (NumPy only; the tests
pin every table equal to the reference's), the template bank of
:mod:`..periodicity.fdas`.

A constant line-of-sight acceleration ``a`` drifts a pulsar's apparent
spin frequency across the observation, smearing its power over ``z =
f a T_obs^2 / c`` Fourier bins; a jerk ``j`` adds a quadratic drift of
``w = f j T_obs^3 / c`` bins.  PRESTO-lineage Fourier-domain search
(PulsarX, arxiv 2309.02544) recovers the smeared power with ONE FFT per
DM row plus a short complex correlation against precomputed *response
templates* — the Fourier transform of a unit-amplitude linear/quadratic
chirp.  This module builds those templates on host in float64 (the
anchored-fold rule: template phases wrap thousands of cycles and must
not be computed in float32), with no dependency beyond numpy — the
Fresnel integrals the closed form needs are implemented here (power
series + asymptotic expansion) because scipy is not a dependency of
this repo.

Math.  For the normalised chirp ``s(u) = exp(2 pi i (z u^2/2 + w
u^3/6))`` on ``u in [0, 1]`` the response at Fourier-bin offset ``q``
from the starting frequency is::

    A_{z,w}(q) = integral_0^1 exp(2 pi i (z u^2/2 + w u^3/6 - q u)) du

* ``w = 0``: completing the square gives the Fresnel closed form

  ``A_z(q) = exp(-i pi q^2/z) / sqrt(2 z) * [(C(y2)-C(y1)) + i (S(y2)-S(y1))]``

  with ``y1 = -q sqrt(2/z)``, ``y2 = sqrt(2 z) (1 - q/z)`` and the
  ``z < 0`` half from conjugate symmetry ``A_{-z}(q) = conj(A_z(-q))``.
  Below ``|z| < Z_SMALL`` the prefactor ``1/sqrt(2 z)`` and the Fresnel
  difference cancel catastrophically, so a first-order series branch
  ``A ~ A_0(q) + i pi z M_1(q)`` takes over (``A_0(q) = exp(-i pi q)
  sinc(q)``, ``M_1(q) = integral_0^1 u^2 exp(-2 pi i q u) du``).
* ``w != 0``: no Fresnel closed form exists; the template is the FFT of
  the finely-sampled chirp (the FFT's bin spacing at ``M`` samples of
  ``u in [0,1)`` is exactly one Fourier bin of the real series, so
  integer-``q`` samples read straight out of the transform).  The
  closed form is kept for every ``w = 0`` entry and property-tested
  against the numerical path at the seam.

Templates are stored *centred*: entry ``i`` holds the matched filter
``conj(A(c_i + j))`` for ``j in [-h, h]`` with ``c_i = rint(z_i/2 +
w_i/6)`` the drift centroid, unit-normalised so a white-noise spectrum
correlated with any entry keeps unit variance (the median
normalisation downstream then behaves identically for every bin).
"""

from __future__ import annotations

import functools
import warnings

import numpy as np

__all__ = ["Z_SMALL", "fresnel", "z_response", "zw_response",
           "response_bank", "response_bank_pairs", "bank_for_trials"]

#: below this |z| the Fresnel closed form loses ~half its digits to
#: cancellation; the first-order series branch (error O(z^2) ~ 1e-6 at
#: the boundary) takes over
Z_SMALL = 1e-3

#: speed of light (m/s) — must match ``periodicity.accel.C_M_S`` (the
#: ops layer does not import upward; pinned by a test instead)
_C_M_S = 299792458.0

#: series/asymptotic split for the Fresnel integrals: at |x| = 3.2 the
#: power series still holds ~10 digits (its largest term is ~1e6) and
#: the asymptotic tail bottoms out near 1e-8 — ample for templates
#: that are themselves ~1e-4 from the sampled-chirp path
_FRESNEL_SPLIT = 3.2


def fresnel(x):
    """Fresnel integrals ``C(x), S(x)`` (``integral_0^x cos/sin(pi t^2/2)``).

    Vectorised float64: Maclaurin series for ``|x| <= 2.5``, the
    integration-by-parts asymptotic expansion of the complementary
    integral beyond (truncated at its smallest term per element).
    Both integrals are odd; accuracy ~1e-9 absolute everywhere.
    """
    x = np.asarray(x, dtype=np.float64)
    ax = np.abs(x)
    out = np.where(ax <= _FRESNEL_SPLIT, _fresnel_series(
        np.minimum(ax, _FRESNEL_SPLIT)), _fresnel_asymptotic(
        np.maximum(ax, _FRESNEL_SPLIT)))
    out = np.sign(x) * out
    return out.real, out.imag


def _fresnel_series(x):
    """``C + iS`` by the Maclaurin series of ``integral_0^x e^{i pi t^2/2}``."""
    x = np.asarray(x, dtype=np.float64)
    x2 = (0.5j * np.pi) * x * x
    term = x.astype(np.complex128)          # n = 0 term: x
    total = term.copy()
    for n in range(70):
        term = term * x2 / (n + 1.0) * ((2 * n + 1.0) / (2 * n + 3.0))
        total = total + term
    return total


def _fresnel_asymptotic(x):
    """``C + iS`` for large positive ``x`` via the complementary integral
    ``E(x) = integral_x^inf e^{i pi t^2/2} dt = e^{i pi x^2/2} sum c_m``
    with ``c_0 = i/(pi x)`` and ``c_{m+1} = -i (2m+1)/(pi x^2) c_m``
    (integration by parts); the divergent tail is truncated at the
    smallest term, which at ``x = 2.5`` is ~1e-9."""
    x = np.asarray(x, dtype=np.float64)
    c = np.asarray(1j / (np.pi * x))
    total = c.copy()
    prev = np.abs(c)
    shrinking = np.ones(np.shape(x), dtype=bool)
    for m in range(18):
        c = c * (-1j) * (2 * m + 1.0) / (np.pi * x * x)
        mag = np.abs(c)
        shrinking = shrinking & (mag < prev)
        total = np.where(shrinking, total + c, total)
        prev = mag
    # phase of e^{i pi x^2/2} in float64: x <= ~1e3 here, x^2/2 exact
    # enough (templates never reach the regime where it is not)
    e = np.exp(0.5j * np.pi * x * x)
    return (0.5 + 0.5j) - e * total


def _m1_integral(q):
    """``M_1(q) = integral_0^1 u^2 exp(-2 pi i q u) du`` (float64).

    Closed form ``(e^a (a^2 - 2a + 2) - 2) / a^3`` with ``a = -2 pi i
    q``; the small-``|a|`` limit (1/3) is taken by series to dodge the
    0/0 cancellation."""
    q = np.asarray(q, dtype=np.float64)
    a = -2j * np.pi * q
    small = np.abs(a) < 0.5
    a_safe = np.where(small, 1.0, a)
    closed = (np.exp(a_safe) * (a_safe * a_safe - 2.0 * a_safe + 2.0)
              - 2.0) / a_safe ** 3
    term = np.full(q.shape, 1.0 / 3.0, dtype=np.complex128)
    series = term.copy()
    ab = np.where(small, a, 0.0)
    for n in range(20):
        term = term * ab / (n + 1.0) * ((n + 3.0) / (n + 4.0))
        series = series + term
    return np.where(small, series, closed)


def z_response(z, q):
    """Complex acceleration response ``A_z(q)`` at bin offsets ``q``.

    ``z`` is a host scalar (total drift in Fourier bins over the
    observation); ``q`` an array of offsets from the *starting*
    frequency bin.  Fresnel closed form with the small-``|z|`` series
    branch below :data:`Z_SMALL`; ``z < 0`` by conjugate symmetry.
    """
    z = float(z)
    q = np.asarray(q, dtype=np.float64)
    if abs(z) < Z_SMALL:
        a0 = np.exp(-1j * np.pi * q) * np.sinc(q)
        return a0 + (1j * np.pi * z) * _m1_integral(q)
    if z < 0.0:
        return np.conj(z_response(-z, -q))
    y1 = -q * np.sqrt(2.0 / z)
    y2 = np.sqrt(2.0 * z) + y1
    c1, s1 = fresnel(y1)
    c2, s2 = fresnel(y2)
    pref = np.exp(-1j * np.pi * q * q / z) / np.sqrt(2.0 * z)
    return pref * ((c2 - c1) + 1j * (s2 - s1))


def zw_response(z, w, q, oversample=8):
    """Acceleration+jerk response ``A_{z,w}(q)`` at *integer* offsets ``q``.

    The quadratic-drift chirp has no Fresnel closed form, so the
    template is read from the FFT of the chirp sampled on ``M`` points
    of ``u in [0, 1)`` — bin spacing exactly one Fourier bin of the
    real series.  ``M`` is a power of two at least ``oversample`` times
    the template span so aliased tails sit ~1e-4 below the peak.
    """
    q = np.asarray(q)
    if not np.issubdtype(q.dtype, np.integer):
        qi = np.rint(np.asarray(q, dtype=np.float64)).astype(np.int64)
        if not np.allclose(q, qi):
            raise ValueError("zw_response samples integer bin offsets only")
        q = qi
    span = float(abs(z) + abs(w) + np.max(np.abs(q)) + 16.0)
    m = 1 << max(12, int(np.ceil(np.log2(span * float(oversample)))))
    u = np.arange(m, dtype=np.float64) / m
    chirp = np.exp(2j * np.pi * (0.5 * float(z) * u * u
                                 + (float(w) / 6.0) * u ** 3))
    spec = np.fft.fft(chirp) / m
    return spec[np.mod(q, m)]


def _batched_zw_rows(zs, w, c_half, j):
    """All ``(z, w)`` templates for one ``w != 0`` in a single batched
    chirp FFT — the python-level loop is per ``w`` value, not per
    template, so bank construction stays vectorised."""
    zs = np.asarray(zs, dtype=np.float64)
    span = float(np.max(np.abs(zs)) + abs(w) + np.max(np.abs(c_half))
                 + j[-1] + 16.0)
    m = 1 << max(12, int(np.ceil(np.log2(span * 8.0))))
    u = np.arange(m, dtype=np.float64) / m
    phase = (0.5 * zs[:, None] * (u * u)[None, :]
             + (float(w) / 6.0) * (u ** 3)[None, :])
    spec = np.fft.fft(np.exp(2j * np.pi * phase), axis=-1) / m
    q = c_half[:, None] + j[None, :]                 # (nz, mtap)
    return np.take_along_axis(spec, np.mod(q, m), axis=-1)


def response_bank(zs, ws, half_width):
    """Matched-filter bank over the ``(z, w)`` grid.

    Returns ``(bank, centers)``: ``bank`` is ``(len(zs) * len(ws),
    2 * half_width + 1)`` complex128 holding ``conj(A_{z,w}(c + j))``
    for ``j in [-h, h]``, each row unit-normalised; ``centers`` the
    int32 drift centroids ``c = rint(z/2 + w/6)``.  Row order is
    ``z``-major (``row = iz * len(ws) + iw``).
    """
    zs = np.atleast_1d(np.asarray(zs, dtype=np.float64))
    ws = np.atleast_1d(np.asarray(ws, dtype=np.float64))
    h = int(half_width)
    j = np.arange(-h, h + 1, dtype=np.int64)
    nz, nw = len(zs), len(ws)
    bank = np.empty((nz * nw, 2 * h + 1), dtype=np.complex128)
    centers = np.rint(zs[:, None] / 2.0
                      + ws[None, :] / 6.0).astype(np.int32).reshape(-1)
    for iw, w in enumerate(ws):
        c_half = centers.reshape(nz, nw)[:, iw].astype(np.int64)
        if w == 0.0:
            for iz, z in enumerate(zs):
                bank[iz * nw + iw] = z_response(z, (c_half[iz] + j)
                                                .astype(np.float64))
        else:
            bank[iw::nw] = _batched_zw_rows(zs, w, c_half, j)
    bank = np.conj(bank)
    energy = np.sqrt(np.sum(np.abs(bank) ** 2, axis=-1, keepdims=True))
    return bank / np.maximum(energy, 1e-30), centers


def response_bank_pairs(zs, ws, half_width):
    """Matched-filter rows for *parallel* ``(z, w)`` pairs.

    Same row contract as :func:`response_bank` (``conj(A_{z,w}(c + j))``
    unit-normalised, centers ``rint(z/2 + w/6)``) but builds exactly one
    row per ``(zs[i], ws[i])`` pair instead of the full cartesian
    lattice: a physical trial grid touches a union of ~monotone paths
    through the lattice — thousands of cells — while the bounding box
    spanning the extreme drifts can run to hundreds of thousands of
    rows (gigabytes of templates for a full-band jerk sweep).  Rows
    sharing a ``w`` still batch into one chirp FFT.
    """
    zs = np.atleast_1d(np.asarray(zs, dtype=np.float64))
    ws = np.atleast_1d(np.asarray(ws, dtype=np.float64))
    h = int(half_width)
    j = np.arange(-h, h + 1, dtype=np.int64)
    centers = np.rint(zs / 2.0 + ws / 6.0).astype(np.int32)
    bank = np.empty((len(zs), 2 * h + 1), dtype=np.complex128)
    for w in np.unique(ws):
        sel = np.flatnonzero(ws == w)
        c_half = centers[sel].astype(np.int64)
        if w == 0.0:
            for i in sel:
                bank[i] = z_response(zs[i], (int(centers[i]) + j)
                                     .astype(np.float64))
        else:
            bank[sel] = _batched_zw_rows(zs[sel], w, c_half, j)
    bank = np.conj(bank)
    energy = np.sqrt(np.sum(np.abs(bank) ** 2, axis=-1, keepdims=True))
    return bank / np.maximum(energy, 1e-30), centers


#: half-width ceiling: a template wider than this is truncated (with a
#: warning) — the matched filter degrades gracefully, and the
#: equivalence check :func:`~..tuning.autotune.accel_tables_match`
#: catches a truncated regime that changes the best candidate
MAX_HALF_WIDTH = 256


@functools.lru_cache(maxsize=8)
def bank_for_trials(accels, jerks, nbins, tsamp, nsamples, dz=1.0,
                    dw=4.0, pad=8):
    """Bank + per-(trial, bin) lookup tables for a physical trial grid.

    The search sweeps *physical* ``(a, j)`` trials (matching the
    time-stretch backend cell for cell), so the drift is frequency
    dependent: bin ``k`` of a trial ``(a, j)`` sees ``z_k = k a T / c``
    and ``w_k = k j T^2 / c``.  Each ``(trial, bin)`` is quantised to
    the nearest bank entry.  The grid steps lean on the residual
    degeneracies of the chirp family: a ``dz/2`` quantisation error is
    mostly absorbed by the (always searched) frequency axis, leaving a
    ~``dz/16``-bin smear (Chebyshev residual of a quadratic after its
    best linear fit is 1/8), and a ``dw/2`` error likewise leaves
    ~``dw/64`` (cubic residual 1/32) — so ``dz=1, dw=4`` (PRESTO's
    production z-step is 2) keeps the mismatch loss under a percent
    while the bank stays thousands of rows, not hundreds of
    thousands.

    ``accels``/``jerks`` are hashable tuples of the *flattened trial*
    values (one entry per trial, accel-major).  Returns a dict:

    * ``bank`` — ``(nbank, m)`` complex128 unit matched filters;
    * ``centers`` — ``(nbank,)`` int32 drift centroids;
    * ``tidx`` — ``(ntrials, nbins)`` int32 bank row per (trial, bin);
    * ``gidx`` — ``(ntrials, nbins)`` int32 spectrum gather origin
      ``k + centers[tidx]`` (callers add the tap offset ``[-h, h]``);
    * ``half_width`` — ``h`` (template half width in bins);
    * ``zero_index`` — bank row of the ``(z=0, w=0)`` delta template
      (mesh paths pad the trial axis with it).
    """
    accels = np.asarray(accels, dtype=np.float64)
    jerks = np.asarray(jerks, dtype=np.float64)
    t_obs = float(nsamples) * float(tsamp)
    zeta = accels * t_obs / _C_M_S                # z per bin index
    eta = jerks * t_obs * t_obs / _C_M_S          # w per bin index
    kmax = float(nbins - 1)
    z_top = float(np.max(np.abs(zeta))) * kmax
    w_top = float(np.max(np.abs(eta))) * kmax
    half = int(np.ceil(z_top / 2.0 + w_top / 3.0)) + int(pad)
    if half > MAX_HALF_WIDTH:
        warnings.warn(
            f"fdas template half-width {half} exceeds {MAX_HALF_WIDTH} "
            f"bins (z_max={z_top:.1f}, w_max={w_top:.1f}); truncating — "
            "the matched filter loses sensitivity at the highest "
            "drift rates", UserWarning, stacklevel=2)
        half = MAX_HALF_WIDTH
    nzi = int(np.ceil(z_top / dz)) if z_top > 0 else 0
    nwi = int(np.ceil(w_top / dw)) if w_top > 0 else 0
    k = np.arange(int(nbins), dtype=np.float64)
    zk = zeta[:, None] * k[None, :]               # (ntrials, nbins)
    wk = eta[:, None] * k[None, :]
    iz = np.clip(np.rint(zk / dz).astype(np.int64) + nzi, 0, 2 * nzi)
    iw = np.clip(np.rint(wk / dw).astype(np.int64) + nwi, 0, 2 * nwi)
    # build only the lattice cells the trial paths touch (plus the
    # delta cell, which mesh padding needs) — each trial traces a
    # monotone path of <= nzi + nwi cells, so the compact bank is
    # thousands of rows where the bounding cartesian box over the
    # extreme drifts would be hundreds of thousands
    nws = 2 * nwi + 1
    pair = iz * nws + iw
    zero_pair = np.int64(nzi * nws + nwi)
    uniq = np.union1d(pair.ravel(), zero_pair)
    tidx = np.searchsorted(uniq, pair).astype(np.int32)
    zs = (uniq // nws - nzi).astype(np.float64) * dz
    ws = (uniq % nws - nwi).astype(np.float64) * dw
    bank, centers = response_bank_pairs(zs, ws, half)
    gidx = (np.arange(int(nbins), dtype=np.int64)[None, :]
            + centers[tidx].astype(np.int64)).astype(np.int32)
    return {"bank": bank, "centers": centers, "tidx": tidx,
            "gidx": gidx, "half_width": half,
            "zero_index": int(np.searchsorted(uniq, zero_pair))}
