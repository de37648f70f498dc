"""Synthetic filterbank data (host numpy, seeded): a single dispersed
pulse, a periodic pulsar and an accelerated (binary) pulsar, and
:func:`inject_rfi`, which contaminates one with RFI.

The reference fixture (``pulsarutils/simulate.py:6-28``): an impulse at the
midpoint of every channel, folded-normal noise, then each channel rolled
*forward* by its DM delay — the inverse of what the sweep undoes.
"""

from __future__ import annotations

import numpy as np

from ..ops.plan import dedispersion_shifts


def _sigpyproc_style_header(nchan, nsamples, tsamp, start_freq, bandwidth):
    return {
        "bandwidth": bandwidth,
        "fbottom": start_freq,
        "ftop": start_freq + bandwidth,
        "foff": bandwidth / nchan,
        "nchans": nchan,
        "nsamples": nsamples,
        "tsamp": tsamp,
    }


def disperse_array(array, dm, start_freq, bandwidth, tsamp):
    """Roll each channel of ``array`` (row 0 = lowest frequency) *forward*
    by its DM delay."""
    array = np.asarray(array)
    nchan, nsamples = array.shape
    shifts = dedispersion_shifts(nchan, dm, start_freq, bandwidth, tsamp)
    sh = np.rint(shifts).astype(np.int64) % nsamples
    idx = (np.arange(nsamples)[None, :] - sh[:, None]) % nsamples
    return np.take_along_axis(array, idx, axis=1)


def simulate_test_data(dm=150, tsamp=0.0005, nsamples=1024, nchan=128,
                       start_freq=1200., bandwidth=200., signal=1., noise=0.5,
                       rng=None):
    """A dispersed single pulse in a noisy filterbank.

    Impulse of ``signal`` at ``nsamples // 2`` in every channel,
    ``abs(Normal(impulse, noise))`` noise, channels rolled by their DM
    delays.  ``rng`` is a seed or a ``numpy.random.Generator``.  Returns
    ``(array, header)`` with sigpyproc-style header keys.
    """
    rng = (rng if isinstance(rng, np.random.Generator)
           else np.random.default_rng(rng))
    array = np.zeros((nchan, nsamples))
    array[:, nsamples // 2] = signal
    array = np.abs(rng.normal(array, noise))
    array = disperse_array(array, dm, start_freq, bandwidth, tsamp)
    header = _sigpyproc_style_header(nchan, nsamples, tsamp, start_freq,
                                     bandwidth)
    return array, header


def simulate_pulsar_data(period=0.033, dm=56.77, tsamp=0.0005, nsamples=16384,
                         nchan=128, start_freq=1200., bandwidth=200.,
                         signal=1., noise=0.5, duty_cycle=0.05, rng=None):
    """A periodic dispersed pulsar: a Gaussian pulse train of fractional
    width ``duty_cycle`` at ``period`` s, ``abs(Normal(train, noise))``
    noise, dispersed at ``dm``.  Returns ``(array, header)``."""
    rng = (rng if isinstance(rng, np.random.Generator)
           else np.random.default_rng(rng))
    t = np.arange(nsamples) * tsamp
    phase = (t / period) % 1.0
    dist = np.minimum(phase, 1.0 - phase)
    profile = signal * np.exp(-0.5 * (dist / duty_cycle) ** 2)
    array = np.abs(rng.normal(np.broadcast_to(profile, (nchan, nsamples)),
                              noise))
    array = disperse_array(array, dm, start_freq, bandwidth, tsamp)
    header = _sigpyproc_style_header(nchan, nsamples, tsamp, start_freq,
                                     bandwidth)
    return array, header


#: speed of light (m/s), equal to ``periodicity.accel.C_M_S`` so injected
#: and searched accelerations agree
_C_M_S = 299792458.0


def simulate_accel_pulsar_data(freq=60.0, dm=150.0, accel=0.0,
                               tsamp=0.0005, nsamples=16384, nchan=32,
                               start_freq=1200., bandwidth=200.,
                               signal=1.0, noise=0.5, duty_cycle=0.05,
                               floor=20.0, jerk=0.0, rng=None):
    """A dispersed accelerated (binary) pulsar with apparent phase
    ``f0 (t + a t^2 / (2 c) + j t^3 / (6 c))`` — the track the
    acceleration search straightens with trial ``(a, j) == (accel,
    jerk)``; ``floor`` is a constant offset so integer quantisation in a
    written filterbank keeps the noise floor.  Returns ``(array,
    header)``."""
    rng = (rng if isinstance(rng, np.random.Generator)
           else np.random.default_rng(rng))
    t = np.arange(nsamples) * tsamp
    phase = freq * (t + accel * t * t / (2.0 * _C_M_S)
                    + jerk * t ** 3 / (6.0 * _C_M_S))
    dist = np.minimum(phase % 1.0, 1.0 - (phase % 1.0))
    profile = signal * np.exp(-0.5 * (dist / duty_cycle) ** 2)
    array = np.abs(rng.normal(np.broadcast_to(profile, (nchan, nsamples)),
                              noise)) + floor
    array = disperse_array(array, dm, start_freq, bandwidth, tsamp)
    header = _sigpyproc_style_header(nchan, nsamples, tsamp, start_freq,
                                     bandwidth)
    return array, header


def inject_rfi(array, bad_channels=(), bad_channel_scale=10.0,
               impulse_times=(), impulse_scale=20.0, rng=None):
    """Contaminate a filterbank with narrowband and impulsive broadband
    RFI (host numpy, the JAX package's generator calls, so one seed gives
    the same array).

    ``bad_channels`` get ``|N(0, bad_channel_scale)|`` noise added;
    ``impulse_times`` (sample indices) get ``impulse_scale`` added across
    all channels.  Returns a float64 copy.
    """
    rng = (rng if isinstance(rng, np.random.Generator)
           else np.random.default_rng(rng))
    out = np.array(array, dtype=float, copy=True)
    nchan, nsamples = out.shape
    for c in bad_channels:
        out[c] += np.abs(rng.normal(0, bad_channel_scale, nsamples))
    for t in impulse_times:
        out[:, int(t) % nsamples] += impulse_scale
    return out
