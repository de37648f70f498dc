"""Dedispersion plan math: per-channel delays, trial-DM grids, smearing.

Host-side float64 NumPy, with the rounding conventions of the reference
implementation (``pulsarutils/dedispersion.py:101-171``,
``pulsarutils/clean.py:272-274``).  Every integer offset the device sees
is computed here, so hit detection does not depend on device precision.

Sign/rounding conventions that the S/N recovery depends on:

* delays are measured **relative to the band-centre frequency**, so shifts are
  positive below centre and negative above;
* a shift is ``rint(delay // sample_time)`` — float floor-division first,
  then round-to-nearest-even;
* :func:`normalize_shifts` rounds with ``rint`` then wraps into ``[0, N)``.
"""

from __future__ import annotations

import numpy as np

#: Dispersion constant in s MHz^2 cm^3 pc^-1 (the reference's rounded 4149).
DM_DELAY_CONST = 4149.0

#: Intra-channel smearing constant (seconds, MHz): ``8300 * DM * df / f^3``.
DM_SMEARING_CONST = 8300.0


def dm_delay(dm, freq):
    """Cold-plasma dispersion delay (seconds) at ``freq`` MHz for ``dm``."""
    return DM_DELAY_CONST * dm * freq ** (-2.0)


def delta_delay(dm, start_freq, stop_freq):
    """Differential dispersion delay (s) between two frequencies (MHz)."""
    return dm_delay(dm, start_freq) - dm_delay(dm, stop_freq)


def dm_broadening(dm, freq, df):
    """Intra-channel DM smearing time (s) in a channel of width ``df`` MHz."""
    return DM_SMEARING_CONST * dm * df / freq ** 3


def channel_frequencies(nchan, start_freq, bandwidth):
    """Lower-edge frequency of each channel (MHz), bottom of the band first."""
    dfreq = bandwidth / nchan
    return start_freq + np.arange(nchan) * dfreq


def dedispersion_shifts(nchan, dm, start_freq, bandwidth, sample_time):
    """Integer per-channel sample delays (as a float array) for one DM.

    ``shift[i] = rint((delay_i - delay_center) // sample_time)`` with the
    band-centre frequency as the reference point.
    """
    center_freq = start_freq + bandwidth / 2.0
    ref_delay = dm_delay(dm, center_freq)
    chan_freq = channel_frequencies(nchan, start_freq, bandwidth)
    delay = DM_DELAY_CONST * dm * chan_freq ** (-2.0) - ref_delay
    return np.rint(delay // sample_time)


def dedispersion_shifts_batch(trial_dms, nchan, start_freq, bandwidth,
                              sample_time):
    """Per-channel shifts for a whole trial-DM grid: ``(ndm, nchan)`` floats
    holding integer values."""
    trial_dms = np.asarray(trial_dms)
    center_freq = start_freq + bandwidth / 2.0
    chan_freq = channel_frequencies(nchan, start_freq, bandwidth)
    delay = (DM_DELAY_CONST * trial_dms[:, None]
             * (chan_freq[None, :] ** (-2.0) - center_freq ** (-2.0)))
    return np.rint(delay // sample_time)


def normalize_shifts(shifts, n):
    """Round shifts and wrap them into ``[0, n)`` as ``int32``.

    >>> normalize_shifts(np.array([-1.2, 0.0, 3.6, 10.0]), 8)
    array([7, 0, 4, 2], dtype=int32)
    """
    wrapped = np.rint(np.asarray(shifts)) % n
    return wrapped.astype(np.int32)


def dedispersion_plan(nchan, dmmin, dmmax, start_freq, bandwidth, sample_time):
    """Trial-DM grid: one trial per integer sample of band-crossing delay.

    >>> dms = dedispersion_plan(64, 100, 200.0, 1200.0, 200.0, 0.0005)
    >>> bool(dms[0] <= 100.5) and bool(dms[-1] >= 199.0)
    True
    """
    stop_freq = start_freq + bandwidth
    f0 = float(start_freq)
    f1 = float(stop_freq)

    max_n = delta_delay(float(dmmax), f0, f1) / sample_time
    min_n = delta_delay(float(dmmin), f0, f1) / sample_time

    trial_n = np.arange(min_n, max_n + 1)
    return trial_n * sample_time / DM_DELAY_CONST / (f0 ** -2.0 - f1 ** -2.0)


def dmmax_for_trials(dmmin, n_trials, start_freq, bandwidth, sample_time):
    """DM upper bound whose integer-band-delay grid spans ``n_trials``
    starting at ``dmmin`` (half a sample of margin against rounding)."""
    f0 = float(start_freq)
    f1 = f0 + float(bandwidth)
    unit = delta_delay(1.0, f0, f1)
    n_lo = int(np.ceil(delta_delay(float(dmmin), f0, f1) / sample_time))
    return (n_lo + n_trials - 0.5) * sample_time / unit


def plan_size(nchan, dmmin, dmmax, start_freq, bandwidth, sample_time):
    """Number of trials the plan will contain, computed without allocating."""
    stop_freq = start_freq + bandwidth
    max_n = delta_delay(float(dmmax), start_freq, stop_freq) / sample_time
    min_n = delta_delay(float(dmmin), start_freq, stop_freq) / sample_time
    return int(np.ceil(max_n + 1 - min_n))


def offsets_for(trial_dms, nchan, start_freq, bandwidth, sample_time,
                nsamples):
    """Float64 shift table -> int32 gather offsets in ``[0, nsamples)``."""
    shifts = dedispersion_shifts_batch(
        np.asarray(trial_dms, dtype=np.float64), nchan, start_freq, bandwidth,
        sample_time)
    return normalize_shifts(shifts, nsamples)
