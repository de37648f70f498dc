"""Synthetic filterbank data (host numpy, seeded).

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
