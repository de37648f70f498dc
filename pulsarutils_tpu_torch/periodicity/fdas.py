"""Fourier-domain acceleration/jerk search (FDAS): one FFT per DM row.

The port of the JAX package's ``periodicity/fdas.py``.  The time-stretch
backend (:mod:`.accel`) resamples and transforms every DM row once per
trial; this backend transforms each row once and recovers every
``(accel, jerk)`` trial by correlating the complex spectrum against
short z/w-response templates (:mod:`..ops.zresponse`, host float64): the
only formulation under which a jerk axis is tractable.

It sweeps the same physical ``(a, j)`` trials as
:func:`.accel.accel_search`, in the same order, with the same table: the
drift a template must match depends on the bin (``z_k = k a T / c``), so
every ``(trial, bin)`` is quantised onto the bank (``bank_for_trials``)
and gathered per bin.  The correlated power then goes through the same
scoring chain, :func:`~..ops.harmonic_cuda.score_power` (the harmonic
kernel on the card), and the same top-k rule.

On the device the correlation is plain PyTorch (the JAX package runs it
as an XLA program, with no kernel of its own): a gather of each bin's
``m``-tap window and a batched contraction with its template, in blocks
of bins (and of rows) that keep the gathered window within
:data:`WINDOW_BYTES`.  Cross-backend agreement is that of the JAX
package: the significant cells agree (discrete fields exactly, sigma
within :data:`~..tuning.autotune.ACCEL_SIGMA_RTOL`), the noise does not.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs import metrics
from ..ops.harmonic_cuda import score_power
from ..ops.periodicity import HARMONIC_SUMS, _SPEC_KEYS
from ..ops.zresponse import MAX_HALF_WIDTH, bank_for_trials
from ..utils.device import resolve_device
from .accel import C_M_S, topk_table, trial_product

__all__ = ["WINDOW_BYTES", "fdas_search"]

#: device memory of one gathered correlation window (complex64 taps of
#: every row of a block of bins): bounds the sweep's extra memory
WINDOW_BYTES = 1 << 30


def _band_slice(nbins, nsamples, tsamp, fmax, max_harmonics, accels, jerks,
                pad=8):
    """Spectrum prefix the correlation must cover: the scoring band up
    to ``fmax`` times the deepest harmonic the scorer gathers, plus a
    template-width margin so the edge windows keep their tails.
    ``fmax=None`` keeps the whole spectrum."""
    if fmax is None:
        return int(nbins)
    hi = min(int(nbins), int(float(fmax) * int(nsamples) * float(tsamp)) + 1)
    h_max = max([h for h in HARMONIC_SUMS if h <= int(max_harmonics)] or [1])
    lo_slice = min(int(nbins), hi * h_max)
    t_obs = float(nsamples) * float(tsamp)
    z_top = float(np.max(np.abs(accels))) * t_obs / C_M_S * (lo_slice - 1)
    w_top = float(np.max(np.abs(jerks))) * t_obs ** 2 / C_M_S * (lo_slice - 1)
    half = min(int(np.ceil(z_top / 2.0 + w_top / 3.0)) + pad,
               MAX_HALF_WIDTH)
    return min(int(nbins), lo_slice + 2 * half)


def _blocks(ndm, nbins, m):
    """``(row_block, bin_block)``: the largest bin block whose window
    ``(bins, m, rows)`` complex64 fits :data:`WINDOW_BYTES` with every
    row, else one bin and as many rows as fit."""
    per_bin = 8 * m * ndm
    if per_bin <= WINDOW_BYTES:
        return ndm, max(1, min(nbins, WINDOW_BYTES // per_bin))
    return max(1, WINDOW_BYTES // (8 * m)), 1


def correlate(spec_t, filt, gidx, tidx):
    """One trial's correlation of the transposed spectra ``spec_t``
    ``(nbins, ndm)`` with its per-bin templates: per bin ``k`` the
    ``m``-tap window of ``spec_t`` around ``gidx[k]`` contracted with the
    bank row ``filt[tidx[k]]``, out-of-band taps zero (template edge, not
    wraparound).  Returns ``(nbins, ndm)`` complex, in blocks whose
    gathered window stays within :data:`WINDOW_BYTES` (:func:`_blocks`)."""
    nbins, ndm = spec_t.shape
    m = filt.shape[-1]
    joff = torch.arange(m, device=spec_t.device) - (m - 1) // 2
    out = torch.empty_like(spec_t)
    row_block, bin_block = _blocks(ndm, nbins, m)
    for k0 in range(0, nbins, bin_block):
        k1 = min(nbins, k0 + bin_block)
        cols = gidx[k0:k1, None].to(torch.int64) + joff[None, :]
        valid = (cols >= 0) & (cols < nbins)
        taps = filt[tidx[k0:k1]] * valid.to(filt.dtype)      # (kb, m)
        cols = cols.clamp(0, nbins - 1)
        for d0 in range(0, ndm, row_block):
            d1 = min(ndm, d0 + row_block)
            window = spec_t[:, d0:d1][cols]                  # (kb, m, rows)
            out[k0:k1, d0:d1] = torch.bmm(taps[:, None, :], window)[:, 0]
    return out


def fdas_search(plane, tsamp, accels, *, jerks=None, max_harmonics=16,
                fmin=None, fmax=None, topk=32, device="cuda", mesh=None):
    """Fourier-domain search of the plane ``(ndm, T)`` over the (DM,
    accel[, jerk]) grid: :func:`.accel.accel_search`'s trial order,
    top-k rule and table (a dict of aligned host arrays ``dm_index,
    accel_index, accel, jerk_index, jerk, freq, freq_bin, power, nharm,
    log_sf, sigma``), each row transformed once.

    ``device`` is where it runs (``"cuda"`` by default, raising without
    a card): one ``rfft`` of the plane, cut to the band's prefix; per
    trial the correlation (:func:`correlate`), ``|y|^2`` with the DC bin
    zeroed, and :func:`~..ops.harmonic_cuda.score_power` (the harmonic
    kernel on the card); the ``(ntrials, 5, ndm)`` scores stay on the
    device until the top-k's one readback.  Counts its templates and
    cells in ``putpu_fdas_bank_entries_total`` and
    ``putpu_fdas_trials_total``.  ``mesh`` (a :class:`~..parallel.mesh.
    Mesh` of ``device``'s kind) splits the DM rows over its ``dm`` axis
    and the trials over its ``chan`` axis, each shard transforming its
    rows once (:func:`~.accel.mesh_trial_sweep`)."""
    dev = resolve_device(device)
    plane = torch.as_tensor(plane).to(device=dev, dtype=torch.float32)
    ndm, nsamples = plane.shape
    nbins = int(nsamples) // 2 + 1
    accels = np.atleast_1d(np.asarray(accels, dtype=np.float64))
    t_accels, t_jerks = trial_product(accels, jerks)
    ntrials = len(t_accels)
    lo = None if fmin is None else float(fmin)
    hi = None if fmax is None else float(fmax)
    nbins_c = _band_slice(nbins, nsamples, tsamp, hi, max_harmonics,
                          t_accels, t_jerks)
    tables = bank_for_trials(tuple(t_accels.tolist()),
                             tuple(t_jerks.tolist()), nbins_c,
                             float(tsamp), int(nsamples))
    metrics.counter("putpu_fdas_bank_entries_total").inc(
        int(tables["bank"].shape[0]))
    metrics.counter("putpu_fdas_trials_total").inc(int(ntrials) * int(ndm))

    banks = {}

    def prepare(rows):
        """A shard's rows transformed once, with the bank on its device."""
        d = rows.device
        if str(d) not in banks:
            banks[str(d)] = tuple(
                torch.from_numpy(tables[k]).to(d) for k in ("gidx", "tidx")
            ) + (torch.from_numpy(tables["bank"]).to(
                device=d, dtype=torch.complex64),)
        spec = torch.fft.rfft(rows, dim=-1)[:, :nbins_c].T.contiguous()
        return (spec,) + banks[str(d)]

    def score(ctx, a):
        spec_t, gidx, tidx, filt = ctx
        y = correlate(spec_t, filt, gidx[a], tidx[a])
        power = (y.abs() ** 2).T.contiguous()
        del y
        power[:, 0] = 0.0
        res = score_power(power, nsamples, tsamp,
                          max_harmonics=max_harmonics, fmin=lo, fmax=hi)
        return torch.stack([res[k].to(torch.float32) for k in _SPEC_KEYS])

    if mesh is not None:
        from .accel import mesh_trial_sweep

        stacked = mesh_trial_sweep(plane, mesh, ntrials, prepare, score)
        return topk_table(stacked, topk, accels, tsamp, nsamples,
                          jerks=jerks)
    ctx = prepare(plane)
    stacked = torch.empty((ntrials, 5, ndm), dtype=torch.float32,
                          device=dev)
    for a in range(ntrials):
        stacked[a] = score(ctx, a)
    return topk_table(stacked, topk, accels, tsamp, nsamples, jerks=jerks)
