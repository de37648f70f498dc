"""Acceleration search: time-domain resampling trials over the
accumulated DM–time plane.

The port of the JAX package's ``periodicity/accel.py``.  A pulsar in a
binary accelerates along the line of sight and its apparent frequency
drifts across the observation; for each trial acceleration ``a`` (and
jerk ``j``) the series is resampled at ``n - a t(n)^2 / (2 c t_samp)``
(:func:`stretch_index_table`, host float64 indices), which walks the
drift back out, and the straightened series is scored by the spectral
search (rfft, then the harmonic kernel on the card).

On the device :func:`accel_search` loops over the trials, keeps the
``(ntrials, 5, ndm)`` score pack on the device, runs one top-k (stable
descending sigma: ties to the lower ``(accel, dm)`` flat index, the JAX
package's rule) and reads back once.  With a ``mesh`` the DM rows are
split over its ``dm`` axis and the trials over its ``chan`` axis
(:func:`mesh_trial_sweep`); each shard runs the same per-trial body, so
the score pack, and the table, are the single device's.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..ops.periodicity import _SPEC_KEYS, spectral_stacked
from ..ops.rebin import stretch_resample
from ..utils.device import resolve_device, to_numpy

__all__ = ["C_M_S", "accel_grid", "accel_search", "fractional_resample",
           "jerk_grid", "mesh_trial_sweep", "stretch_index_table",
           "topk_table", "trial_product"]

#: speed of light (m/s) — acceleration trials are in m/s^2
C_M_S = 299792458.0


def stretch_index_table(accels, nsamples, tsamp, jerks=None):
    """Per-trial gather indices ``round(n - kappa n^2 - lam n^3)``,
    ``kappa = a t_samp / (2 c)``, ``lam = j t_samp^2 / (6 c)``, computed
    in host float64 and clipped to the series: ``(n_trials, nsamples)``
    int32.  ``jerks`` broadcasts against ``accels`` (default zero)."""
    n = np.arange(int(nsamples), dtype=np.float64)
    accels = np.atleast_1d(np.asarray(accels, dtype=np.float64))
    kappa = accels[:, None] * float(tsamp) / (2.0 * C_M_S)
    idx = n[None, :] - kappa * n[None, :] ** 2
    if jerks is not None:
        jerks = np.broadcast_to(
            np.atleast_1d(np.asarray(jerks, dtype=np.float64)), accels.shape)
        lam = jerks[:, None] * float(tsamp) ** 2 / (6.0 * C_M_S)
        idx = idx - lam * n[None, :] ** 3
    idx = np.rint(idx)
    return np.clip(idx, 0, int(nsamples) - 1).astype(np.int32)


def fractional_resample(series, accel, tsamp, jerk=0.0):
    """Resample ``series`` (..., T) for one trial acceleration (+jerk):
    a host array stays on the host, a tensor on its device.
    ``accel=0, jerk=0`` is the identity."""
    idx = stretch_index_table(accel, np.shape(series)[-1], tsamp,
                              jerks=jerk)[0]
    if isinstance(series, torch.Tensor):
        return stretch_resample(series, idx)
    return np.take(np.asarray(series), idx, axis=-1)


def _capped_side(n_side, max_trials, axis):
    """Bound a symmetric grid at ``max_trials``; a binding cap warns and
    ticks ``putpu_period_grid_capped_total``, never silent."""
    cap = (int(max_trials) - 1) // 2
    if n_side > cap:
        warnings.warn(
            f"{axis} grid needs {2 * n_side + 1} trials for the "
            f"requested range but max_trials={int(max_trials)} caps it "
            f"at {2 * cap + 1}; trial spacing widens accordingly",
            UserWarning, stacklevel=3)
        _metrics.counter("putpu_period_grid_capped_total", axis=axis).inc()
        return cap
    return n_side


def accel_grid(accel_max, tsamp, nsamples, f_ref=None, max_trials=1025):
    """Symmetric trial accelerations ``[-accel_max, accel_max]`` spaced
    ``2 c / (f_ref T_obs^2)`` (``f_ref`` default Nyquist), always
    including 0; ``accel_max <= 0`` gives the single zero trial."""
    if accel_max <= 0:
        return np.zeros(1)
    t_obs = float(nsamples) * float(tsamp)
    if f_ref is None:
        f_ref = 0.5 / float(tsamp)
    da = 2.0 * C_M_S / (float(f_ref) * t_obs * t_obs)
    n_side = max(int(np.ceil(float(accel_max) / da)), 1)
    n_side = _capped_side(n_side, max_trials, "accel")
    return (np.arange(-n_side, n_side + 1, dtype=np.float64)
            * (float(accel_max) / n_side))


def jerk_grid(jerk_max, tsamp, nsamples, f_ref=None, max_trials=1025):
    """Symmetric trial jerks ``[-jerk_max, jerk_max]`` (m/s^3) spaced
    ``6 c / (f_ref T_obs^3)``, always including 0; ``jerk_max <= 0``
    gives the single zero trial."""
    if jerk_max <= 0:
        return np.zeros(1)
    t_obs = float(nsamples) * float(tsamp)
    if f_ref is None:
        f_ref = 0.5 / float(tsamp)
    dj = 6.0 * C_M_S / (float(f_ref) * t_obs * t_obs * t_obs)
    n_side = max(int(np.ceil(float(jerk_max) / dj)), 1)
    n_side = _capped_side(n_side, max_trials, "jerk")
    return (np.arange(-n_side, n_side + 1, dtype=np.float64)
            * (float(jerk_max) / n_side))


def trial_product(accels, jerks):
    """The ``(accel, jerk)`` grid flattened accel-major: trial ``t`` is
    ``(accels[t // n_jerk], jerks[t % n_jerk])``."""
    accels = np.atleast_1d(np.asarray(accels, dtype=np.float64))
    jerks = np.atleast_1d(np.asarray(jerks if jerks is not None else [0.0],
                                     dtype=np.float64))
    return np.repeat(accels, len(jerks)), np.tile(jerks, len(accels))


def _select_topk(sigma, k):
    """Top-``k`` flat indices of ``sigma`` (n_trials, ndm), stable
    descending: ties go to the lower flat index."""
    flat = np.asarray(sigma, dtype=np.float64).reshape(-1)
    order = np.argsort(-flat, kind="stable")
    return order[: min(int(k), flat.size)]


def _result_table(cells, flat_idx, ndm, accels, tsamp, nsamples,
                  jerks=None):
    """The candidate table from the selected cells ``(k, 5)`` (rows in
    ``_SPEC_KEYS`` order) at flat indices ``trial * ndm + dm``."""
    jerks = np.atleast_1d(np.asarray(jerks if jerks is not None else [0.0],
                                     dtype=np.float64))
    njerk = len(jerks)
    flat_idx = np.asarray(flat_idx, dtype=np.int64)
    t_idx = flat_idx // ndm
    d_idx = flat_idx % ndm
    a_idx = t_idx // njerk
    j_idx = t_idx % njerk
    cells = np.asarray(cells, dtype=np.float64).reshape(len(flat_idx), 5)
    fields = {key: cells[:, i] for i, key in enumerate(_SPEC_KEYS)}
    return {
        "dm_index": d_idx.astype(np.int64),
        "accel_index": a_idx.astype(np.int64),
        "accel": np.asarray(accels, dtype=np.float64)[a_idx],
        "jerk_index": j_idx.astype(np.int64),
        "jerk": jerks[j_idx],
        "freq": fields["freq"],
        "freq_bin": np.rint(fields["freq"] * nsamples * tsamp
                            ).astype(np.int64),
        "power": fields["power"],
        "nharm": np.rint(fields["nharm"]).astype(np.int32),
        "log_sf": fields["log_sf"],
        "sigma": fields["sigma"],
    }


def mesh_trial_sweep(plane, mesh, ntrials, prepare, score):
    """The ``(ntrials, 5, ndm)`` float32 score pack of a trial sweep laid
    over ``mesh`` (the JAX package's sharded accel and FDAS programs): DM
    rows split over the ``dm`` axis, trials over the ``chan`` axis, each
    shard's rows on its device (a view where it is the plane's), and each
    shard running ``score(prepare(rows), trial)`` -> ``(5, rows)`` for
    its trials, ``prepare`` once a shard.  The pack is assembled on the
    mesh's first device.  The mesh is one process's."""
    from ..parallel.sharded import (Placement, dm_chan_axes, norm_device,
                                    shard_bounds, to_device)

    dm_chan_axes(mesh)
    if mesh.process_count > 1:
        raise ValueError("the periodicity trial sweep runs on a "
                         "single-process mesh")
    home = norm_device(mesh.home)
    grid = mesh.grid()
    ndm = plane.shape[0]
    placement = Placement(plane)
    stacked = torch.empty((ntrials, 5, ndm), dtype=torch.float32,
                          device=home)
    for i, (lo, hi) in enumerate(shard_bounds(ndm, grid.shape[0])):
        if hi <= lo:
            continue
        for j, (t0, t1) in enumerate(shard_bounds(ntrials, grid.shape[1])):
            if t1 <= t0:
                continue
            ctx = prepare(placement.slice(grid[i, j], lo, hi))
            for a in range(t0, t1):
                stacked[a, :, lo:hi] = to_device(score(ctx, a), home)
    return stacked


def accel_search(plane, tsamp, accels, *, jerks=None, max_harmonics=16,
                 fmin=None, fmax=None, topk=32, device="cuda", mesh=None):
    """Search the accumulated plane ``(ndm, T)`` over the (DM, accel[,
    jerk]) grid (``jerks`` swept as the accel-major product,
    :func:`trial_product`).  Returns the top-``topk`` candidate table as
    a dict of aligned host arrays: ``dm_index, accel_index, accel,
    jerk_index, jerk, freq, freq_bin, power, nharm, log_sf, sigma``,
    sorted by descending sigma.  ``device`` is where the trials run
    (``"cuda"`` by default, raising without a card); ``mesh`` (a
    :class:`~..parallel.mesh.Mesh` of ``device``'s kind) splits the DM
    rows over its ``dm`` axis and the trials over its ``chan`` axis
    (:func:`mesh_trial_sweep`)."""
    dev = resolve_device(device)
    plane = torch.as_tensor(plane).to(device=dev, dtype=torch.float32)
    ndm, nsamples = plane.shape
    accels = np.atleast_1d(np.asarray(accels, dtype=np.float64))
    t_accels, t_jerks = trial_product(accels, jerks)
    idx_table = stretch_index_table(t_accels, nsamples, tsamp,
                                    jerks=t_jerks)
    ntrials = len(t_accels)
    lo = None if fmin is None else float(fmin)
    hi = None if fmax is None else float(fmax)

    def score(rows, a):
        return spectral_stacked(stretch_resample(rows, idx_table[a]), tsamp,
                                max_harmonics=max_harmonics, fmin=lo, fmax=hi)

    if mesh is not None:
        stacked = mesh_trial_sweep(plane, mesh, ntrials, lambda rows: rows,
                                   score)
        return topk_table(stacked, topk, accels, tsamp, nsamples,
                          jerks=jerks)
    stacked = torch.empty((ntrials, 5, ndm), dtype=torch.float32,
                          device=dev)
    for a in range(ntrials):
        stacked[a] = score(plane, a)
    return topk_table(stacked, topk, accels, tsamp, nsamples, jerks=jerks)


def topk_table(stacked, topk, accels, tsamp, nsamples, jerks=None):
    """The candidate table of a device score pack ``stacked``
    ``(ntrials, 5, ndm)``: one stable descending sort of its sigmas on
    the device (ties to the lower ``(trial, dm)`` flat index, the JAX
    package's rule), the top ``topk`` cells gathered there, one
    readback."""
    ndm = stacked.shape[2]
    sigma = stacked[:, _SPEC_KEYS.index("sigma"), :].reshape(-1)
    k = min(int(topk), sigma.numel())
    flat = torch.sort(sigma, descending=True, stable=True).indices[:k]
    cells = stacked[flat // ndm, :, flat % ndm]
    host = to_numpy(torch.cat([cells.to(torch.float64),
                               flat[:, None].to(torch.float64)], dim=1))
    return _result_table(host[:, :5], host[:, 5].astype(np.int64), ndm,
                         accels, tsamp, nsamples, jerks=jerks)
