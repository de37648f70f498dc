"""Candidate diagnostic figures and the plane's periodicity scores.

The port of the JAX package's module (itself the capability of the
reference's 7-panel candidate figure, ``pulsarutils/clean.py:192-269``,
built from the table and plane the search already computed instead of a
second search).  Panels, in the JAX package's layout: the raw and the
dedispersed waterfall, their band-averaged light curves, the DM-time
plane, S/N against DM and the H test against DM.

What crosses to the host.  The JAX package reads the whole chunk and
plane back and decimates there.  Here every array stays on its device
until it is small: the dedispersed waterfall
(:func:`..ops.dedisperse.apply_dm_shifts_to_data`), the time decimation
by the best row's boxcar (:func:`..ops.rebin.quick_resample`), the light
curves, and the plane's H test (:func:`plane_h_test`: digitised and
scored with one FFT, :mod:`..ops.robust`) are computed on the card, and
only the decimated images, the curves and the H values are read back.
An image wider than :data:`MAX_IMAGE_COLUMNS` is summed further in time
before it is read back (it is drawn into a 600-pixel-wide figure): at
the chunk sizes of a survey the JAX package's full-width meshes take
minutes and gigabytes to draw.  Below that width the figure's arrays are
the JAX package's.

Headless-safe: the Agg backend is pinned before pyplot is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.dedisperse import apply_dm_shifts_to_data
from ..ops.plan import dedispersion_shifts
from ..ops.rebin import quick_resample
from ..ops.robust import digitize, h_test_batch
from ..utils.device import to_numpy

#: widest image panel drawn; wider images are summed in time by the
#: least integer factor that fits
MAX_IMAGE_COLUMNS = 1024


def plane_h_test(plane, nmax=None):
    """H-test score of every plane row (trial DM), on the plane's device:
    the plane digitised globally, every row scored with one real FFT.
    Returns host ``(H, m)`` arrays."""
    plane = torch.as_tensor(plane)
    if nmax is None:
        nmax = max(1, plane.shape[1] // 10)
    counts = torch.clamp(digitize(plane), min=0)
    h, m = h_test_batch(counts, nmax=nmax)
    return to_numpy(h), to_numpy(m)


def _image(x, factor):
    """``(image, its time factor)``: ``x`` summed in time further when it
    is wider than :data:`MAX_IMAGE_COLUMNS`, read back."""
    extra = -(-x.shape[1] // MAX_IMAGE_COLUMNS)
    if extra > 1:
        x = quick_resample(x, extra)
    return to_numpy(x), factor * extra


def figure_arrays(info, table, plane, waterfall=None):
    """The figure's host arrays, computed on the data's device: the raw
    and dedispersed images and light curves decimated by the best row's
    boxcar, the plane's image and its rows' H values.  ``waterfall``
    (default ``info.allprofs``) is the cleaned ``(nchan, T)`` chunk.
    ``plane`` may be a :class:`~..parallel.sharded_plane.ShardedPlane`:
    its H curve is then per shard and its image is its shards' block
    sums by the least factor that fits :data:`MAX_IMAGE_COLUMNS` (the
    JAX package's mesh figure sums to at most 2048 columns)."""
    array = torch.as_tensor(info.allprofs if waterfall is None
                            else waterfall)
    sample_time = 1.0 / info.pulse_freq / info.nbin
    best = table.argbest("snr")
    window = int(table["rebin"][best])
    shifts = dedispersion_shifts(info.nchan, float(table["DM"][best]),
                                 info.start_freq, info.bandwidth,
                                 sample_time)
    array_r = quick_resample(array, window)
    dedisp_r = quick_resample(apply_dm_shifts_to_data(array, shifts),
                              window)
    out = {"window": window, "sample_time": sample_time,
           "lc_raw": to_numpy(array_r.mean(0)),
           "lc_dedisp": to_numpy(dedisp_r.mean(0))}
    images = [("raw", array_r), ("dedisp", dedisp_r)]
    if hasattr(plane, "h_curve"):
        # the mesh route: a dm-sharded plane on its devices
        # (:class:`~..parallel.sharded_plane.ShardedPlane`); the H curve
        # and the plane image are its shard-local products, the whole
        # plane is never gathered
        out["h"], _ = plane.h_curve(window)
        out["plane"], out["plane_factor"] = plane.decimated(
            MAX_IMAGE_COLUMNS)
    else:
        plane_r = quick_resample(torch.as_tensor(plane), window)
        out["h"], _ = plane_h_test(plane_r)
        images.append(("plane", plane_r))
    for name, img in images:
        out[name], out[name + "_factor"] = _image(img, window)
    return out


def plot_diagnostics(info, table, plane, outname="info.jpg", t0=0.0,
                     show=False, waterfall=None):
    """Render the candidate diagnostic figure to ``outname``.

    ``info`` is the chunk's :class:`..pipeline.pulse_info.PulseInfo`
    (geometry fields, ``date``, the period fields); ``table`` and
    ``plane`` the chunk's search result and dedispersed plane;
    ``waterfall`` the cleaned chunk when ``info.allprofs`` holds a
    cutout.  ``show`` also opens the figure in an interactive window (a
    no-op under a non-interactive backend)."""
    fig, _axes = build_diagnostic_figure(info, table, plane, t0=t0,
                                         interactive=show,
                                         waterfall=waterfall)
    import matplotlib.pyplot as plt

    fig.savefig(outname, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)
    return outname


def _edges(n, width, t0):
    return np.arange(n + 1) * width + t0


def build_diagnostic_figure(info, table, plane, t0=0.0, interactive=False,
                            waterfall=None):
    """Build (but do not save) the 7-panel figure.

    Returns ``(fig, axes)``, ``axes`` a dict keyed ``raw, dedisp, lc_raw,
    lc_dedisp, plane, snr, h``, as the JAX package's function does.
    ``interactive=False`` pins the Agg backend."""
    import matplotlib

    if not interactive:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    arrays = figure_arrays(info, table, plane, waterfall=waterfall)
    sample_time, window = arrays["sample_time"], arrays["window"]
    nchan = info.nchan
    best = table.argbest("snr")
    dm = float(table["DM"][best])
    snr = float(table["snr"][best])
    trial_dms = np.asarray(table["DM"])

    allfreqs = np.linspace(info.start_freq, info.start_freq + info.bandwidth,
                           nchan + 1)
    nbins_r = arrays["lc_raw"].shape[0]
    dt_r = sample_time * window
    times = np.arange(nbins_r) * dt_r + t0
    dm_edges = np.concatenate([
        [trial_dms[0] - 0.5 * (trial_dms[1] - trial_dms[0])] if
        trial_dms.size > 1 else [trial_dms[0] - 0.5],
        0.5 * (trial_dms[1:] + trial_dms[:-1]),
        [trial_dms[-1] + 0.5 * (trial_dms[-1] - trial_dms[-2])] if
        trial_dms.size > 1 else [trial_dms[0] + 0.5],
    ])

    def tedges(name):
        return _edges(arrays[name].shape[1],
                      sample_time * arrays[name + "_factor"], t0)

    fig = plt.figure(figsize=(10, 8), dpi=60)
    gs = plt.GridSpec(3, 3, height_ratios=(1.5, 1, 1),
                      width_ratios=[0.5, 0.5, 1], hspace=0.01, wspace=0.01)
    ax_raw = plt.subplot(gs[2, 0:2])
    ax_ded = plt.subplot(gs[2, 2], sharex=ax_raw, sharey=ax_raw)
    ax_lc_raw = plt.subplot(gs[1, 0:2], sharex=ax_raw)
    ax_lc_ded = plt.subplot(gs[1, 2], sharex=ax_raw, sharey=ax_lc_raw)
    ax_plane = plt.subplot(gs[0, 2], sharex=ax_raw)
    ax_snr = plt.subplot(gs[0, 0])
    ax_h = plt.subplot(gs[0, 1])

    for ax in (ax_snr, ax_h, ax_plane, ax_lc_raw, ax_lc_ded):
        ax.tick_params(labelbottom=False)
    for ax in (ax_plane, ax_lc_ded, ax_ded):
        ax.tick_params(labelleft=False)

    ax_raw.set_xlabel("Time (s)")
    ax_ded.set_xlabel("Time (s)")
    ax_raw.set_ylabel("Frequency (MHz)")
    ax_lc_raw.set_ylabel("Flux (arbitrary units)")
    ax_snr.set_ylabel("Trial DM")
    ax_snr.set_xlabel("S/N")
    ax_h.set_xlabel("H test")

    ax_raw.pcolormesh(tedges("raw"), allfreqs, arrays["raw"],
                      rasterized=True)
    ax_ded.pcolormesh(tedges("dedisp"), allfreqs, arrays["dedisp"],
                      rasterized=True)
    ax_lc_raw.plot(times, arrays["lc_raw"], rasterized=True)
    ax_lc_ded.plot(times, arrays["lc_dedisp"], rasterized=True)
    ax_plane.pcolormesh(tedges("plane"), dm_edges, arrays["plane"],
                        rasterized=True)
    ax_snr.plot(-np.asarray(table["snr"]), trial_dms)
    ax_h.plot(-arrays["h"], trial_dms)
    ax_raw.set_xlim(t0, times[-1])

    date = info.date if info.date is not None else "unknown"
    text = (f"Obs. Date: {date}\n"
            f"Freq: {info.start_freq}--{info.start_freq + info.bandwidth}\n"
            f"Best DM: {dm:.2f}\n"
            f"Best SNR: {snr:.2f}")
    if getattr(info, "period_freq", None):
        text += (f"\nPeriod: {1.0 / info.period_freq * 1e3:.3f} ms "
                 f"({info.period_sigma:.1f}σ)")
    ax_snr.text(0.5, 0.5, text, va="center", ha="center", fontsize=7,
                transform=ax_snr.transAxes)

    if getattr(info, "fold_profile", None) is not None:
        # folded-pulse inset (two cycles) for periodic candidates
        ax_fold = ax_h.inset_axes([0.45, 0.62, 0.5, 0.33])
        prof = np.asarray(info.fold_profile, dtype=float)
        cyc = np.concatenate([prof, prof])
        ax_fold.plot(np.arange(cyc.size) / prof.size, cyc, lw=0.8)
        ax_fold.set_xticks([]), ax_fold.set_yticks([])
        ax_fold.set_title("folded", fontsize=6, pad=1)

    return fig, {"raw": ax_raw, "dedisp": ax_ded, "lc_raw": ax_lc_raw,
                 "lc_dedisp": ax_lc_ded, "plane": ax_plane, "snr": ax_snr,
                 "h": ax_h}
