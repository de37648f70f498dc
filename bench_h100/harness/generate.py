"""The one traffic generator: a pointing's filterbank files, made on the
card from ``--seed``.

Every beam is Gaussian noise, digitised by the configuration's quantiser
(``quantiser_thresholds``, in units of the noise's sigma) and packed as the
backend writes it.  The traffic file adds, under ``data``:

* ``bad_chan_frac``: a share of channels (the same count for every seed,
  which channels drawn from it) that carry hot, wide noise, listed in a
  ``.badchans`` file beside each beam as a survey's static zap list;
* ``impulses``: broadband undispersed bursts (zero DM), in every beam;
* ``pulses``: dispersed pulses at a nominal S/N, in one beam and, with
  ``adjacent_snr_frac``, weaker in one beam next to it (every
  ``adjacent_every``-th pulse); with ``one_source`` all from one source
  (one DM, one pair of beams).

Each kind of event arrives on a fixed schedule, late by a seed-drawn
jitter; its DMs, widths and strengths are fixed quantiles of the ranges,
paired and dealt to the arrivals the same way for every seed.  So every
seed carries the same events at nearly the same times, and a window
reaches the same work whatever the seed; the seed changes the noise, the
jitter, the bad channels and the beams.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .sigproc_out import write_header

DM_CONST = 4149.0

#: samples generated on the card at once
BLOCK = 1 << 19


def _phi(x):
    return math.exp(-0.5 * x * x) / math.sqrt(2 * math.pi)


def quantiser_gain(thresholds):
    """S/N of one sample per unit of signal (in sigma) after the quantiser:
    the slope of the code's mean over the code's standard deviation."""
    cdf = [0.5 * (1 + math.erf(t / math.sqrt(2))) for t in thresholds]
    probs = np.diff([0.0] + cdf + [1.0])
    codes = np.arange(len(probs))
    mean = float((probs * codes).sum())
    std = math.sqrt(float((probs * (codes - mean) ** 2).sum()))
    return sum(_phi(t) for t in thresholds) / std


def _quantiles(lo, hi, n, log=False):
    u = (np.arange(n) + 0.5) / n
    if log:
        return np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    return lo + u * (hi - lo)


def _pairing(n, salt):
    """A fixed permutation of ``range(n)``: which quantile of one quantity
    goes with which of another, the same for every seed."""
    return np.random.default_rng(salt).permutation(n)


def _arrivals(spec, tobs, span, rng):
    """Arrival times of a kind: ``first_s`` then every ``every_s`` (up to
    ``until_s``, if given), each late by a seed-drawn share of
    ``jitter_s``, all before ``tobs - span``."""
    times = []
    t = float(spec["first_s"])
    end = min(tobs, float(spec.get("until_s", tobs)) + span)
    while t + float(spec.get("jitter_s", 0.0)) + span < end:
        times.append(t + rng.uniform(0.0, float(spec.get("jitter_s", 0.0))))
        t += float(spec["every_s"])
    return times


def plan_events(config, data, seed):
    """The pointing's events, as plain numbers: a list of dicts with
    ``kind``, ``beams`` ({label: amplitude in sigma}), ``t0`` (seconds, at
    the top of the band), ``dm``, ``width_s``.

    Each kind arrives on its own fixed schedule (``first_s``, ``every_s``,
    ``until_s``, ``jitter_s``) and takes its sizes in a fixed order, so the
    events a window reaches, and the work they make (a hit's persisted
    cutout spans
    its DM's sweep), are the same for every seed.  ``impulses`` are
    undispersed and in every beam.  ``pulses`` come from one source a
    pointing (``one_source``: the median DM, in a beam drawn from the
    seed) or each in a beam of its own; with ``adjacent_snr_frac`` a
    weaker copy lands in a beam next to the source's (every
    ``adjacent_every``-th pulse)."""
    rng = np.random.default_rng(seed)
    nsamples, tsamp = config["nsamples"], config["tsamp"]
    tobs = nsamples * tsamp
    labels = [b["ibeam"] for b in config["beams"]]
    fch = config["fch1"] + np.arange(config["nchans"]) * config["foff"]
    sweep_per_dm = DM_CONST * (fch.min() ** -2.0 - fch.max() ** -2.0)
    ngood = config["nchans"] - int(round(data.get("bad_chan_frac", 0.0)
                                         * config["nchans"]))
    gain = quantiser_gain(config["quantiser_thresholds"])
    adjacency = {int(k): v for k, v in config.get("adjacency", {}).items()}
    events = []
    imp = data.get("impulses")
    if imp:
        times = _arrivals(imp, tobs, float(imp["width_ms"][1]) / 1e3, rng)
        n = len(times)
        widths = _quantiles(*imp["width_ms"], n, log=True) / 1e3
        amps = _quantiles(*imp["amp_sigma"], n)[_pairing(n, 1)]
        for k, t in enumerate(times):
            events.append({"kind": "impulse", "t0": t, "dm": 0.0,
                           "width_s": float(widths[k]),
                           "beams": {b: float(amps[k]) for b in labels}})
    pul = data.get("pulses")
    if pul:
        span = float(pul["dm"][1]) * sweep_per_dm + float(
            pul["width_ms"][1]) / 1e3
        times = _arrivals(pul, tobs, span, rng)
        n = len(times)
        dms = _quantiles(*pul["dm"], n)
        widths = _quantiles(*pul["width_ms"], n, log=True)[_pairing(n, 2)] \
            / 1e3
        snrs = _quantiles(*pul["snr"], n)[_pairing(n, 3)]
        frac = pul.get("adjacent_snr_frac")
        fracs = (_quantiles(*frac, n)[_pairing(n, 4)] if frac
                 else [None] * n)
        source = None
        if pul.get("one_source"):
            beam = labels[int(rng.integers(len(labels)))]
            nbrs = sorted(adjacency.get(beam, ()))
            source = (float(np.median(dms)), beam,
                      nbrs[int(rng.integers(len(nbrs)))] if nbrs else None)
        for k, t in enumerate(times):
            if source:
                dm, beam, nb = source
            else:
                dm, beam = float(dms[k]), labels[int(rng.integers(
                    len(labels)))]
                nbrs = sorted(adjacency.get(beam, ()))
                nb = nbrs[int(rng.integers(len(nbrs)))] if nbrs else None
            wsamp = max(1, int(round(widths[k] / tsamp)))
            # the nominal S/N of the widest boxcar the search tries
            amp = snrs[k] / (gain * math.sqrt(ngood * min(wsamp, 8)))
            beams = {beam: float(amp)}
            if fracs[k] is not None and nb is not None \
                    and k % int(pul.get("adjacent_every", 1)) == 0:
                beams[nb] = float(amp * fracs[k])
            events.append({"kind": "pulse", "t0": t, "dm": dm,
                           "width_s": float(widths[k]), "beams": beams})
    return sorted(events, key=lambda e: e["t0"])


def _event_cells(config, ev, device):
    """``(sample, channel)`` index tensors an event covers (file order)."""
    tsamp, nchans = config["tsamp"], config["nchans"]
    fch = config["fch1"] + np.arange(nchans) * config["foff"]
    delay = DM_CONST * ev["dm"] * (fch ** -2.0 - fch.max() ** -2.0)
    start = np.rint((ev["t0"] + delay) / tsamp).astype(np.int64)
    wsamp = max(1, int(round(ev["width_s"] / tsamp)))
    samples = start[:, None] + np.arange(wsamp)[None, :]
    chans = np.repeat(np.arange(nchans), wsamp)
    return (torch.from_numpy(samples.reshape(-1)).to(device),
            torch.from_numpy(chans).to(device))


def _pack(codes, nbits):
    """``(n, nchans)`` uint8 codes -> ``(n, nchans * nbits / 8)`` bytes,
    the first channel in the lowest bits."""
    per = 8 // nbits
    parts = codes.reshape(codes.shape[0], -1, per)
    out = torch.zeros(parts.shape[:2], dtype=torch.uint8,
                      device=codes.device)
    for k in range(per):
        out |= parts[..., k] << (k * nbits)
    return out


def make_pointing(config, traffic, seed, directory, device):
    """Write the pointing's files under ``directory``; returns ``(paths,
    events, bad)``: one path per beam, the events and the bad channels
    (file order; None without any)."""
    data = traffic.get("data", {})
    os.makedirs(directory, exist_ok=True)
    nchans, nbits, nsamples = (config["nchans"], config["nbits"],
                               config["nsamples"])
    rng = np.random.default_rng([seed, 1])
    nbad = int(round(data.get("bad_chan_frac", 0.0) * nchans))
    bad = None
    if nbad:
        bad = np.zeros(nchans, dtype=bool)
        bad[rng.choice(nchans, nbad, replace=False)] = True
    events = plan_events(config, data, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    thresholds = torch.tensor(config["quantiser_thresholds"],
                              dtype=torch.float32, device=device)
    bad_t = None if bad is None else torch.from_numpy(bad).to(device)
    paths = []
    for beam in config["beams"]:
        label = beam["ibeam"]
        cells = [(_event_cells(config, ev, device), ev["beams"][label])
                 for ev in events if label in ev["beams"]]
        path = os.path.join(directory, f"{config['name']}_beam{label:02d}.fil")
        with open(path, "wb") as f:
            f.write(write_header(config, label))
            for s0 in range(0, nsamples, BLOCK):
                n = min(BLOCK, nsamples - s0)
                x = torch.randn((n, nchans), generator=gen, device=device)
                if bad_t is not None:
                    x[:, bad_t] = x[:, bad_t] * 3.0 + 1.5
                for (samples, chans), amp in cells:
                    keep = (samples >= s0) & (samples < s0 + n)
                    if bool(keep.any()):
                        idx = (samples[keep] - s0, chans[keep])
                        x.index_put_(idx, torch.full(idx[0].shape, amp,
                                                     device=device),
                                     accumulate=True)
                codes = torch.bucketize(x, thresholds).to(torch.uint8)
                del x
                f.write(_pack(codes, nbits).cpu().numpy().tobytes())
        if bad is not None:
            with open(path + ".badchans", "w") as f:
                f.write(" ".join(str(int(v)) for v in bad) + "\n")
        paths.append(path)
    return paths, events, bad
