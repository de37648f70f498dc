"""Candidate / chunk record with periodicity-statistic slots.

The port of the JAX package's ``PulseInfo`` (a typed form of the
reference's ``pulsarutils/clean.py:27-55`` record): every field is a
dataclass field, :meth:`PulseInfo.compute_stats` fills the Z^2_n / H / M
slots, and persistence is npz plus a JSON scalar record, so files written
by either package load in the other.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..ops.robust import digitize, h_test, z_n_test
from ..utils.device import to_numpy

_ARRAY_FIELDS = ("allprofs", "dedisp_profile", "disp_profile",
                 "fold_profile")


@dataclasses.dataclass
class PulseInfo:
    # chunk geometry / metadata
    nbin: int = 0
    nchan: int = 0
    start_freq: float | None = None
    bandwidth: float | None = None
    pulse_freq: float | None = None
    date: float | None = None          # MJD of observation start
    t0: float | None = None            # chunk start time (s into the file)
    istart: int | None = None          # chunk start sample in the file
    ibeam: int | None = None
    nbeams: int | None = None

    # candidate parameters
    dm: float | None = None
    snr: float | None = None
    width: float | None = None
    amp: float | None = None
    ph0: float | None = None
    noise_level: float | None = None

    # data products
    allprofs: np.ndarray | None = None        # (nchan, nbin) waterfall
    disp_profile: np.ndarray | None = None    # band-averaged, dispersed
    dedisp_profile: np.ndarray | None = None  # band-averaged, dedispersed
    # when the store trims the waterfall to a window around the pulse:
    # the window's first column in the searched chunk's samples, and its
    # time decimation factor
    cutout_start: int | None = None
    cutout_decim: int | None = None

    # folded-period-search candidate (not produced by this package yet)
    period_freq: float | None = None
    period_dm: float | None = None
    period_sigma: float | None = None
    period_H: float | None = None
    period_M: int | None = None
    fold_profile: np.ndarray | None = None

    # periodicity statistics (reference clean.py:43-55 slots)
    disp_z2: float | None = None
    disp_z6: float | None = None
    disp_z12: float | None = None
    disp_z20: float | None = None
    disp_H: float | None = None
    disp_M: int | None = None
    dedisp_z2: float | None = None
    dedisp_z6: float | None = None
    dedisp_z12: float | None = None
    dedisp_z20: float | None = None
    dedisp_H: float | None = None
    dedisp_M: int | None = None

    def compute_stats(self):
        """Fill the Z^2_n / H-test slots from the stored profiles, digitized
        to counts first; harmonics the profile cannot resolve stay None."""
        for prefix, profile in (("disp", self.disp_profile),
                                ("dedisp", self.dedisp_profile)):
            if profile is None:
                continue
            counts = np.maximum(to_numpy(digitize(np.asarray(profile))), 0)
            nmax = counts.size // 2
            for n in (2, 6, 12, 20):
                if n <= nmax:
                    setattr(self, f"{prefix}_z{n}",
                            float(z_n_test(counts, n)))
            h, m = h_test(counts, nmax=min(20, max(nmax, 1)))
            setattr(self, f"{prefix}_H", float(h))
            setattr(self, f"{prefix}_M", int(m))
        return self

    def save(self, path):
        """Write as ``<path>`` npz (arrays + a json-encoded scalar record)."""
        scalars = {}
        arrays = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if f.name in _ARRAY_FIELDS:
                if value is not None:
                    arrays[f.name] = to_numpy(value)
            elif value is not None:
                scalars[f.name] = value
        np.savez_compressed(path, __scalars__=json.dumps(scalars), **arrays)
        return path

    @classmethod
    def load(cls, path):
        with np.load(path, allow_pickle=False) as data:
            scalars = json.loads(str(data["__scalars__"]))
            info = cls(**scalars)
            for name in _ARRAY_FIELDS:
                if name in data.files:
                    setattr(info, name, data[name])
        return info
