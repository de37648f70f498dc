"""The comparison that decides ``correct``, shared by the drivers: the
plain reference works each compared chunk out again from the files, and
each number compared is printed beside its limit."""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from ..reference import filterbank as ref_fb
from ..reference import search as ref


class RefPointing:
    """One beam's file, as the reference reads it: its plan, its trial
    grid and its cleaned chunks."""

    def __init__(self, path, dmmin, dmmax, device):
        self.path = path
        self.device = device
        self.header, _ = ref_fb.read_header(path)
        h = self.header
        self.nchan, self.nbits, self.tsamp = (h["nchans"], h["nbits"],
                                              h["tsamp"])
        self.fbottom, self.bandwidth, self.descending = ref_fb.band(h)
        self.step, self.hop, self.resample = ref.chunk_plan(
            self.tsamp, dmmin, dmmax, self.fbottom,
            self.fbottom + self.bandwidth, self.bandwidth / self.nchan)
        self.eff_tsamp = self.tsamp * self.resample
        self.dms = ref.trial_dms(dmmin, dmmax, self.fbottom, self.bandwidth,
                                 self.eff_tsamp)
        self.nsamples = h["nsamples_in_file"]
        bad = None
        if os.path.exists(path + ".badchans"):
            bad = ref_fb.read_badchans(path + ".badchans")
            bad = bad[::-1].copy() if self.descending else bad
        self.bad = bad
        self._offsets = {}

    def offsets(self, n):
        if n not in self._offsets:
            self._offsets[n] = torch.from_numpy(ref.offsets(
                self.dms, self.nchan, self.fbottom, self.bandwidth,
                self.eff_tsamp, n)).to(self.device)
        return self._offsets[n]

    def chunk(self, istart):
        """The cleaned chunk at ``istart``, ascending band, float32."""
        frames = ref_fb.read_frames(self.path, istart, self.step)
        codes = ref_fb.decode(frames, self.nbits, self.nchan, self.device)
        if self.descending:
            codes = codes.flip(0)
        return ref.clean(codes, self.bad, self.resample)

    def rows(self, x, rows, dtype=torch.float32):
        """Reference scores of trial ``rows`` of the cleaned chunk ``x``."""
        offs = self.offsets(x.shape[1])[torch.as_tensor(
            np.asarray(rows, dtype=np.int64), device=self.device)]
        return ref.sweep_scores(x, offs, dtype)

    def all_rows(self, x, dtype=torch.float32):
        return ref.sweep_scores(x, self.offsets(x.shape[1]), dtype)


def pick(n, k, seed, salt):
    """``k`` of ``range(n)`` drawn from ``seed``."""
    return sorted(random.Random(f"{seed}:{salt}").sample(range(n),
                                                         min(k, n)))


def verdict(numbers, limits):
    """``(correct, checks)``: each number beside its limit, correct where
    none exceeds its limit (a missing number is not correct)."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not np.isfinite(value) or value > limit:
            ok = False
    return ok, checks
