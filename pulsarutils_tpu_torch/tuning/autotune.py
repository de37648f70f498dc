"""The periodicity backends' equivalence check and its probe plane.

A copy of the part of the JAX package's ``tuning/autotune.py`` that
holds ``accel_backend="time_stretch"`` and ``"fdas"`` to one contract:
:func:`accel_tables_match` and :func:`synthetic_accel_plane` (host
NumPy).  The measured tuner that resolves ``accel_backend="auto"`` and
the single-pulse kernel choice is not ported yet (ROADMAP.md queue A,
A8): the port resolves both statically.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ACCEL_SIGMA_RTOL", "accel_tables_match", "synthetic_accel_plane"]


#: cross-backend sigma tolerance of :func:`accel_tables_match`.  The
#: two formulations window the signal differently — integer-sample
#: stretch resampling scallops power by ~sinc^2(f0*tsamp) where the
#: truncated z/w-response template clips a few percent of template
#: energy — so bit-exact sigma equality ACROSS backends is not a
#: theorem (within a backend, the card and the CPU agree cell for
#: cell).  The discrete cell identity IS a theorem at matched trial
#: grids, and that is what the check pins exactly.
ACCEL_SIGMA_RTOL = 0.12


def accel_tables_match(ref, cand, rtol=ACCEL_SIGMA_RTOL):
    """Whether two periodicity trial tables find the same candidate.

    ``ref``/``cand`` are top-k candidate tables over the same probe
    trial grid (rows ranked best-first).  Equivalent means: the top
    candidate's discrete cell — DM row, acceleration/jerk trial index,
    harmonic depth — agrees EXACTLY, its frequency lands on the same
    Fourier bin, and its sigma agrees within ``rtol``
    (:data:`ACCEL_SIGMA_RTOL`).  A backend failing this must not replace
    the other, however fast it runs: a choice of backend may change
    speed, never hits.
    """
    if ref is None or cand is None:
        return False
    try:
        if (len(np.asarray(ref["sigma"])) == 0
                or len(np.asarray(cand["sigma"])) == 0):
            return False
        for col in ("dm_index", "accel_index", "jerk_index", "nharm"):
            if col in ref and col in cand and (
                    int(np.asarray(ref[col])[0])
                    != int(np.asarray(cand[col])[0])):
                return False
        if not np.isclose(float(np.asarray(cand["freq"])[0]),
                          float(np.asarray(ref["freq"])[0]),
                          rtol=1e-5, atol=0.0):
            return False
        return bool(np.isclose(float(np.asarray(cand["sigma"])[0]),
                               float(np.asarray(ref["sigma"])[0]),
                               rtol=float(rtol), atol=1e-2))
    except (KeyError, IndexError, TypeError, ValueError):
        return False


def synthetic_accel_plane(ndm, nsamples, tsamp, accel, jerk=0.0,
                          amp=0.6, seed=1601):
    """Seeded noise plane + one accelerated sinusoid on a probe trial.

    The injection row is ``ndm // 3`` (the canary convention) and the
    phase model is the time-stretch backend's own —
    ``phi = f0*(t + a*t^2/(2c) + j*t^3/(6c))`` — with ``f0`` placed on
    an exact Fourier bin well below Nyquist (scalloping and template
    truncation both stay small there), so both backends must put their
    top cell on the injection: the decisive comparison
    :func:`accel_tables_match` makes.
    """
    from ..periodicity.accel import C_M_S

    rng = np.random.default_rng(seed)
    plane = rng.standard_normal((int(ndm), int(nsamples)))
    k0 = max(int(round(0.175 * int(nsamples))), 4)
    f0 = k0 / (int(nsamples) * float(tsamp))
    t = np.arange(int(nsamples)) * float(tsamp)
    phase = f0 * (t + float(accel) * t * t / (2.0 * C_M_S)
                  + float(jerk) * t ** 3 / (6.0 * C_M_S))
    plane[int(ndm) // 3] += amp * np.sin(2.0 * np.pi * phase)
    return plane
