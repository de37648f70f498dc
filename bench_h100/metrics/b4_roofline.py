"""B4's share of its roofline: the boxcar scorer (``csrc/score.cu``).

Time: the card's time in the kernels whose names hold one of
``KERNELS``, from the traced run's profiler.  Work: what the window's
searched chunks need, counted once by the benchmark's frozen formulas
(:mod:`bench_h100.reference.work`), against the card's published
peaks."""

from bench_h100.reference import work

KERNELS = ("score_kernel",)


def read(view):
    seconds = sum(s for name, s in view.kernels.items()
                  if any(k in name for k in KERNELS))
    if seconds <= 0 or not view.rec["searched"]:
        return None
    g = view.geometry
    ndm, nchan, nsamples = g["ndm"], g["nchan"], g["nsamples"]
    adds, nbytes = work.score_work(ndm, nsamples, 5 * ndm)
    units = view.rec["searched"]
    peaks = work.PEAKS.get(view.device_kind)
    if peaks is None:
        return None
    return 100.0 * work.bound_s(adds * units, nbytes * units, peaks) \
        / seconds
