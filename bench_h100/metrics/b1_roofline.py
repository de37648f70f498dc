"""B1's share of its roofline: the direct sweep (``csrc/dedisperse.cu``).

Time: the card's time in the kernels whose names hold one of
``KERNELS``, from the traced run's profiler.  Work: what the window's
searched chunks need, counted once by the benchmark's frozen formulas
(:mod:`bench_h100.reference.work`), against the card's published
peaks."""

from bench_h100.reference import work

KERNELS = ("dedisperse_kernel",)


def read(view):
    seconds = sum(s for name, s in view.kernels.items()
                  if any(k in name for k in KERNELS))
    if seconds <= 0 or not view.rec["searched"]:
        return None
    g = view.geometry
    ndm, nchan, nsamples = g["ndm"], g["nchan"], g["nsamples"]
    adds, nbytes = work.sweep_work(ndm, nchan, nsamples)
    units = view.rec["searched"]
    peaks = work.PEAKS.get(view.device_kind)
    if peaks is None:
        return None
    return 100.0 * work.bound_s(adds * units, nbytes * units, peaks) \
        / seconds
