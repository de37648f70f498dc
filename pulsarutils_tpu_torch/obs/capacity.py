"""Chunk throughput for the live ETA: an EWMA of chunks per second.

The part of the JAX package's capacity module the single-process chunk
loop uses (``/progress``'s ETA); the fleet's utilization, saturation and
scaling advice come with the port's fleet.
"""

from __future__ import annotations

__all__ = ["EwmaThroughput"]


class EwmaThroughput:
    """Exponentially-weighted chunks-per-second estimate.

    The naive ``done/elapsed`` extrapolation misleads mid-survey when
    chunk walls drift (compile warm-up, DM-dependent overlap, a worker
    degrading) — the EWMA tracks the *current* rate, so ETAs follow the
    drift instead of averaging it away.
    """

    def __init__(self, alpha=0.3):
        self.alpha = float(alpha)
        self.rate = None   # chunks/s
        self.n = 0         # observations folded in

    def note(self, chunks, wall_s):
        """Fold one completed batch (``chunks`` finished in ``wall_s``
        seconds).  Zero/negative walls are dropped, not folded — a
        clock hiccup must not poison the estimate."""
        chunks = float(chunks)
        wall_s = float(wall_s)
        if wall_s <= 0.0 or chunks <= 0.0:
            return
        rate = chunks / wall_s
        self.rate = (rate if self.rate is None
                     else self.alpha * rate + (1.0 - self.alpha) * self.rate)
        self.n += 1

    def eta_s(self, remaining):
        """Seconds to finish ``remaining`` chunks at the current rate
        (``None`` without evidence)."""
        if self.rate is None or self.rate <= 0.0:
            return None
        return float(remaining) / self.rate
