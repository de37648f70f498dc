"""Seconds a chunk spent in its search (sweep, scores, readback): the
accountant's ``search`` bucket, per chunk."""

BUCKETS = ("search",)


def read(view):
    if not view.chunks:
        return None
    return sum(c["buckets"].get(b, 0.0) for c in view.chunks
               for b in BUCKETS) / len(view.chunks)
