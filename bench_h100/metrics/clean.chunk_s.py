"""Seconds a chunk spent in the decode and the cleaning on the card: the
accountant's ``clean`` bucket, per chunk."""

BUCKETS = ("clean",)


def read(view):
    if not view.chunks:
        return None
    return sum(c["buckets"].get(b, 0.0) for c in view.chunks
               for b in BUCKETS) / len(view.chunks)
