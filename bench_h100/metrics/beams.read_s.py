"""Seconds an epoch spent reading every beam's packed chunk: the
accountant's ``read`` bucket, per epoch."""

BUCKETS = ("read",)


def read(view):
    if not view.chunks:
        return None
    return sum(c["buckets"].get(b, 0.0) for c in view.chunks
               for b in BUCKETS) / len(view.chunks)
