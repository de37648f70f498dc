"""Seconds an epoch spent in the beam batch (upload, unpack, conditioning,
sweep, scores, one readback): the accountant's ``search`` bucket, per
epoch."""

BUCKETS = ("search",)


def read(view):
    if not view.chunks:
        return None
    return sum(c["buckets"].get(b, 0.0) for c in view.chunks
               for b in BUCKETS) / len(view.chunks)
