"""Seconds a chunk waited for its read and its upload: the accountant's
``read`` and ``upload_wait`` buckets, per chunk."""

BUCKETS = ("read", "upload_wait")


def read(view):
    if not view.chunks:
        return None
    return sum(c["buckets"].get(b, 0.0) for c in view.chunks
               for b in BUCKETS) / len(view.chunks)
