"""Seconds an epoch spent on its hit beams' host path (decode, clean,
``PulseInfo``, statistics) on the main thread: the accountant's
``hit_products`` bucket, per epoch, epochs with no hit included.
Nothing where the program has no such bucket."""

BUCKET = "hit_products"


def read(view):
    if not any(BUCKET in c["buckets"] for c in view.chunks):
        return None
    return sum(c["buckets"].get(BUCKET, 0.0)
               for c in view.chunks) / len(view.chunks)
