"""Seconds an epoch spent bringing its beams to the card, one pageable
copy a beam: the accountant's ``search/dispatch/upload`` bucket, per
epoch.  Nothing where the program has no such bucket."""

BUCKET = "search/dispatch/upload"


def read(view):
    if not any(BUCKET in c["buckets"] for c in view.chunks):
        return None
    return sum(c["buckets"].get(BUCKET, 0.0)
               for c in view.chunks) / len(view.chunks)
