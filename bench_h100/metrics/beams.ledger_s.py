"""Seconds an epoch spent marking its beams' chunks done in their resume
ledgers: the accountant's ``persist/ledger`` bucket, per epoch.  Nothing
where the program has no such bucket."""

BUCKET = "persist/ledger"


def read(view):
    if not any(BUCKET in c["buckets"] for c in view.chunks):
        return None
    return sum(c["buckets"].get(BUCKET, 0.0)
               for c in view.chunks) / len(view.chunks)
