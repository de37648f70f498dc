"""Seconds an epoch's beam batch held the card's stream: the accountant's
``device_s["search"]`` (the CUDA events of the ``search`` bucket), per
epoch that has it.  Nothing where the program times no stage on the
card."""

STAGE = "search"


def read(view):
    vals = [c["device_s"][STAGE] for c in view.chunks
            if STAGE in c.get("device_s", {})]
    return sum(vals) / len(vals) if vals else None
