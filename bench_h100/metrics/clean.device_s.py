"""Seconds a chunk's clean (the unpack and conditioning) held the card's
stream: the accountant's ``device_s["clean"]`` (the CUDA events of the
``clean`` bucket), per chunk that has it.  Nothing where the program
times no stage on the card."""

STAGE = "clean"


def read(view):
    vals = [c["device_s"][STAGE] for c in view.chunks
            if STAGE in c.get("device_s", {})]
    return sum(vals) / len(vals) if vals else None
