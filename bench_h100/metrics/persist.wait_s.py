"""Seconds the loop waited on its persist worker, per chunk: the
``persist_backpressure`` buckets and the final ``persist_drain``."""


def read(view):
    if not view.chunks:
        return None
    return sum(view.stage_totals.get(b, 0.0)
               for b in ("persist_backpressure", "persist_drain")) \
        / len(view.chunks)
