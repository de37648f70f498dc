"""B4 (``csrc/score.cu``) launches a unit (a chunk; an epoch of every
beam): the accountant's ``b4_launches`` counter, per unit.  Nothing where
the program counts no launch."""

COUNTER = "b4_launches"


def read(view):
    if not any(COUNTER in c["counters"] for c in view.chunks):
        return None
    return sum(c["counters"].get(COUNTER, 0)
               for c in view.chunks) / len(view.chunks)
