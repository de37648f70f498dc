"""Tuning helpers (the port of the JAX package's ``tuning`` package).

Only the periodicity backends' equivalence check and its synthetic probe
plane are ported so far (:mod:`.autotune`); the measured autotuner that
uses them is ROADMAP.md queue A, A8.
"""
