"""Observability: the process-wide counters (:mod:`.metrics`)."""
