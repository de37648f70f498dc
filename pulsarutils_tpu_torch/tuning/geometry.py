"""Geometry keys + the shared plan-cache policy.

A copy of the JAX package's ``tuning/geometry.py``:

* :data:`PLAN_CACHE_SIZE` — the documented size every geometry-keyed
  plan/program cache uses;
* :func:`geometry_key` — the canonical ``(backend, nchan, nsamples,
  ndm, dtype, mesh)`` key string shared by the tune cache
  (:mod:`.cache`), the per-key decision tables and the memory model's
  calibration (:mod:`..resilience.memory_budget`);
* :func:`counted_plan_cache` — ``functools.lru_cache`` with
  hit/miss counters (``putpu_plan_cache_hits_total`` /
  ``putpu_plan_cache_misses_total``, labelled by cache name).

The port's backend spelling is what ``jax.default_backend()`` says on
the same hardware: ``"gpu"`` on the card (:func:`device_backend`),
``"cpu"`` on the host.  So for the same arguments the two packages'
keys are equal, character for character.
"""

from __future__ import annotations

import functools

#: one documented size for every geometry-keyed plan/program lru cache
PLAN_CACHE_SIZE = 16


def device_backend(device):
    """The key's backend spelling of a ``torch.device`` (or its name):
    ``"gpu"`` for a CUDA device, ``"cpu"`` for the host."""
    kind = getattr(device, "type", None) or str(device).split(":")[0]
    return "gpu" if kind == "cuda" else "cpu"


def dtype_name(dtype):
    """Canonical dtype spelling for keys (``None`` -> ``float32``, the
    device default everywhere in this codebase)."""
    if dtype is None:
        return "float32"
    name = getattr(dtype, "__name__", None) or getattr(dtype, "name", None)
    if name is None and str(dtype).startswith("torch."):
        name = str(dtype)[len("torch."):]
    return str(name if name is not None else dtype)


def mesh_tag(mesh_shape):
    """``(dm, chan)``-style mesh shape -> ``"2x4"``; ``None`` -> ``"-"``
    (single device)."""
    if not mesh_shape:
        return "-"
    return "x".join(str(int(s)) for s in mesh_shape)


def geometry_key(backend, nchan, nsamples, ndm, dtype=None, mesh_shape=None,
                 batch=1):
    """Canonical tune/decision key for one search geometry.

    The axes are the ones the fastest variant depends on — platform,
    channel count, series length, trial count, dtype — plus the mesh
    shape of the sharded paths and the beam-batch width (``batch=1``
    leaves the key without a batch suffix).  Stable across processes
    (plain string), so it keys the persistent tune cache.
    """
    key = (f"{backend}|c{int(nchan)}|t{int(nsamples)}|d{int(ndm)}"
           f"|{dtype_name(dtype)}|m{mesh_tag(mesh_shape)}")
    if int(batch) > 1:
        key += f"|b{int(batch)}"
    return key


def counted_plan_cache(name, maxsize=PLAN_CACHE_SIZE):
    """``functools.lru_cache`` whose hits/misses are registry counters.

    ``putpu_plan_cache_hits_total{cache=<name>}`` /
    ``putpu_plan_cache_misses_total{cache=<name>}`` tick per call, so a
    workload cycling more geometries than :data:`PLAN_CACHE_SIZE`
    (tuner probes included) shows up as a miss rate.  The attribution
    reads ``cache_info()`` around the call (a concurrent caller could at
    worst misattribute one hit as a miss — counters, not invariants).
    """

    def deco(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            from ..obs import metrics as _metrics

            before = cached.cache_info().hits
            out = cached(*args, **kwargs)
            if cached.cache_info().hits > before:
                _metrics.counter("putpu_plan_cache_hits_total",
                                 cache=name).inc()
            else:
                _metrics.counter("putpu_plan_cache_misses_total",
                                 cache=name).inc()
            return out

        wrapper.cache_info = cached.cache_info
        wrapper.cache_clear = cached.cache_clear
        return wrapper

    return deco
