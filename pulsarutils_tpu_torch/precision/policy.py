"""Named accumulation-precision strategies and the exactness-domain rule.

The port of the JAX package's ``precision/policy.py``, on tensors: the
one owner of every dtype and accumulation decision of the port's
policy-aware reductions (the gather and roll direct-sweep formulations
of :mod:`..ops.dedisperse` and the harmonic stack of
:mod:`..ops.periodicity` and its kernel).

Strategies
----------
``f32``
    Plain float32 operands and float32 accumulation: the default.
    ``policy=None`` and ``policy="f32"`` run the same code.
``f32_compensated``
    Neumaier (improved Kahan) compensated summation: a two-float
    (sum, compensation) carry threaded through the reductions.  Error
    is O(eps) independent of n.
``split_f32``
    Two-float pairwise summation: a tree whose nodes combine with Knuth
    TwoSum and carry the rounding error in a second float, for
    reductions longer than 2^24 terms.  Error is O(eps) with an
    O(n eps^2) tail.
``bf16_operand_f32_accum``
    Operands rounded to bfloat16 (half the bytes on bandwidth-bound
    sweeps), accumulated in float32.  Error is dominated by the bf16
    half-ulp (2^-8) per operand.

``"auto"`` is accepted by :func:`policy_name`: the gather and roll
sweeps then measure the strategies at their geometry
(:func:`~..tuning.autotune.resolve_search_policy`); every other
reduction takes the static ``f32`` pairing (:func:`static_policy`, and
:func:`strategy`, the one rule the port's policy-aware reductions
read).

:data:`COUNTS` keeps what the JAX package reports through its metrics
registry: policy resolutions, engagements of a non-plain accumulator and
exactness ladders that ran out of integer types, by ``(name, policy)``.
"""

from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "COUNTS",
    "EPS_BF16",
    "EPS_F32",
    "F32_EXACT_INT_BOUND",
    "STRATEGIES",
    "ExactnessDomain",
    "Strategy",
    "cast_operand",
    "engage",
    "exactness_domain",
    "neumaier_sum",
    "policy_name",
    "resolve_policy",
    "split_sum",
    "static_policy",
    "strategy",
]

#: machine epsilons (the unit roundoff is eps / 2 under round-to-nearest);
#: bfloat16 has an 8-bit significand, hidden bit included
EPS_F32 = float(np.finfo(np.float32).eps)  # 2^-23
EPS_BF16 = 2.0 ** -7

#: the largest contiguous integer range float32 represents exactly
F32_EXACT_INT_BOUND = 1 << 24

_ENV_POLICY = "PUTPU_PRECISION"

#: events counted so far, by ``(name, policy)`` (``policy`` None where the
#: event has none)
COUNTS = Counter()


def _count(name, policy=None):
    COUNTS[(name, policy)] += 1


class ExactnessDomain(NamedTuple):
    """Where a reduction stays exact, for a given geometry.

    ``accum_dtype``
        Narrowest exact integer accumulator for summing ``nchan``
        ``nbits``-bit channel codes (None when no integer type of the
        ladder holds the peak: callers fall back to float32).
    ``code_peak``
        Worst-case integer channel sum, ``((1 << nbits) - 1) * nchan``
        (0 when ``nbits`` is not given).
    ``peak_index_exact``
        True while float32 represents every sample index in
        ``[0, nsamples)`` exactly, i.e. ``nsamples <= 2^24``.
    ``index_error_samples``
        Worst-case peak-index slip in samples once exactness is lost
        (0.0 while ``peak_index_exact``).
    """

    accum_dtype: Optional[str]
    code_peak: int
    peak_index_exact: bool
    index_error_samples: float


def exactness_domain(nchan: int, nsamples: int = 0,
                     nbits: Optional[int] = None) -> ExactnessDomain:
    """The exactness rule of an integer channel sum and a float32 peak
    index (the JAX package's one owner of both 2^24 bounds)."""
    acc = None
    peak = 0
    if nbits is not None:
        peak = ((1 << int(nbits)) - 1) * int(nchan)
        if peak < (1 << 15):
            acc = "int16"
        elif peak < F32_EXACT_INT_BOUND:
            acc = "int32"
        else:
            _count("putpu_precision_overflow_averted_total")
    exact = int(nsamples) <= F32_EXACT_INT_BOUND
    err = 0.0 if exact else float(nsamples) / F32_EXACT_INT_BOUND
    return ExactnessDomain(acc, peak, exact, err)


@dataclass(frozen=True)
class Strategy:
    """One named accumulation strategy.

    ``error_bound(n)`` is the documented worst-case error of summing
    ``n`` terms relative to ``sum(|x_i|)``.  ``score_rtol`` is the
    tolerance granted to the strategy's float score columns against the
    ``f32`` run's (discrete fields must match exactly).
    """

    name: str
    operand_dtype: str  # "float32" | "bfloat16"
    accumulator: str  # "plain" | "compensated" | "split"
    score_rtol: float
    summary: str

    def error_bound(self, n: int) -> float:
        """Worst-case ``|sum_strategy - sum_exact| / sum(|x_i|)``."""
        n = max(int(n), 1)
        if self.name == "f32":
            return (n - 1) * EPS_F32
        if self.name == "f32_compensated":
            # Neumaier: 2 eps + O(n^2 eps^2) (Higham, ASNA thm 4.3)
            return 2.0 * EPS_F32 + (n ** 2) * EPS_F32 ** 2
        if self.name == "split_f32":
            # the hi + lo pair is exact at every node; only the final
            # renormalisation and the lo sum round
            return 2.0 * EPS_F32 + n * EPS_F32 ** 2
        if self.name == "bf16_operand_f32_accum":
            return 0.5 * EPS_BF16 + (n - 1) * EPS_F32
        raise ValueError(f"unknown strategy {self.name!r}")


STRATEGIES = {
    s.name: s
    for s in (
        Strategy(
            name="f32",
            operand_dtype="float32",
            accumulator="plain",
            score_rtol=1e-4,
            summary="plain float32 operands + accumulation (default)",
        ),
        Strategy(
            name="f32_compensated",
            operand_dtype="float32",
            accumulator="compensated",
            score_rtol=1e-4,
            summary="Neumaier compensated carry through scan/gather sums",
        ),
        Strategy(
            name="split_f32",
            operand_dtype="float32",
            accumulator="split",
            score_rtol=1e-4,
            summary="two-float pairwise tree for >2^24-sample regimes",
        ),
        Strategy(
            name="bf16_operand_f32_accum",
            operand_dtype="bfloat16",
            accumulator="plain",
            score_rtol=5e-2,
            summary="bfloat16 operands, float32 accumulation (bandwidth)",
        ),
    )
}


def policy_name(policy: Optional[str]) -> str:
    """Canonicalise ``policy``: None means the default ``f32``; an unknown
    name raises ``ValueError``."""
    name = policy or "f32"
    if name != "auto" and name not in STRATEGIES:
        raise ValueError(
            f"unknown precision policy {policy!r}; expected one of "
            f"{sorted(STRATEGIES)} or 'auto'"
        )
    return name


def static_policy(policy: Optional[str]) -> str:
    """:func:`policy_name`, with ``"auto"`` taken as the static ``f32``
    pairing (the JAX package's choice with its autotuner off, and the
    pairing of every reduction the tuner does not measure)."""
    name = policy_name(policy)
    return "f32" if name == "auto" else name


def strategy(policy: Optional[str]) -> Optional[Strategy]:
    """The :class:`Strategy` a reduction runs under ``policy``, None for
    plain float32 (``None``, ``"f32"`` and ``"auto"``, the static ``f32``
    pairing); an unknown name raises ``ValueError``."""
    name = static_policy(policy)
    return None if name == "f32" else STRATEGIES[name]


def resolve_policy(policy: Optional[str] = None) -> str:
    """The effective policy name: ``policy`` if given, else the
    ``PUTPU_PRECISION`` environment variable, else ``f32``.  May return
    ``"auto"``."""
    name = policy_name(policy if policy else os.environ.get(_ENV_POLICY))
    _count("putpu_precision_policy_resolutions_total", name)
    return name


def engage(policy: Optional[str]) -> str:
    """Count a reduction that engaged a non-plain accumulator; returns the
    canonical name."""
    name = policy_name(policy)
    if name != "auto" and STRATEGIES[name].accumulator != "plain":
        _count("putpu_precision_compensated_engagements_total", name)
    return name


def cast_operand(data, policy):
    """``data`` in the strategy's operand type: a bfloat16 copy under
    ``bf16_operand_f32_accum``, ``data`` itself otherwise."""
    strat = STRATEGIES[policy_name(policy)]
    if strat.operand_dtype == "float32":
        return data
    return data.to(torch.bfloat16)


def _two_sum(a, b):
    """Knuth TwoSum: ``s = fl(a + b)`` and its exact rounding error."""
    s = a + b
    bp = s - a
    err = (a - (s - bp)) + (b - bp)
    return s, err


def neumaier_sum(x, dim=-1):
    """Compensated (Neumaier) sum of ``x`` along ``dim``: sequential over
    that axis with a (sum, compensation) carry, elementwise over the
    others, ``acc + comp`` at the end."""
    x = torch.movedim(torch.as_tensor(x), dim, 0)
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    acc = x[0].clone()
    comp = torch.zeros_like(acc)
    for v in x[1:]:
        acc, err = _two_sum(acc, v)
        comp = comp + err
    return acc + comp


def split_sum(x, dim=-1):
    """Two-float pairwise sum of ``x`` along ``dim``: each tree level adds
    neighbouring pairs with TwoSum and their "lo" errors beside them, an
    odd last term carried up unpaired; ``hi + lo`` at the root."""
    x = torch.movedim(torch.as_tensor(x), dim, 0)
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    hi = x
    lo = torch.zeros_like(x)
    while hi.shape[0] > 1:
        n = hi.shape[0]
        even = (n // 2) * 2
        s, err = _two_sum(hi[0:even:2], hi[1:even:2])
        low = lo[0:even:2] + lo[1:even:2] + err
        if n % 2:
            s = torch.cat([s, hi[n - 1:n]])
            low = torch.cat([low, lo[n - 1:n]])
        hi, lo = s, low
    return hi[0] + lo[0]
