"""Precision policies: named accumulation strategies and exactness rules
(:mod:`.policy`)."""

from .policy import (  # noqa: F401
    COUNTS,
    EPS_BF16,
    EPS_F32,
    F32_EXACT_INT_BOUND,
    STRATEGIES,
    ExactnessDomain,
    Strategy,
    cast_operand,
    engage,
    exactness_domain,
    neumaier_sum,
    policy_name,
    resolve_policy,
    split_sum,
    static_policy,
    strategy,
)

__all__ = [
    "COUNTS", "EPS_BF16", "EPS_F32", "F32_EXACT_INT_BOUND", "STRATEGIES",
    "ExactnessDomain", "Strategy", "cast_operand", "engage",
    "exactness_domain", "neumaier_sum", "policy_name", "resolve_policy",
    "split_sum", "static_policy", "strategy",
]
