"""Raghavan (1988) upper bound on the p-value of a weighted Bernoulli sum.

Same math as ``hypothesis_test_module.py:248-327``: weights
w_i = log10(p_i) / log10(p_max) normalized so the largest-probability read
has weight 1, m = sum w_i p_i, y = sum of weights of supporting reads,
d = y/m - 1, bound = e^k / (1+d)^(k + k/d) with k = m*d.

The reference evaluates the bound with decimal prec 100 and then converts
to float64 (``:327`` returns ``float(raghavan_bound)``), so float64
*log-space* evaluation is decision-equivalent: the exponent simplifies to

    ln(bound) = k - (k + k/d) ln(1+d) = m (d - (1+d) ln1p(d))

which float64 computes to ~1e-14 relative accuracy for |d| >= 1e-8, and
the final 10**x underflows to 0.0 exactly where float(Decimal(...)) does.
Decimal remains as a fallback for (a) the cancellation zone |d| < 1e-8 and
(b) results landing within 10x of the caller's decision threshold, where
the last bits could flip an accept/reject decision.
"""
from __future__ import annotations

import math
from decimal import Decimal, getcontext
from typing import Dict, Iterable, Optional

getcontext().prec = 100

# fall back to Decimal when |d| is below this (catastrophic cancellation
# in d - (1+d)ln1p(d)) or when the fast result is within this many decades
# of the decision threshold
_D_EPS = 1e-8
_THRESHOLD_DECADES = 1.0


def _decimal_bound(m: float, y: float) -> float:
    md = Decimal(m)
    yd = Decimal(y)
    d = yd / md - 1
    k = md * d
    if d == 0:
        return 0.5
    bound = k.exp() / (d + 1) ** (k + k / d)
    return float(bound)


def raghavan_upper_pvalue_bound(
    probability: Dict[str, float],
    x_equal_to_one: Iterable[str],
    threshold: Optional[float] = None,
    factor: float = 1.0,
) -> float:
    """Upper bound on P(Y >= y).

    threshold/factor: when given, the caller compares ``bound * factor``
    against ``threshold``; results within 10x of it re-evaluate in Decimal
    so accept/reject decisions match the reference bit-for-bit.
    """
    assert max(probability.values()) <= 1.0
    assert min(probability.values()) > 0.0
    log_probabilities = {
        acc: -math.log10(p_i) for acc, p_i in probability.items()
    }
    log_p_i_max = max(log_probabilities.values())
    assert log_p_i_max > 0
    weight = {acc: lp / log_p_i_max for acc, lp in log_probabilities.items()}

    m = sum(weight[acc] * probability[acc] for acc in probability)
    y = sum(weight[x] for x in x_equal_to_one)
    if y == 0:
        return 1.0
    if y == m:
        return 0.5
    d = y / m - 1
    if abs(d) < _D_EPS or d <= -1.0:
        # cancellation zone (or degenerate rounding d <= -1): exact path
        return _decimal_bound(m, y)

    # fast path: float64 log-space
    log10_bound = m * (d - (1.0 + d) * math.log1p(d)) / math.log(10.0)
    if log10_bound < -320.0:
        p_fast = 0.0
    elif log10_bound > 308.0:
        p_fast = math.inf
    else:
        p_fast = 10.0 ** log10_bound

    if threshold is not None and p_fast > 0.0 and math.isfinite(p_fast):
        try:
            corrected = p_fast * factor
        except OverflowError:  # pragma: no cover
            corrected = math.inf
        if math.isfinite(corrected) and corrected > 0.0:
            gap = abs(math.log10(corrected) - math.log10(threshold))
            if gap < _THRESHOLD_DECADES:
                return _decimal_bound(m, y)
    return p_fast


def correction_factor(t_seq_len: int, delta_t: Dict[int, tuple]) -> float:
    """Bonferroni-style multiplicity factor (``hypothesis_test_module.py:
    329-341``): (4(m+1))^nI * C(m, nD) * C(3(m-nD), nS)."""
    m = t_seq_len
    n_S = sum(1 for s, _c, _u in delta_t.values() if s == "S")
    n_D = sum(1 for s, _c, _u in delta_t.values() if s == "D")
    n_I = sum(1 for s, _c, _u in delta_t.values() if s == "I")
    return (
        (4 * (m + 1)) ** n_I
        * math.comb(m, n_D)
        * math.comb(3 * (m - n_D), n_S)
    )
