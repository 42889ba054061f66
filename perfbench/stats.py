"""Percentiles and spreads, the one definition every metric and every
bound uses, and the rounds a host time is read from."""
from __future__ import annotations

import math
import statistics
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile: the smallest value with at least ``q``
    percent of the values at or below it.  None for no values."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / abs(med)


def unsampled(rounds) -> list:
    """The rounds outside the traced run's samples: those that ran as a
    timed run's do (all rounds of a timed run)."""
    return [r for r in rounds if not r.get("sampled")]
