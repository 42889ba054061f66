"""Deterministic synthetic workloads for the scheduler (bench / CI soak /
tests).  Everything is seeded and expressed in virtual-clock steps, so the
resulting scheduler statistics (aborts, preemptions, grows, completions)
are machine-independent and can be GATED in ``benchmarks/check_regression``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.sched.request import Request


def synthetic_workload(n: int, *, vocab_size: int, max_len: int,
                       seed: int = 0,
                       prompt_len=(2, 6),
                       max_new=(8, 24),
                       priorities: Sequence[int] = (0,),
                       slo_fraction: float = 0.0,
                       slo_budget=(24, 64),
                       arrival_every: int = 0) -> List[Request]:
    """``n`` requests with seeded random prompts.

    ``prompt_len`` / ``max_new`` / ``slo_budget`` are inclusive (lo, hi)
    ranges; ``priorities`` is cycled deterministically; ``slo_fraction`` of
    requests carry a ``max_latency`` SLO; ``arrival_every`` staggers
    arrivals by that many steps per request (0 = an admission storm: all
    arrive at step 0).  Total length is clamped to ``max_len``."""
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    for i in range(n):
        lp = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        lp = min(lp, max_len - 1)
        new = int(rng.integers(max_new[0], max_new[1] + 1))
        new = max(1, min(new, max_len - lp))
        slo: Optional[int] = None
        if rng.random() < slo_fraction:
            slo = int(rng.integers(slo_budget[0], slo_budget[1] + 1))
        reqs.append(Request(
            req_id=i,
            prompt=rng.integers(0, vocab_size, size=lp).astype(np.int32),
            max_new_tokens=new,
            priority=int(priorities[i % len(priorities)]),
            max_latency=slo,
            arrival=i * int(arrival_every)))
    return reqs


def churn_request(req_id: int, rng: np.random.Generator, *,
                  vocab_size: int, max_len: int) -> Request:
    """One request of the classic eviction-churn stream the pre-scheduler
    batcher ran: a 1-token prompt with a stop uniform in
    [max_len // 3, max_len - 1].  The single source of truth — both
    ``churn_workload`` and the driver's endless auto-refill draw from it,
    so the distributions can never drift apart."""
    lo, hi = max_len // 3, max_len - 1
    return Request(req_id=req_id,
                   prompt=rng.integers(0, vocab_size, size=1).astype(
                       np.int32),
                   max_new_tokens=int(rng.integers(lo, hi)) - 1)


def churn_workload(n: int, *, vocab_size: int, max_len: int,
                   seed: int = 0) -> List[Request]:
    """``n`` churn requests (see ``churn_request``), all arriving
    immediately."""
    rng = np.random.default_rng(seed)
    return [churn_request(i, rng, vocab_size=vocab_size, max_len=max_len)
            for i in range(n)]
