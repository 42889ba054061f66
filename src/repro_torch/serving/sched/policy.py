"""Pluggable scheduling policies: admission order + preemption victims.

A policy answers two questions the scheduler asks every round:

* ``admit_order(queue)`` — in what order should arrived-but-queued requests
  be considered for free decode slots?
* ``preempt_candidates(running, queue)`` — which RUNNING requests may the
  headroom controller evict (recompute-preempt) when the occupancy
  forecaster predicts pool exhaustion?  Returned best-victim-first; an
  empty list means "never preempt for this policy — grow the pool instead".

The preemption rule is deliberately conservative: a victim must be
*dominated* by something still waiting (lower priority than a queued
request / later deadline than a queued deadline), so FCFS — where nothing
dominates anything — never preempts and relies purely on proactive growth.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.serving.sched.request import Request

_INF = float("inf")


def _deadline(r: Request) -> float:
    return _INF if r.deadline is None else float(r.deadline)


class Policy:
    """FCFS: arrival order, no preemption."""
    name = "fcfs"

    def admit_order(self, queue: Sequence[Request]) -> List[Request]:
        return sorted(queue, key=lambda r: (r.arrival, r.req_id))

    def preempt_candidates(self, running: Sequence[Request],
                           queue: Sequence[Request]) -> List[Request]:
        return []


class PriorityPolicy(Policy):
    """Strict priority (ties FCFS).  Victims: running requests whose
    priority is strictly below the best queued priority — lowest priority
    first, most recently admitted first (least sunk work recomputed)."""
    name = "priority"

    def admit_order(self, queue):
        return sorted(queue, key=lambda r: (-r.priority, r.arrival,
                                            r.req_id))

    def preempt_candidates(self, running, queue):
        if not queue:
            return []
        best_q = max(r.priority for r in queue)
        victims = [r for r in running if r.priority < best_q]
        return sorted(victims, key=lambda r: (r.priority,
                                              -(r.admitted_at or 0),
                                              -r.req_id))


class DeadlinePolicy(Policy):
    """SLO-aware EDF: earliest deadline first (requests without a
    ``max_latency`` sort last, then FCFS).  Victims: running requests whose
    deadline is strictly later than the most urgent queued deadline —
    slackest first (no-SLO lanes are the first to yield)."""
    name = "deadline"

    def admit_order(self, queue):
        return sorted(queue, key=lambda r: (_deadline(r), r.arrival,
                                            r.req_id))

    def preempt_candidates(self, running, queue):
        with_slo = [r for r in queue if r.deadline is not None]
        if not with_slo:
            return []
        urgent = min(_deadline(r) for r in with_slo)
        victims = [r for r in running if _deadline(r) > urgent]
        return sorted(victims, key=lambda r: (-_deadline(r),
                                              -(r.admitted_at or 0),
                                              -r.req_id))


POLICIES = {p.name: p for p in (Policy(), PriorityPolicy(),
                                DeadlinePolicy())}


def get_policy(name) -> Policy:
    if isinstance(name, Policy):
        return name
    try:
        return POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown policy {name!r} "
                         f"(have: {sorted(POLICIES)})") from None
