"""Prefix router: the per-shard restatement of the admission proof
(PyTorch port of ``serving/sched/router.py``; a copy but for imports).

``PrefixRouter`` fronts one ``Scheduler`` PER SHARD of a
``ShardedPageTable``.  Because sequences are pinned to their owner shard by
the hash prefix (``serving/sharded_table``), each scheduler sees exactly
the lanes whose pages land on its shard and gates admission with *that
shard's* ``Headroom`` — so the existing proactive invariant

    demand + safety + strategy_slack <= free_cells

holds per shard with the SAME forecaster, policies and preemption machinery
as the single-table scheduler; nothing in ``sched/scheduler.py`` changes.
The router adds exactly two things:

* **Placement** — a request gets its sequence id at submission (a plain
  counter); the id's hash prefix names the owner shard, and the request
  joins that shard's queue.  The seq id stays with the request for life —
  across preemptions and across host loss (the prefix RANGE moves to a
  survivor, so the same id routes to the new owner).

* **Elastic re-admission** (``lose_host``) — when a host group dies, its
  scheduler's running lanes and queue are re-homed: pages died with the
  host (nothing to free), so each running victim takes the scheduler's
  recompute-preemption transition (QUEUED, slot=None, ``known_tokens``
  carries its progress) and resubmits to the surviving owner named by the
  reassigned manifest.  Zero requests are lost by construction; the
  per-shard proof then guarantees the survivors re-admit them without
  ABORTs.

Pool growth is applied by the router, not the driver: a shard's ``grow_to``
triggers the LAZY resize (``grow_shard`` — O(1), headroom jumps
immediately, buckets migrate under traffic), so the proactive controller
no longer costs a stop-the-world rebuild.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.sched.request import QUEUED, RUNNING, Request
from repro_torch.serving.sched.scheduler import (Plan, Scheduler,
                                           latency_percentiles)
from repro_torch.serving.sharded_table import ShardedPageTable


class PrefixRouter:
    """One scheduler per live shard; see module docstring."""

    def __init__(self, spt: ShardedPageTable, *, slots_per_shard: int,
                 max_len: int, megastep_k: int = 1, policy="fcfs",
                 proactive: bool = True, safety_pages: int = 0,
                 horizon_rounds: int = 2, allow_grow: bool = True,
                 max_pool_pages: Optional[int] = None, seq_base: int = 1):
        self.spt = spt
        self.slots_per_shard = int(slots_per_shard)
        self._sched_kw = dict(
            slots=slots_per_shard, page_size=spt.page_size, max_len=max_len,
            megastep_k=megastep_k, policy=policy, proactive=proactive,
            safety_pages=safety_pages, horizon_rounds=horizon_rounds,
            allow_grow=allow_grow, allow_preempt=True,
            max_pool_pages=max_pool_pages)
        self.scheds: Dict[int, Scheduler] = {}
        for sid in spt.live_shards():
            self.scheds[sid] = Scheduler(
                n_pages=spt.headroom(sid).n_pages, **self._sched_kw)
        self._next_seq = int(seq_base)
        self.seq_of: Dict[int, int] = {}      # req_id -> sequence id
        self.unique_submitted = 0             # per-shard counters double-
        self.rehomed = 0                      # count re-homes; these don't
        self.tracer = None                    # obs/trace.py span stream

    def set_tracer(self, tracer) -> None:
        """Install one Tracer across the router and every per-shard
        scheduler; each scheduler's spans carry its shard id as a tag."""
        self.tracer = tracer
        for sid, sc in self.scheds.items():
            sc.tracer = tracer
            sc.trace_tags = {"shard": sid}

    def _clock(self) -> int:
        return next(iter(self.scheds.values())).clock if self.scheds else 0

    # -- placement --------------------------------------------------------

    def owner_of(self, req: Request) -> int:
        seq = self.seq_of[req.req_id]
        return int(self.spt.owner_of_seq(np.asarray([seq], np.uint32))[0])

    def submit(self, req: Request) -> int:
        """Assign the request its (lifetime) sequence id, route it to the
        owner shard's scheduler.  Returns the owner shard id."""
        if req.req_id not in self.seq_of:
            self.seq_of[req.req_id] = self._next_seq
            self._next_seq += 1
            self.unique_submitted += 1
        owner = self.owner_of(req)
        self.scheds[owner].submit(req)
        return owner

    def submit_many(self, reqs: Sequence[Request]) -> None:
        for r in reqs:
            self.submit(r)

    # -- the round ---------------------------------------------------------

    def advance(self, steps: Optional[int] = None) -> None:
        for sc in self.scheds.values():
            sc.advance(steps)

    def plan_round(self, positions: Dict[int, Sequence[int]]
                   ) -> Dict[int, Plan]:
        """Per-shard planning against per-shard headroom.  ``positions``
        maps shard id -> post-megastep lane positions of that shard's
        scheduler.  A shard's ``grow_to`` is applied HERE as a lazy
        resize — by the time the plan reaches the driver the shard's
        headroom already covers it."""
        plans: Dict[int, Plan] = {}
        for sid, sc in self.scheds.items():
            old_pages = self.spt.headroom(sid).n_pages
            plan = sc.plan_round(positions[sid], self.spt.headroom(sid))
            if plan.grow_to is not None:
                self.spt.grow_shard(sid, plan.grow_to)
                if self.tracer is not None:
                    # the frozen-old-table window OPENS here; it closes at
                    # the migrate_done event the driver emits
                    self.tracer.emit("grow", sc.clock, shard=sid,
                                     n_pages_old=old_pages,
                                     n_pages_new=plan.grow_to)
            plans[sid] = plan
        return plans

    def end_round(self, keys_probed: int = 0) -> None:
        # attribute the driver-scoped probe count to the first shard (the
        # per-shard split isn't measured; totals still add up)
        for i, sc in enumerate(self.scheds.values()):
            sc.end_round(keys_probed if i == 0 else 0)

    # -- elasticity --------------------------------------------------------

    def lose_host(self, sid: int) -> List[Request]:
        """Host-group loss: reassign the shard's prefix ranges
        (``spt.lose_shard``) and re-home every request it held.  Running
        victims take the recompute-preemption transition — their pages died
        with the host, so there is nothing to free; ``known_tokens`` (the
        prompt + every token sampled so far) replays through chunked
        prefill on the new owner.  Returns the re-homed requests."""
        dead = self.scheds.pop(sid)
        self.spt.lose_shard(sid)
        victims = list(dead.running()) + list(dead.queue)
        if self.tracer is not None:
            self.tracer.emit("lose_host", dead.clock, shard=sid,
                             victims=[r.req_id for r in victims])
        for r in dead.running():
            r.state, r.slot = QUEUED, None
            r.preemptions += 1
        for r in victims:
            owner = self.owner_of(r)      # re-routes via the new manifest
            assert owner != sid
            self.scheds[owner].submit(r)
        self.rehomed += len(victims)
        return victims

    # -- aggregation -------------------------------------------------------

    @property
    def drained(self) -> bool:
        return all(sc.drained for sc in self.scheds.values())

    def finished(self) -> List[Request]:
        out: List[Request] = []
        for sc in self.scheds.values():
            out.extend(sc.finished)
        return out

    def summary(self) -> Dict[str, float]:
        """Cross-shard roll-up.  ``submitted`` counts unique requests (a
        re-home resubmits to another shard's counter; don't double-count);
        latency percentiles pool all finished requests."""
        total: Dict[str, float] = {}
        for sc in self.scheds.values():
            for k, v in dataclasses.asdict(sc.stats).items():
                total[k] = total.get(k, 0) + v
        total["submitted"] = self.unique_submitted
        total["rehomed"] = self.rehomed
        total.update(latency_percentiles(self.finished()))
        return total
