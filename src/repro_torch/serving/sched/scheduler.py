"""SLO-aware continuous-batching scheduler with proactive admission control.

The scheduler owns every admit / evict / preempt / grow decision; the
driver (``launch/serve.py`` ``ContinuousBatcher``) owns the engine state
and the megastep dispatch.  One round = one K-token megastep:

    driver: dispatch megastep -> sync pos/aborts -> absorb sampled tokens
    sched:  advance(K) -> plan_round(positions, pool) -> Plan
    driver: apply Plan (free_sequences / invalidate rows / rebuild-grow /
            admit fresh seq ids) -> end_round(keys_probed)

``plan_round`` runs four phases:

1. **Completion** — lanes whose position reached their stop finish; their
   slots free and their pages are counted as reclaimable this round.
2. **Admission** (policy-ordered, forecaster-gated) — queued requests whose
   predicted page demand over the lookahead horizon fits the predicted
   headroom are admitted into free slots; chunked prefill starts at the
   next megastep via the engine's teacher-forcing path.  With
   ``proactive=False`` admission is greedy (the reactive baseline).
3. **Headroom control** (proactive only) — the hard invariant: exact page
   demand of the occupied lanes over the NEXT megastep (during which the
   host cannot intervene) must fit ``free_cells`` minus the probe
   strategy's slack (``Headroom.slack`` — 0 for linear/robinhood where the
   bound is exact, H for hopscotch; see ``sched/forecast.py``).  If not, preempt
   policy-dominated victims (recompute preemption: pages freed, request
   re-queued with its generated tokens folded into the prompt) and/or
   grow the pool (Section 4.3 rebuild into 2x cells) — BEFORE dispatch, so
   the allocator never ABORTs and the wait-free lookup path never sees a
   mid-flight rebuild.  Every round where this fires and resolves is an
   ``aborts_avoided`` tick.
4. **Accounting** — the forecaster EWMAs observe the round; per-round
   ``RoundStats`` (including the scoped ``PROBE_STATS`` key count the
   driver measures) append to ``rounds``.

All timing is virtual (decode steps), so stats are deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.sched.forecast import (Forecast, OccupancyForecaster,
                                          pages_held, pages_needed)
from repro_torch.serving.sched.policy import Policy, get_policy
from repro_torch.serving.sched.request import DONE, QUEUED, RUNNING, Request


@dataclasses.dataclass
class Plan:
    """One round's decisions, for the driver to apply to the engine state.
    ``evict_slots`` = finished + preempted (free pages, invalidate rows,
    deactivate); ``admissions`` = (slot, request) to seat with a fresh
    sequence id at position 0; ``grow_to`` = proactive pool growth target
    (cells), applied via ``engine.rebuild_page_table`` BEFORE the next
    dispatch."""
    finish_slots: List[int]
    preempt_slots: List[int]
    admissions: List[Tuple[int, Request]]
    grow_to: Optional[int]
    forecast: Optional[Forecast]

    @property
    def evict_slots(self) -> List[int]:
        return sorted(set(self.finish_slots) | set(self.preempt_slots))


@dataclasses.dataclass
class RoundStats:
    round_idx: int
    clock: int
    admitted: int
    completed: int
    preempted: int
    aborts: int
    grew_to: Optional[int]
    queue_len: int
    active_lanes: int
    free_cells: Optional[int]
    demand_pages: Optional[int]
    live_fraction: Optional[float]
    keys_probed: int = 0


@dataclasses.dataclass
class SchedStats:
    submitted: int = 0
    admitted: int = 0            # admission events (re-admissions count)
    completed: int = 0
    preemptive_evictions: int = 0
    aborts: int = 0              # lane-rounds that hit the reactive ABORT
    aborts_avoided: int = 0      # rounds where proactive action prevented one
    pool_grows: int = 0          # proactive grows
    reactive_rebuilds: int = 0   # post-abort rebuilds (the old path)
    deadline_misses: int = 0
    forecast_unresolved: int = 0 # predicted exhaustion nothing could fix


class Scheduler:
    """See module docstring.  ``slots`` = decode lanes (B); ``n_pages`` =
    the (possibly overcommitted) pool size the driver allocated;
    ``max_len`` = engine S_max (stops are clamped to it)."""

    def __init__(self, *, slots: int, page_size: int, max_len: int,
                 n_pages: Optional[int] = None, megastep_k: int = 1,
                 policy="fcfs", proactive: bool = True,
                 horizon_rounds: int = 2, safety_pages: int = 0,
                 allow_grow: bool = True, allow_preempt: bool = True,
                 max_pool_pages: Optional[int] = None,
                 max_prefill_lanes: Optional[int] = None,
                 ewma: float = 0.5):
        self.B = int(slots)
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.n_pages = None if n_pages is None else int(n_pages)
        self.K = max(1, int(megastep_k))
        self.policy: Policy = get_policy(policy)
        self.proactive = bool(proactive)
        self.horizon_rounds = max(1, int(horizon_rounds))
        self.allow_grow = bool(allow_grow)
        self.allow_preempt = bool(allow_preempt)
        self.max_pool_pages = max_pool_pages
        self.max_prefill_lanes = max_prefill_lanes
        self.forecaster = OccupancyForecaster(page_size,
                                              safety_pages=safety_pages,
                                              ewma=ewma)
        self.clock = 0
        self.queue: List[Request] = []
        self.lanes: List[Optional[Request]] = [None] * self.B
        self.finished: List[Request] = []
        self.stats = SchedStats()
        self.rounds: List[RoundStats] = []
        self._pending: Optional[RoundStats] = None
        self._abort_accum = 0
        # span tracing (obs/trace.py): a driver/router installs a Tracer
        # and tag dict (e.g. {"shard": sid}) after construction; every
        # lifecycle transition below then emits its span edge on the
        # virtual clock.  None = zero overhead.
        self.tracer = None
        self.trace_tags: Dict[str, int] = {}

    def _emit(self, event: str, **fields) -> None:
        if self.tracer is not None:
            self.tracer.emit(event, self.clock, **self.trace_tags,
                             **fields)

    # -- intake -----------------------------------------------------------

    def submit(self, req: Request) -> None:
        req.arrival = max(int(req.arrival), self.clock)
        req.state = QUEUED
        self.queue.append(req)
        self.stats.submitted += 1
        self._emit("arrival", req=req.req_id, resubmit=req.preemptions)

    def submit_many(self, reqs: Sequence[Request]) -> None:
        for r in reqs:
            self.submit(r)

    # -- introspection ----------------------------------------------------

    def stop_of(self, req: Request) -> int:
        return min(req.total_len, self.max_len)

    def running(self) -> List[Request]:
        return [r for r in self.lanes if r is not None]

    def arrived_queue(self) -> List[Request]:
        return [r for r in self.queue if r.arrival <= self.clock]

    @property
    def drained(self) -> bool:
        return not self.queue and all(r is None for r in self.lanes)

    # -- lifecycle transitions (idempotent) -------------------------------

    def _finish(self, req: Request) -> bool:
        if req.state != RUNNING:
            return False                      # idempotent double-evict
        if req.slot is not None:
            self.lanes[req.slot] = None
        req.state, req.slot = DONE, None
        req.finished_at = self.clock
        self.finished.append(req)
        self.stats.completed += 1
        if req.missed_deadline:
            self.stats.deadline_misses += 1
        self._emit("finish", req=req.req_id, tokens=len(req.sampled),
                   ttft=req.ttft(), tpot=req.tpot())
        return True

    def _preempt(self, req: Request) -> bool:
        if req.state != RUNNING:
            return False                      # idempotent double-evict
        if req.slot is not None:
            self.lanes[req.slot] = None
        req.state, req.slot = QUEUED, None
        req.preemptions += 1
        self.queue.append(req)
        self.stats.preemptive_evictions += 1
        self._emit("preempt", req=req.req_id)
        return True

    def evict(self, req: Request) -> bool:
        """Forcibly evict a RUNNING request back to the queue (recompute
        preemption).  Calling it again — or on a finished/queued request —
        is a no-op returning False: double-evict is idempotent by
        construction (the driver frees a slot's pages at most once because
        the slot empties on the first call)."""
        return self._preempt(req)

    def _admit(self, req: Request, slot: int) -> None:
        self.queue.remove(req)
        req.state, req.slot = RUNNING, slot
        if req.admitted_at is None:           # queue-wait = FIRST admission
            req.admitted_at = self.clock
        req._prefill_len = int(req.known_tokens().size)  # noqa: SLF001
        self.lanes[slot] = req
        self.stats.admitted += 1
        self._emit("admit", req=req.req_id, slot=slot,
                   prefill=req._prefill_len,  # noqa: SLF001
                   readmit=req.preemptions)

    # -- the round --------------------------------------------------------

    def advance(self, steps: Optional[int] = None) -> None:
        """Advance the virtual clock by one megastep (called by the driver
        right after the dispatch returns)."""
        self.clock += self.K if steps is None else int(steps)

    def note_aborts(self, n_lanes: int, grew_to: Optional[int] = None) -> None:
        """Reactive path: the dispatch surfaced ``n_lanes`` ABORTed lanes
        (the forecaster was off, capped, or wrong) and the driver rebuilt."""
        self.stats.aborts += int(n_lanes)
        self._abort_accum += int(n_lanes)
        self._emit("abort", lanes=int(n_lanes), grew_to=grew_to)
        if grew_to is not None:
            self.stats.reactive_rebuilds += 1
            self.n_pages = int(grew_to)

    def plan_round(self, positions: Sequence[int],
                   pool=None) -> Plan:
        """Decide this round's actions.  ``positions`` int[B] are the
        post-megastep lane positions; ``pool`` is the engine's
        ``page_table.Headroom`` (None for attention-free families —
        admission is then slot-gated only)."""
        pos = np.asarray(positions, np.int64)
        K, ps = self.K, self.page_size
        # probe-strategy headroom: hopscotch reports slack = H because an
        # insert needs a free cell within its neighborhood (see
        # sched/forecast.py module doc); linear/robinhood report 0 and the
        # bound stays exact.  Threaded as data from Headroom, never by name.
        slack = 0 if pool is None else int(getattr(pool, "slack", 0))

        # 1. completions -------------------------------------------------
        finish_slots: List[int] = []
        reclaimed = 0
        for s in range(self.B):
            r = self.lanes[s]
            if r is not None and pos[s] >= self.stop_of(r):
                self._finish(r)
                finish_slots.append(s)
                reclaimed += pages_held(pos[s], ps)
        free_cells = None
        if pool is not None:
            # pool was measured before the driver frees the finished lanes
            free_cells = pool.free_cells + reclaimed

        # planned (pos, stop) of lanes that keep running
        lane_view: Dict[int, Tuple[int, int]] = {
            s: (int(pos[s]), self.stop_of(r))
            for s, r in enumerate(self.lanes) if r is not None}

        # 2. admission (policy-ordered, forecaster-gated) -----------------
        free_slots = [s for s in range(self.B) if self.lanes[s] is None]
        admissions: List[Tuple[int, Request]] = []
        horizon = self.horizon_rounds * K
        margin = None
        if free_cells is not None:
            demand_running = self.forecaster.demand(
                [p for p, _ in lane_view.values()],
                [st for _, st in lane_view.values()], horizon)
            margin = (free_cells - demand_running
                      - self.forecaster.safety_pages - slack)
        prefilling = sum(
            1 for s, r in enumerate(self.lanes) if r is not None
            and pos[s] < getattr(r, "_prefill_len", 0))
        # trend gate: when the EWMA slope + admit-rate extrapolation says
        # the pool exhausts within the lookahead, stop admitting NOW —
        # earlier than the exact-demand margin alone would
        trend_defer = False
        if self.proactive and free_cells is not None:
            tr = self.forecaster.forecast(
                [p for p, _ in lane_view.values()],
                [st for _, st in lane_view.values()], free_cells, horizon,
                strategy_slack=slack)
            trend_defer = tr.est_steps_to_exhaustion < horizon
        for r in self.policy.admit_order(self.arrived_queue()):
            if not free_slots or trend_defer:
                break
            if (self.max_prefill_lanes is not None
                    and prefilling >= self.max_prefill_lanes):
                break
            need = 0
            if free_cells is not None:
                need = pages_needed(0, min(horizon, self.stop_of(r)), ps)
            if self.proactive and margin is not None and need > margin:
                break            # would overrun predicted capacity — wait
            slot = free_slots.pop(0)
            self._admit(r, slot)
            admissions.append((slot, r))
            lane_view[slot] = (0, self.stop_of(r))
            prefilling += 1
            if margin is not None:
                margin -= need

        # 3. proactive headroom control (the hard one-megastep invariant) -
        preempt_slots: List[int] = []
        grow_to: Optional[int] = None
        fc: Optional[Forecast] = None
        if free_cells is not None:
            fc = self.forecaster.forecast(
                [p for p, _ in lane_view.values()],
                [st for _, st in lane_view.values()], free_cells, K,
                strategy_slack=slack)
            if self.proactive and fc.exhausted:
                needed = -fc.margin
                admitted_set = {id(r) for _, r in admissions}
                if self.allow_preempt:
                    cands = self.policy.preempt_candidates(
                        [r for r in self.running()
                         if id(r) not in admitted_set],
                        self.arrived_queue())
                    for v in cands:
                        if needed <= 0:
                            break
                        s = v.slot
                        p, st = lane_view.pop(s)
                        self._preempt(v)
                        preempt_slots.append(s)
                        needed -= (pages_held(p, ps)
                                   + pages_needed(p, min(K, st - p), ps))
                if needed > 0 and self.allow_grow:
                    # double until the deficit is covered; max_pool_pages
                    # bounds the RESULT (the last step clamps to the cap —
                    # partial growth still helps; pick a cap that respects
                    # the mesh's page-shard divisibility)
                    new_pages = self.n_pages or 0
                    gained = 0
                    while needed - gained > 0 and new_pages > 0:
                        nxt = new_pages * 2
                        if self.max_pool_pages is not None:
                            nxt = min(nxt, int(self.max_pool_pages))
                        if nxt <= new_pages:
                            break                        # cap reached
                        new_pages = nxt
                        gained = new_pages - self.n_pages
                    if new_pages > (self.n_pages or 0):
                        grow_to = new_pages
                        needed -= gained
                if needed <= 0:
                    self.stats.aborts_avoided += 1
                    if grow_to is not None:
                        self.stats.pool_grows += 1
                        self.n_pages = grow_to
                else:
                    self.stats.forecast_unresolved += 1

        # 4. accounting ---------------------------------------------------
        live_now = (pool.live_pages - reclaimed) if pool is not None else 0
        self.forecaster.observe(admitted=len(admissions),
                                live_pages=live_now, steps=K)
        self._pending = RoundStats(
            round_idx=len(self.rounds), clock=self.clock,
            admitted=len(admissions), completed=len(finish_slots),
            preempted=len(preempt_slots), aborts=self._abort_accum,
            grew_to=grow_to,
            queue_len=len(self.queue),
            active_lanes=sum(r is not None for r in self.lanes),
            free_cells=free_cells,
            demand_pages=None if fc is None else fc.demand_pages,
            live_fraction=None if pool is None else pool.live_fraction)
        self._abort_accum = 0
        return Plan(finish_slots=finish_slots, preempt_slots=preempt_slots,
                    admissions=admissions, grow_to=grow_to, forecast=fc)

    def end_round(self, keys_probed: int = 0) -> RoundStats:
        """Finalize the round's stats (the driver passes the scoped
        ``PROBE_STATS`` count it measured across dispatch + plan apply)."""
        rs = self._pending
        if rs is None:
            raise RuntimeError("end_round without a plan_round")
        rs.keys_probed = int(keys_probed)
        self.rounds.append(rs)
        self._pending = None
        return rs

    # -- summaries --------------------------------------------------------

    def latency_summary(self) -> Dict[str, float]:
        """Deterministic virtual-clock latency percentiles over finished
        requests (steps): queue-wait (arrival -> first admission), TTFT
        (arrival -> first sampled token) and TPOT (steps per output token
        after the first, preemption stalls included)."""
        return latency_percentiles(self.finished)

    def summary(self) -> Dict[str, float]:
        s = dataclasses.asdict(self.stats)
        s.update(self.latency_summary())
        return s


def latency_percentiles(finished: Sequence[Request]) -> Dict[str, float]:
    """queue_wait / ttft / tpot p50+p99 over finished requests — shared by
    ``Scheduler.latency_summary`` and the router's cross-shard roll-up."""
    out: Dict[str, float] = {}
    series = (("queue_wait", [r.queue_wait() for r in finished]),
              ("ttft", [r.ttft() for r in finished]),
              ("tpot", [r.tpot() for r in finished]))
    for name, xs in series:
        xs = [x for x in xs if x is not None]
        if xs:
            out[f"{name}_p50"] = float(np.percentile(xs, 50))
            out[f"{name}_p99"] = float(np.percentile(xs, 99))
        else:
            out[f"{name}_p50"] = out[f"{name}_p99"] = float("nan")
    return out
