"""Occupancy forecaster: predict page-pool exhaustion BEFORE it happens.

The paper's amortized O(1) expected probe/step bound holds while the load
factor stays bounded; the allocator's ABORT (every cell live) is exactly
the regime where the guarantee — and the wait-free read path — degrades
into a Section 4.3 rebuild.  The forecaster keeps the table out of that
regime by construction:

* **Exact short-horizon demand.**  Page consumption at decode is fully
  determined by the lane positions: a lane at position ``p`` crosses a
  page boundary at every multiple of ``page_size`` in ``[p, p+steps)``.
  ``pages_needed`` counts those crossings exactly, so over one megastep
  (K steps, during which the host cannot intervene) "demand <= free_cells"
  is a *proof* of no-ABORT, not a heuristic — the controller enforces it
  before every dispatch (``Forecast.exhausted``).
* **Trend terms.**  EWMAs of the admit rate (requests/step) and the pool
  growth slope (net live pages/step, eviction churn included) extrapolate
  beyond the hard horizon: ``est_steps_to_exhaustion`` tells the
  controller how soon the pool runs out at the current churn, which gates
  admissions earlier than the hard one-round bound would.

``free_cells`` counts tombstones as free — tombstone reuse (Prop. 2 as the
allocator) means a freed slot is immediately re-claimable and an ABORT can
only happen when every cell holds a *live* key.

The no-ABORT proof per probe strategy (``core/probe_strategies.py``):

* **linear** — Prop. 2 verbatim: an insert ABORTs iff every cell holds a
  live key, so ``demand <= free_cells`` (free = empty + tombstones) is
  exact.  ``strategy_slack = 0``.
* **robinhood** — identical claim reachability: displacement only reorders
  WHICH lane wins a cell, never whether a free cell is claimable (the
  probe sequence and the available-cell predicate are unchanged), so
  Prop. 2 carries over unchanged.  ``strategy_slack = 0``.
* **hopscotch** — ``free_cells`` is exact (no tombstones: deletes free the
  cell immediately), but an insert needs a free cell *within H of its
  home* and displacement can fail to create one below full load.  The
  strategy therefore reports ``forecast_slack = H`` (0 when the pool fits
  inside one neighborhood, where near-claim sees every free cell and the
  bound is again exact): the controller must keep
  ``demand + safety + slack <= free_cells``.  The slack makes the bound
  conservative, not exact — the reactive rebuild path stays live as the
  backstop for the (rare) displacement-stuck ABORT inside the slack.

The slack is threaded as data, not strategy names: the engine's
``Headroom.slack`` (filled by ``page_table.PageTable.forecast_slack``)
reaches ``Forecast.strategy_slack`` via ``Scheduler.plan_round``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


def pages_held(pos: int, page_size: int) -> int:
    """Pages a lane owns after processing positions [0, pos)."""
    return -(-int(pos) // page_size)


def pages_needed(pos: int, steps: int, page_size: int) -> int:
    """EXACT page demand of one lane processing positions
    [pos, pos + steps): the number of page-boundary crossings
    (multiples of ``page_size``) in that half-open range."""
    if steps <= 0:
        return 0
    a, b = int(pos), int(pos) + int(steps)
    return -(-b // page_size) - (-(-a // page_size))


@dataclasses.dataclass(frozen=True)
class Forecast:
    """One round's occupancy forecast (all page counts are exact for the
    hard horizon; the *_ewma / est_* fields are trend extrapolations)."""
    horizon_steps: int
    demand_pages: int            # exact demand over the hard horizon
    free_cells: int              # n_pages - live (tombstones reusable)
    safety_pages: int
    admit_rate_ewma: float       # requests / step
    growth_slope_ewma: float     # net live pages / step (churn included)
    est_steps_to_exhaustion: float
    strategy_slack: int = 0      # probe-strategy headroom (see module doc)

    @property
    def margin(self) -> int:
        return (self.free_cells - self.demand_pages - self.safety_pages
                - self.strategy_slack)

    @property
    def exhausted(self) -> bool:
        """True when the next ``horizon_steps`` provably cannot be served
        without an ABORT unless the controller evicts or grows first."""
        return self.margin < 0


class OccupancyForecaster:
    """Stateful forecaster: exact short-horizon demand + EWMA trends.

    ``observe`` once per round with that round's measurements; ``forecast``
    whenever a decision needs the current picture (admission gating, the
    headroom check before dispatch)."""

    def __init__(self, page_size: int, *, safety_pages: int = 0,
                 ewma: float = 0.5):
        self.page_size = page_size
        self.safety_pages = int(safety_pages)
        self.ewma = float(ewma)
        self.admit_rate = 0.0
        self.growth_slope = 0.0
        self._last_live: Optional[int] = None

    # -- measurement ------------------------------------------------------

    def observe(self, *, admitted: int, live_pages: int, steps: int) -> None:
        """Fold one round's measurements into the trend EWMAs.  ``steps``
        is the round length (K); ``live_pages`` the post-round live count
        (net of eviction churn)."""
        steps = max(int(steps), 1)
        a = self.ewma
        self.admit_rate = a * (admitted / steps) + (1 - a) * self.admit_rate
        if self._last_live is not None:
            slope = (live_pages - self._last_live) / steps
            self.growth_slope = a * slope + (1 - a) * self.growth_slope
        self._last_live = int(live_pages)

    # -- prediction -------------------------------------------------------

    def demand(self, positions: Sequence[int], stops: Sequence[int],
               horizon_steps: int) -> int:
        """Exact aggregate page demand of the given lanes over the next
        ``horizon_steps``: each lane runs ``min(horizon, stop - pos)``
        more steps and allocates one page per boundary crossed."""
        total = 0
        for p, s in zip(positions, stops):
            total += pages_needed(p, min(int(horizon_steps),
                                         max(int(s) - int(p), 0)),
                                  self.page_size)
        return total

    def forecast(self, positions: Sequence[int], stops: Sequence[int],
                 free_cells: int, horizon_steps: int,
                 strategy_slack: int = 0) -> Forecast:
        d = self.demand(positions, stops, horizon_steps)
        # trend extrapolation: NET live-page slope (eviction churn cancels
        # out, so steady-state churn extrapolates to "never") plus the
        # admit-rate term (each admission claims its first page
        # immediately).  Consumed by the scheduler's admission gate: an
        # est_steps_to_exhaustion inside the lookahead defers admissions
        # earlier than the exact-demand bound alone would.
        slack = int(strategy_slack)
        rate = max(self.growth_slope, 0.0) + max(self.admit_rate, 0.0)
        est = (float("inf") if rate <= 0.0
               else max(free_cells - self.safety_pages - slack, 0) / rate)
        return Forecast(horizon_steps=int(horizon_steps), demand_pages=d,
                        free_cells=int(free_cells),
                        safety_pages=self.safety_pages,
                        admit_rate_ewma=self.admit_rate,
                        growth_slope_ewma=self.growth_slope,
                        est_steps_to_exhaustion=est,
                        strategy_slack=slack)
