"""Linearizability checker for dictionary histories.

Per the locality theorem (used by the paper in Section 5.2), a history is
linearizable iff each per-key projection is linearizable, so we check each
key independently against the single-key dictionary automaton
(``spec.legal_next``): state = "key present?".

Within a key we additionally decompose the history at *quiescent points*
(moments where no operation on that key is pending); the chunks between
quiescent points must linearize in order, carrying forward the set of
reachable presence-states.  Inside a chunk we run a memoized DFS over
(linearized-set bitmask, presence) states — exact, exponential only in the
maximum overlap degree, which is small for our workloads.

Pending operations (invoked, no response) MAY be linearized (with any legal
return) or omitted, per the definition of a completion of a history.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from repro_torch.core.spec import (OP_DELETE, OP_INSERT, OP_LOOKUP, RET_ABORT,
                             RET_FALSE, RET_PENDING, RET_TRUE, legal_next)

INF = 1 << 60


@dataclass(frozen=True)
class HEvent:
    """One operation instance in a history."""
    op: int
    key: int
    ret: int          # RET_* (RET_PENDING if no response)
    t_inv: int
    t_rsp: int        # -1 if pending

    @property
    def pending(self) -> bool:
        return self.t_rsp < 0 or self.ret == RET_PENDING

    @property
    def rsp(self) -> int:
        return INF if self.pending else self.t_rsp


def _legal_appends(present: bool, op: int, ret: int) -> List[bool]:
    """Next-presence options when appending (op, ret); [] if illegal.
    For pending ops (ret == RET_PENDING) any legal return is allowed."""
    if ret != RET_PENDING:
        ok, nxt = legal_next(present, op, ret)
        return [nxt] if ok else []
    outs = []
    for r in (RET_FALSE, RET_TRUE, RET_ABORT):
        if op != OP_INSERT and r == RET_ABORT:
            continue
        ok, nxt = legal_next(present, op, r)
        if ok and nxt not in outs:
            outs.append(nxt)
    return outs


def _check_chunk(evs: List[HEvent], init_states: Set[bool]) -> Set[bool]:
    """Exact search: which presence-states are reachable after linearizing
    all completed ops of ``evs`` (pending ops optional)?  Empty set == not
    linearizable."""
    n = len(evs)
    if n == 0:
        return set(init_states)
    full_completed = 0
    for idx, e in enumerate(evs):
        if not e.pending:
            full_completed |= (1 << idx)

    # precedence: e must come after all completed ops whose rsp < e.inv
    preds = []
    for e in evs:
        p = 0
        for jdx, f in enumerate(evs):
            if not f.pending and f.t_rsp < e.t_inv:
                p |= (1 << jdx)
        preds.append(p)

    finals: Set[bool] = set()
    seen: Set[Tuple[int, bool]] = set()
    stack: List[Tuple[int, bool]] = [(0, s) for s in init_states]
    while stack:
        mask, present = stack.pop()
        if (mask, present) in seen:
            continue
        seen.add((mask, present))
        if (mask & full_completed) == full_completed:
            finals.add(present)
            # keep exploring: pending ops may still be linearized, possibly
            # changing the carried state
        for idx, e in enumerate(evs):
            bit = 1 << idx
            if mask & bit:
                continue
            if (preds[idx] & ~mask):
                continue  # a predecessor not yet linearized
            for nxt in _legal_appends(present, e.op, e.ret):
                stack.append((mask | bit, nxt))
    return finals


def check_key_history(evs: Sequence[HEvent],
                      initial_present: bool = False) -> bool:
    """Is the per-key history linearizable?"""
    evs = sorted(evs, key=lambda e: (e.t_inv, e.rsp))
    # split at quiescent points
    chunks: List[List[HEvent]] = []
    cur: List[HEvent] = []
    cur_max_rsp = -1
    for e in evs:
        if cur and e.t_inv > cur_max_rsp:
            chunks.append(cur)
            cur = []
            cur_max_rsp = -1
        cur.append(e)
        cur_max_rsp = max(cur_max_rsp, e.rsp)
    if cur:
        chunks.append(cur)

    states: Set[bool] = {initial_present}
    for ch in chunks:
        states = _check_chunk(ch, states)
        if not states:
            return False
    return True


def check_history(rows: Iterable[Tuple[int, int, int, int, int, int, int]],
                  initial_present: Dict[int, bool] | None = None) -> Tuple[bool, List[int]]:
    """Check a whole history.

    ``rows``: iterable of (proc, opidx, op, key, ret, t_inv, t_rsp) as
    produced by ``simulator.history_arrays``.  Returns (ok, bad_keys).
    """
    initial_present = initial_present or {}
    by_key: Dict[int, List[HEvent]] = {}
    for (_p, _k, op, key, ret, t_inv, t_rsp) in rows:
        pend = t_rsp < 0
        by_key.setdefault(key, []).append(
            HEvent(op=op, key=key, ret=(RET_PENDING if pend else ret),
                   t_inv=t_inv, t_rsp=(-1 if pend else t_rsp)))
    bad = []
    for key, evs in by_key.items():
        if not check_key_history(evs, initial_present.get(key, False)):
            bad.append(key)
    return (len(bad) == 0), bad
