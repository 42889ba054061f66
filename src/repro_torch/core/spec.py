"""Sequential specification of the dictionary (the abstract object).

``insert(v)`` returns True iff v was absent (and adds it); ``delete(v)``
returns True iff v was present (and removes it); ``lookup(v)`` returns whether
v is present.  ``insert`` may nondeterministically return ABORT without
modifying the set (Section 4: ABORTs do not affect the logical state).

Used as the oracle for linearizability checking and for validating the
batched/TPU implementations.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Set, Tuple

# Operation codes shared across the package.
OP_LOOKUP = 0
OP_INSERT = 1
OP_DELETE = 2
OP_NONE = -1

# Return codes.
RET_FALSE = 0
RET_TRUE = 1
RET_ABORT = 2
RET_PENDING = -1

OP_NAMES = {OP_LOOKUP: "lookup", OP_INSERT: "insert", OP_DELETE: "delete"}
RET_NAMES = {RET_FALSE: "false", RET_TRUE: "true", RET_ABORT: "ABORT",
             RET_PENDING: "pending"}


def step_spec(state: Set[int], op: int, key: int) -> Tuple[Set[int], int]:
    """Apply one operation to the abstract set; return (state', ret)."""
    if op == OP_LOOKUP:
        return state, (RET_TRUE if key in state else RET_FALSE)
    if op == OP_INSERT:
        if key in state:
            return state, RET_FALSE
        return state | {key}, RET_TRUE
    if op == OP_DELETE:
        if key in state:
            return state - {key}, RET_TRUE
        return state, RET_FALSE
    raise ValueError(f"bad op {op}")


def apply_sequential(ops: Iterable[Tuple[int, int]],
                     initial: Set[int] | None = None) -> Tuple[Set[int], List[int]]:
    """Run a sequence of (op, key) through the spec; returns final state and
    the list of return codes."""
    state = set(initial or ())
    rets: List[int] = []
    for op, key in ops:
        state, r = step_spec(state, op, key)
        rets.append(r)
    return state, rets


def legal_next(state_present: bool, op: int, ret: int) -> Tuple[bool, bool]:
    """Single-key spec automaton: given presence bit, is (op, ret) legal, and
    what is the next presence bit?  ABORTing inserts are legal in any state
    and do not change it."""
    if op == OP_INSERT and ret == RET_ABORT:
        return True, state_present
    if op == OP_LOOKUP:
        return (ret == (RET_TRUE if state_present else RET_FALSE)), state_present
    if op == OP_INSERT:
        if state_present:
            return ret == RET_FALSE, True
        return ret == RET_TRUE, True
    if op == OP_DELETE:
        if state_present:
            return ret == RET_TRUE, False
        return ret == RET_FALSE, False
    raise ValueError(f"bad op {op}")
