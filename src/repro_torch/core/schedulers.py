"""Workload and schedule generators for the concurrent simulator (a copy of
the JAX package's numpy-only ``core/schedulers.py``, importing the port's
``simulator.Workload`` and ``spec``).

The paper's model is an adversarial asynchronous scheduler.  We provide:

* ``uniform_schedule`` — i.i.d. uniform process choice per event (the standard
  stochastic adversary).
* ``bursty_schedule`` — processes run in random-length bursts (more
  sequential-ish interleavings; stresses different races).
* ``stalled_schedule`` — one victim process is starved for a long window and
  then released (exercises the "revalidate / resurrect" machinery: other
  processes observe its tentative copy mid-flight).
* ``round_robin_schedule``.
* ``make_cbounded_workload`` — the paper's *c-bounded fixed-workload*
  scheduler setup (Section 5.4): a fixed batch of operations, at most c
  concurrent ops per key, at most one concurrent insert per key.  Keys are
  partitioned among process groups of size <= c, and at most one process per
  group issues inserts, so the bound holds under ANY schedule.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.simulator import Workload
from repro_torch.core.spec import OP_DELETE, OP_INSERT, OP_LOOKUP, OP_NONE


def uniform_schedule(rng: np.random.Generator, P: int, T: int) -> np.ndarray:
    return rng.integers(0, P, size=T).astype(np.int32)


def round_robin_schedule(P: int, T: int) -> np.ndarray:
    return (np.arange(T) % P).astype(np.int32)


def bursty_schedule(rng: np.random.Generator, P: int, T: int,
                    mean_burst: int = 8) -> np.ndarray:
    out = np.empty(T, dtype=np.int32)
    t = 0
    while t < T:
        p = rng.integers(0, P)
        b = 1 + rng.geometric(1.0 / mean_burst)
        out[t:t + b] = p
        t += b
    return out[:T]


def stalled_schedule(rng: np.random.Generator, P: int, T: int,
                     victim: int = 0, stall_frac: float = 0.6) -> np.ndarray:
    """Victim takes a few steps, is starved for ``stall_frac`` of the run,
    then released to finish."""
    sched = rng.integers(0, P, size=T).astype(np.int32)
    start = int(T * 0.05)
    stop = int(T * (0.05 + stall_frac))
    window = sched[start:stop]
    window[window == victim] = (victim + 1) % P
    sched[start:stop] = window
    return sched


def random_workload(rng: np.random.Generator, P: int, K: int, num_keys: int,
                    p_insert: float = 0.4, p_delete: float = 0.3,
                    keys: np.ndarray | None = None) -> Workload:
    """Uniformly random ops over a small key universe — maximal contention."""
    if keys is None:
        keys = rng.integers(0, num_keys, size=(P, K)).astype(np.uint32)
    r = rng.random((P, K))
    op = np.full((P, K), OP_LOOKUP, dtype=np.int32)
    op[r < p_insert] = OP_INSERT
    op[(r >= p_insert) & (r < p_insert + p_delete)] = OP_DELETE
    return Workload(op=op, key=keys.astype(np.uint32))


def same_key_workload(P: int, K: int, key: int = 7,
                      pattern: str = "insert_delete") -> Workload:
    """All processes hammer a single key — the worst case for the duplicate-
    elimination machinery (Figure 2 scenarios)."""
    op = np.zeros((P, K), dtype=np.int32)
    if pattern == "insert_delete":
        op[:, 0::3] = OP_INSERT
        op[:, 1::3] = OP_DELETE
        op[:, 2::3] = OP_LOOKUP
    elif pattern == "insert_only":
        op[:] = OP_INSERT
    elif pattern == "mixed":
        op[0::2, 0::2] = OP_INSERT
        op[0::2, 1::2] = OP_DELETE
        op[1::2, :] = OP_LOOKUP
    key_arr = np.full((P, K), key, dtype=np.uint32)
    return Workload(op=op, key=key_arr)


def make_cbounded_workload(rng: np.random.Generator, P: int, K: int,
                           c: int, num_keys: int,
                           insert_frac: float = 0.5) -> Workload:
    """Section 5.4 setup: processes are partitioned into groups of size <= c;
    each group owns a disjoint key set; only the group's first process issues
    inserts (and deletes of its own keys), others only lookup/delete.  Under
    ANY schedule: point contention per key <= c and at most one concurrent
    insert per key."""
    n_groups = max(1, P // max(1, c))
    group_of = np.arange(P) % n_groups
    keys_per_group = max(1, num_keys // n_groups)
    op = np.full((P, K), OP_NONE, dtype=np.int32)
    key = np.zeros((P, K), dtype=np.uint32)
    for p in range(P):
        g = group_of[p]
        base = g * keys_per_group
        ks = base + rng.integers(0, keys_per_group, size=K)
        key[p] = ks.astype(np.uint32)
        is_leader = (p == int(np.argmax(group_of == g)))
        if is_leader:
            r = rng.random(K)
            op[p] = np.where(r < insert_frac, OP_INSERT,
                             np.where(r < insert_frac + 0.25, OP_DELETE,
                                      OP_LOOKUP))
        else:
            r = rng.random(K)
            op[p] = np.where(r < 0.5, OP_LOOKUP, OP_DELETE)
    return Workload(op=op, key=key)


def insert_only_distinct(P: int, K: int, start: int = 0) -> Workload:
    """P*K distinct keys, insert-only — for Knuth-style load-factor sweeps
    (no concurrent same-key inserts, Proposition 20 applies)."""
    op = np.full((P, K), OP_INSERT, dtype=np.int32)
    key = (start + np.arange(P * K).reshape(P, K)).astype(np.uint32)
    return Workload(op=op, key=key)
