"""Request-span tracing on the virtual clock (tentpole b).

A trace is a JSONL stream of events, one object per line, emitted by the
scheduler (request lifecycle), the ``ContinuousBatcher`` / sharded
simulator (per-round decode + table health), and the ``PrefixRouter``
(grow / lose-host / migration interleaving).  Every event carries the
VIRTUAL clock (decode steps) — never wall time — and is serialized with
``sort_keys`` + fixed separators, so a run is **byte-identical** across
machines and repetitions (pinned by ``tests/test_obs.py``).

Span schema (event -> required fields beyond ``clock``/``event``):

    arrival       req                      request entered the queue
    admit         req, slot, prefill, readmit   (readmit = prior preemptions)
    first_token   req                      first decode token surfaced
    preempt       req, slot                proactive eviction back to QUEUED
    finish        req, tokens, ttft, tpot  terminal; idempotent upstream
    abort         lanes, grew_to           reactive allocator ABORT latch
    decode        reqs, tokens, pages      one megastep round (per shard)
    round         counters{...}, health{...}    driver round roll-up
    shard_health  live, tombs, n_cells, free, tomb_density, probe_p99,
                  migrated, migration_left       per-shard, per-round gauge
    grow          n_pages_old, n_pages_new       lazy resize began (window
                                                 OPENS: old table frozen)
    migrate       moved                    one service round's sweep (may
                                           move 0 — emitted each round the
                                           window is open)
    migrate_done  —                        window CLOSES (old table retired)
    lose_host     victims                  host-group loss + re-homing
    summary       sched stats roll-up      exactly once, last line

Shard-scoped events additionally carry ``shard``.  ``tools/trace_report.py``
renders timelines/health curves from this stream and checks the trace
invariants listed in ``obs/README.md``.
"""
from __future__ import annotations

import json
import os
from typing import IO, Optional, Union

import numpy as np


def _plain(v):
    """Coerce numpy scalars/arrays so the JSON encoder stays deterministic
    (no platform-dependent reprs)."""
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return [_plain(x) for x in v.tolist()]
    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


class Tracer:
    """Append-only deterministic JSONL writer.

    ``sink`` is a path or an open text file.  Emission order is program
    order; within one clock value the order is still deterministic because
    every emitter runs on the single-threaded driver.
    """

    def __init__(self, sink: Union[str, IO[str]]):
        if hasattr(sink, "write"):
            self._f: IO[str] = sink  # type: ignore[assignment]
            self._owns = False
            self.path: Optional[str] = getattr(sink, "name", None)
        else:
            d = os.path.dirname(str(sink))
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(sink, "w")
            self._owns = True
            self.path = str(sink)
        self.n_events = 0

    def emit(self, event: str, clock: int, **fields) -> None:
        rec = {"event": str(event), "clock": int(clock)}
        rec.update(_plain(fields))
        self._f.write(json.dumps(rec, sort_keys=True,
                                 separators=(",", ":")) + "\n")
        self.n_events += 1

    def close(self) -> None:
        self._f.flush()
        if self._owns:
            self._f.close()

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_trace(path: str):
    """Parse a JSONL trace back into a list of event dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
