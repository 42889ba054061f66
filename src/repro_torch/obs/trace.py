"""Request-span tracing on the virtual clock (tentpole b), and the
serving path's layer spans on the wall clock.

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

Layer spans (the port's own; the Tracer above is the reference's copy)
----------------------------------------------------------------------

``span(name)`` marks a piece of the serving path where the work happens
(``batcher.round``, ``model.rope``, ``allocator.alloc_step``, ...: the
prefix names the layer).  A span records its name, its start and end in
ns on ``clock_ns`` (``time.time_ns``, the clock of ``torch.profiler``'s
kineto events, so every idle gap of the device can be put down to a
span), the index of its parent span, and the host syncs
(``device.SYNC_STATS``) and keys probed (``page_table.PROBED_TOTAL``)
over its interval.  Spans are kept in memory, only inside
``record_spans()``, the one switch; outside it a span site costs one test
of a module global and allocates nothing.  ``batcher.round`` carries the
virtual clock of its round's Tracer events, which links a round's layer
spans to its requests.  ``summarize`` gives self times and counts by
name; ``write_chrome_trace`` writes the spans for Perfetto.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import IO, Dict, Iterator, List, Optional, Union

import numpy as np

from repro_torch.device import SYNC_STATS


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


# ---------------------------------------------------------------------------
# Layer spans on the wall clock.

clock_ns = time.time_ns

_spans: Optional[List["Span"]] = None   # the list recorded into; None: off
_open: List[int] = []                   # open spans' indices, innermost last
_probed: Dict[str, int] = {}            # page_table.PROBED_TOTAL, once bound


class Span:
    """One recorded span.  ``syncs`` and ``keys_probed`` are the counters'
    differences over the span (its children's included); ``parent`` is the
    index of the enclosing span in the recorded list, -1 for a root."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "syncs",
                 "keys_probed", "clock")

    def __init__(self, name: str, clock: Optional[int]):
        self.name, self.clock = name, clock

    def __enter__(self) -> "Span":
        self.parent = _open[-1] if _open else -1
        _open.append(len(_spans))
        _spans.append(self)
        self.syncs = -SYNC_STATS["host_syncs"]
        self.keys_probed = -_probed["keys_probed"]
        self.start_ns = clock_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = clock_ns()
        self.syncs += SYNC_STATS["host_syncs"]
        self.keys_probed += _probed["keys_probed"]
        _open.pop()


class _Off:
    """The span site's context while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


def span(name: str, clock: Optional[int] = None):
    """``with span("model.rope"):`` records one span while ``record_spans``
    is on.  ``clock``: the virtual clock of the Tracer's events the span
    belongs to, where it has one."""
    if _spans is None:
        return _OFF
    return Span(name, clock)


@contextlib.contextmanager
def record_spans() -> Iterator[List[Span]]:
    """Record every span inside the block into the yielded list."""
    global _spans, _open, _probed
    # bound here: page_table imports this module
    from repro_torch.serving.page_table import PROBED_TOTAL
    _probed = PROBED_TOTAL
    outer = (_spans, _open)
    _spans, _open = [], []
    try:
        yield _spans
    finally:
        _spans, _open = outer


def summarize(spans: List[Span]) -> Dict[str, dict]:
    """By span name: ``count``, ``total_s``, ``self_s`` (the spans' time
    less their children's), ``syncs`` and ``keys_probed`` (self counts,
    so that the counts of all names sum to the roots')."""
    out: Dict[str, dict] = {}

    def entry(name):
        return out.setdefault(name, dict(count=0, total_s=0.0, self_s=0.0,
                                         syncs=0, keys_probed=0))

    for s in spans:
        d, sec = entry(s.name), (s.end_ns - s.start_ns) / 1e9
        d["count"] += 1
        d["total_s"] += sec
        d["self_s"] += sec
        d["syncs"] += s.syncs
        d["keys_probed"] += s.keys_probed
        if s.parent >= 0:       # the parent's self counts lose this span
            p = entry(spans[s.parent].name)
            p["self_s"] -= sec
            p["syncs"] -= s.syncs
            p["keys_probed"] -= s.keys_probed
    return out


def write_chrome_trace(spans: List[Span], path: str) -> None:
    """The spans as Chrome-trace JSON (complete events in the spans'
    order, µs on ``clock_ns``; ``parent`` indexes that order), for
    Perfetto beside a profiler trace of the same run."""
    pid = os.getpid()
    events = []
    for s in spans:
        args = {"parent": s.parent, "syncs": s.syncs,
                "keys_probed": s.keys_probed}
        if s.clock is not None:
            args["clock"] = s.clock
        events.append({"name": s.name, "cat": s.name.split(".")[0],
                       "ph": "X", "ts": s.start_ns / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid,
                       "tid": 0, "args": args})
    d = os.path.dirname(str(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ns"}, f)
