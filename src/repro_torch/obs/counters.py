"""On-device counter plane (PyTorch port of ``obs/counters.py``).

``Counters`` is a tuple of scalar int32 tensors that rides inside the
decode state (``state["counters"]``) when ``cfg.telemetry`` is on; the
engine accumulates it on the device and the batcher reads it at the round's
existing host sync.  When the knob is off the leaf does not exist and every
update site keys on ``"counters" in state``.  The host plane
(``HOST_COUNTERS``) counts the eager host-driven work that has no device
state to ride: the sharded table's migration sweeps (``dist/table_shard``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple

import torch


class Counters(NamedTuple):
    """Monotone event counts since state creation (scalar int32 each)."""

    probe_steps: torch.Tensor
    pages_allocated: torch.Tensor
    pages_freed: torch.Tensor
    tombstones_created: torch.Tensor
    tombstones_reclaimed: torch.Tensor
    abort_events: torch.Tensor
    tokens_accepted: torch.Tensor
    migration_moved: torch.Tensor

    @classmethod
    def zeros(cls, device=None) -> "Counters":
        return cls(*(torch.zeros((), dtype=torch.int32, device=device)
                     for _ in cls._fields))


def snapshot(c) -> Dict[str, int]:
    """Materialize a Counters (device or host plane) as a plain-int dict."""
    return {f: int(v) for f, v in zip(Counters._fields, c)}


def delta(cur: Dict[str, int], prev: Dict[str, int]) -> Dict[str, int]:
    return {k: cur[k] - prev.get(k, 0) for k in cur}


def _i32(x) -> torch.Tensor:
    return x.to(torch.int32)


def update_token_counters(counters: Counters, *, act, aborts, positions,
                          page_size: int, table_before=None,
                          table_after=None) -> Counters:
    """One decode token's worth of accumulation on the device (see the
    reference for the derivations)."""
    act_i = act.to(torch.int32)
    ab_i = aborts.to(torch.int32)
    upd = {
        "abort_events": _i32(counters.abort_events + ab_i.sum()),
        "tokens_accepted": _i32(counters.tokens_accepted
                                + (act_i * (1 - ab_i)).sum()),
    }
    if table_before is not None and table_after is not None:
        need_new = ((positions % page_size) == 0).to(torch.int32) * act_i
        dk = _i32(table_after.num_keys - table_before.num_keys)
        dt = _i32(table_before.num_tombs - table_after.num_tombs)
        upd["probe_steps"] = _i32(counters.probe_steps + 2 * need_new.sum())
        upd["pages_allocated"] = _i32(counters.pages_allocated + dk)
        upd["tombstones_reclaimed"] = _i32(counters.tombstones_reclaimed
                                           + dt.clamp_min(0))
    return counters._replace(**upd)


def note_free(counters: Counters, *, table_before, table_after) -> Counters:
    """Accounting for ``free_sequences`` between rounds."""
    dk = _i32(table_before.num_keys - table_after.num_keys)
    dt = _i32(table_after.num_tombs - table_before.num_tombs)
    return counters._replace(
        pages_freed=_i32(counters.pages_freed + dk.clamp_min(0)),
        tombstones_created=_i32(counters.tombstones_created
                                + dt.clamp_min(0)))



# -- host plane -------------------------------------------------------------

HOST_COUNTERS: Dict[str, int] = {f: 0 for f in Counters._fields}


def note_host(field: str, n: int) -> None:
    HOST_COUNTERS[field] = HOST_COUNTERS.get(field, 0) + int(n)


@contextlib.contextmanager
def host_counters_scope():
    """Zero the host plane for the ``with`` body; restore (outer + body)
    afterwards so nesting composes additively."""
    outer = dict(HOST_COUNTERS)
    for k in HOST_COUNTERS:
        HOST_COUNTERS[k] = 0
    try:
        yield HOST_COUNTERS
    finally:
        body = dict(HOST_COUNTERS)
        for k in HOST_COUNTERS:
            HOST_COUNTERS[k] = outer.get(k, 0) + body.get(k, 0)
