"""Device-memory bytes-moved accounting for the decode kernels (a
machine-independent counter, the kernel-layer twin of
``page_table.PROBE_STATS``).

The wrappers account structurally: from the concrete block table and
positions they compute how many bytes each call reads from device memory
(pages actually fetched, slot-index traffic, scale sidecars); the mamba
state kernel's from its shapes.  A host-side replay, never a wall-clock
measurement.  Every call of the port is eager,
so every call counts.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

#   probe_bytes     — slot-index / block-table traffic
#   attn_bytes      — K/V page payload (+ int8 scale sidecars)
#   ssm_state_bytes — the mamba state kernel's float32 h, read and written
#                     once a call (from shapes alone); chip_smoke.py's
#                     kernels line takes the kernel's byte bound from it
KERNEL_STATS = {"probe_bytes": 0, "attn_bytes": 0, "ssm_state_bytes": 0}


def kernel_stats_reset() -> None:
    for k in KERNEL_STATS:
        KERNEL_STATS[k] = 0


@contextlib.contextmanager
def kernel_stats_scope() -> Iterator[dict]:
    """Scoped byte accounting: inside the ``with`` block the counters start
    at 0; on exit the enclosing values are restored exactly.  Read the
    scoped counts from the yielded dict before the block exits."""
    outer = dict(KERNEL_STATS)
    kernel_stats_reset()
    try:
        yield KERNEL_STATS
    finally:
        KERNEL_STATS.update(outer)


def note_bytes(category: str, n) -> None:
    KERNEL_STATS[category] += int(n)
