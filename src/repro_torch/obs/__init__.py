"""Unified telemetry: on-device counter plane, span tracing, metrics
registry (``trace`` and ``registry`` are copies of the JAX package's)."""
from repro_torch.obs.counters import (Counters, delta, note_free, snapshot,
                                      update_token_counters)
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import Tracer, read_trace

__all__ = [
    "Counters", "delta", "note_free", "snapshot", "update_token_counters",
    "MetricsRegistry", "Tracer", "read_trace",
]
