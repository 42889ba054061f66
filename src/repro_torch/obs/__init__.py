"""Unified telemetry: on-device counter plane, span tracing, metrics
registry (``trace`` and ``registry`` are copies of the JAX package's)."""
from repro_torch.obs.counters import (Counters, HOST_COUNTERS, delta,
                                      host_counters_scope, note_free,
                                      note_host, snapshot,
                                      update_token_counters)
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import Tracer, read_trace

__all__ = [
    "Counters", "HOST_COUNTERS", "delta", "host_counters_scope",
    "note_free", "note_host", "snapshot", "update_token_counters",
    "MetricsRegistry", "Tracer", "read_trace",
]
