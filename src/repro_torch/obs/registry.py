"""Metrics registry + exporters (tentpole c).

One process-local registry unifies the repo's scattered measurement
surfaces — the device counter plane, ``page_table.PROBE_STATS``,
``kernels/stats.KERNEL_STATS``, scheduler stats and
``engine.fallback_report`` — behind two snapshot exporters:

* ``prometheus_text()``  — Prometheus text exposition format, and
* ``json_snapshot()``    — the same numbers as one JSON object.

There is no HTTP server (no new deps): the ``ContinuousBatcher`` exposes
``metrics_text()`` / ``metrics_json()`` and ``launch/serve.py --metrics-out``
writes both files at drain, which is what CI archives.

Sources are zero-arg callables registered once and re-read at every
snapshot, so scoped module counters (probe/kernel stats) are absorbed
without the registry knowing their lifetime.  String-valued entries (the
fallback report's "ok"/reason fields) become Prometheus *info*-style
series: ``repro_info{key="decode_tp",value="ok"} 1``.
"""
from __future__ import annotations

import json
import math
from typing import Callable, Dict, Mapping, Union

Number = Union[int, float]


def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


class MetricsRegistry:
    """Counters (monotone), gauges (set), and absorbed sources."""

    def __init__(self, namespace: str = "repro"):
        self.namespace = _sanitize(namespace)
        self._counters: Dict[str, Number] = {}
        self._gauges: Dict[str, Number] = {}
        self._info: Dict[str, str] = {}
        self._sources: Dict[str, Callable[[], Mapping[str, object]]] = {}

    # -- writers -----------------------------------------------------------

    def inc(self, name: str, n: Number = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, v: Number) -> None:
        self._gauges[name] = v

    def set_info(self, name: str, v: str) -> None:
        self._info[name] = str(v)

    def source(self, name: str,
               fn: Callable[[], Mapping[str, object]]) -> None:
        """Register a zero-arg callable returning {metric: value}; re-read
        at every snapshot.  Numeric values export as gauges, strings as
        info series."""
        self._sources[name] = fn

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        counters = dict(self._counters)
        gauges = dict(self._gauges)
        info = dict(self._info)
        for src, fn in sorted(self._sources.items()):
            try:
                vals = fn()
            except Exception as e:  # a dead source must not kill serving
                info[f"{src}_error"] = repr(e)
                continue
            for k, v in vals.items():
                key = f"{src}_{k}"
                if isinstance(v, bool) or isinstance(v, str):
                    info[key] = str(v)
                elif isinstance(v, (int, float)):
                    gauges[key] = v
                else:
                    info[key] = repr(v)
        return {"counters": counters, "gauges": gauges, "info": info}

    def json_snapshot(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, indent=2,
                          default=str)

    def prometheus_text(self) -> str:
        snap = self.snapshot()
        ns = self.namespace
        lines = []
        for name, v in sorted(snap["counters"].items()):
            m = f"{ns}_{_sanitize(name)}"
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {_fmt(v)}")
        for name, v in sorted(snap["gauges"].items()):
            m = f"{ns}_{_sanitize(name)}"
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {_fmt(v)}")
        if snap["info"]:
            m = f"{ns}_info"
            lines.append(f"# TYPE {m} gauge")
            for name, v in sorted(snap["info"].items()):
                val = str(v).replace("\\", "\\\\").replace('"', '\\"')
                lines.append(
                    f'{m}{{key="{_sanitize(name)}",value="{val}"}} 1')
        return "\n".join(lines) + "\n"


def _fmt(v: Number) -> str:
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        return repr(v)
    return str(v)
