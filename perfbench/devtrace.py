"""The traced run: short profiled samples spread over the measured
window, so that the traced run serves the timed run's load.  In a sample
(``SAMPLE_ROUNDS`` consecutive rounds, ``SAMPLES`` of them, one due every
window / ``SAMPLES`` seconds) the profiler records the device's activity
(``DeviceSession``), and host spans the harness records around the
program's layers put each idle gap of the device down to what the host
was doing.  Between samples neither the profiler nor a span runs.  The
time spent opening and closing the samples (stopping the profiler takes
a good part of a second) is counted (``Sampler.stolen``), and the open
loop's arrival clock stands still for it.

The spans wrap the program's functions from outside (the instance's
methods and the modules' attributes the engine calls through); nothing of
the program is edited, and the wrappers exist only inside a sample.

The program's own spans (``repro_torch.obs.trace``: ``batcher.round``,
``model.moe``, ``allocator.alloc_step``, ...) are recorded over the same
samples (``port.record_spans``) and summed by name (``span_table``): self
and total host seconds, self host syncs, count, and the device's idle
seconds put down to the innermost program span (the sweep of
``Spans.attribute``).  Per-layer readers take them from ``window.spans``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from perfbench import port

SAMPLES = 8
SAMPLE_ROUNDS = 2
K1_KERNELS = ("split_decode_kernel", "merge_splits_kernel")


class Spans:
    """Host spans (name, start ns, end ns) on the clock the profiler's
    events use (``time.time_ns``)."""

    NONE = "harness"    # what ``attribute`` gives where no span holds

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    def wrap(self, name, fn):
        def wrapped(*a, **kw):
            t0 = time.time_ns()
            try:
                return fn(*a, **kw)
            finally:
                self.items.append((name, t0, time.time_ns()))
        return wrapped

    def attribute(self, times: List[int]) -> List[str]:
        """The innermost span holding each of the sorted ``times``
        (``NONE`` where none does).  The spans nest (one thread), so a
        sweep with a stack finds them."""
        marks = sorted([(a, 1, n) for n, a, b in self.items]
                       + [(b, 0, n) for n, a, b in self.items])
        out, stack, j = [], [], 0
        for t in times:
            while j < len(marks) and marks[j][0] <= t:
                _, start, name = marks[j]
                if start:
                    stack.append(name)
                elif name in stack:
                    del stack[len(stack) - 1 - stack[::-1].index(name)]
                j += 1
            out.append(stack[-1] if stack else self.NONE)
        return out


def install_spans(srv, spans: Spans):
    """Wrap the batcher's phases and the engine's layers with spans;
    returns the function that takes the wrappers off again."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE
    from repro_torch.serving import engine as EG
    from repro_torch.serving import page_table as PT
    undo = []

    def patch(obj, attr, name):
        old = getattr(obj, attr)
        setattr(obj, attr, spans.wrap(name, old))
        undo.append((obj, attr, old))

    facade = PT.for_strategy(srv.strategy)
    patch(facade, "alloc_step_incremental", "allocator step")
    patch(facade, "free_sequences", "allocator free")
    patch(EG, "fused_decode_kernel", "K1 launch")
    patch(EG, "_rope_single", "rope")
    patch(EG, "_out_proj", "out projection")
    patch(EG.paged, "write_token_kv", "KV write")
    patch(EG.paged, "write_plan", "KV write plan")
    patch(EG.nn, "rmsnorm", "rmsnorm")
    patch(EG, "decode_headroom", "headroom read")
    patch(MOE, "moe_apply", "MoE block")
    patch(L, "mlp_apply", "MLP block")
    patch(L, "attn_qkv_decode", "qkv projection")
    patch(lm, "_logits", "LM head")
    patch(srv, "mega_fn", "megastep other")
    patch(srv, "_forcing", "batcher forcing")
    patch(srv, "_absorb", "batcher absorb")
    patch(srv, "_apply_plan", "plan apply")
    patch(srv.sched, "plan_round", "scheduler plan")
    patch(srv, "step_round", "batcher other")

    def remove():
        for obj, attr, old in reversed(undo):
            setattr(obj, attr, old)
    return remove


class DeviceSession:
    """One session of the profiler's device activity (CUPTI through
    kineto), started and stopped with the calls ``torch.profiler`` makes,
    but without its parsing of the events into Python objects: the
    events are read only after the window (``events``)."""

    def __init__(self):
        from torch.autograd import profiler as AP
        self._p = AP.profile(use_device="cuda", use_cpu=False,
                             use_kineto=True)
        self._p._prepare_trace()
        self._p._start_trace()
        self._result = None

    def stop(self) -> None:
        from torch.autograd import profiler as AP
        self._result = torch.autograd._disable_profiler()
        getattr(AP, "_run_on_profiler_stop", lambda: None)()

    def events(self):
        return self._result.events()


class Sampler:
    """The window's profiled samples.  ``start`` sets when each is due;
    ``before_round`` opens a sample once one is due (spans installed, the
    device drained, the profiler started) and says whether the coming
    round is in one; ``after_round`` closes it after ``SAMPLE_ROUNDS``
    rounds (the device drained, the profiler stopped, the spans taken
    off).  The traces are read only after the window (``summary``)."""

    def __init__(self, srv, device, profile_device: bool):
        self.srv, self.device = srv, device
        self.profile_device = profile_device
        self.due: List[float] = []
        self.cur = None             # the open sample
        self.done: List[dict] = []  # closed samples
        self.stolen = 0.0           # seconds spent opening and closing

    def start(self, ws: float, seconds: float) -> None:
        self.due = [ws + (i + 0.5) * seconds / SAMPLES
                    for i in range(SAMPLES)]

    def before_round(self) -> bool:
        now = time.perf_counter()
        if self.cur is None and self.due and now >= self.due[0]:
            while self.due and self.due[0] <= now:  # one sample, late or not
                self.due.pop(0)
            spans = Spans()
            undo = contextlib.ExitStack()
            undo.callback(install_spans(self.srv, spans))
            cur = dict(spans=spans, rounds=0, prof=None, undo=undo,
                       program=undo.enter_context(port.record_spans()))
            if self.profile_device:
                torch.cuda.synchronize(self.device)
                cur["prof"] = DeviceSession()
            cur["t0_ns"] = time.time_ns()
            self.stolen += time.perf_counter() - now
            self.cur = cur
        return self.cur is not None

    def after_round(self) -> None:
        if self.cur is None:
            return
        self.cur["rounds"] += 1
        if self.cur["rounds"] >= SAMPLE_ROUNDS:
            self.close()

    def close(self) -> None:
        """Close the open sample, if any (also at the window's end)."""
        cur, self.cur = self.cur, None
        if cur is None:
            return
        t = time.perf_counter()
        if self.profile_device:
            torch.cuda.synchronize(self.device)
        cur["t1_ns"] = time.time_ns()
        if cur["prof"] is not None:
            cur["prof"].stop()
        cur.pop("undo").close()     # the program's recorder, the wrappers
        self.stolen += time.perf_counter() - t
        self.done.append(cur)

    def summary(self):
        """The samples read together: ``(trace, spans)``.  ``trace``: the
        samples' device traces (``summarize`` of each, summed), with
        ``window_s``, the samples' total length; None when no device trace
        was taken.  ``spans``: the program's spans by name
        (``span_table``, the samples' summed), with the device's idle
        seconds put down to each where a trace was taken; None without a
        sample."""
        busy = k1 = window = 0.0
        ops: Dict[str, float] = {}
        gaps: Dict[str, float] = {}
        tables = []
        for cur in self.done:
            prog = [(s.name, s.start_ns, s.end_ns, s.parent, s.syncs)
                    for s in cur["program"]]
            idle = None
            if cur["prof"] is not None:
                one = summarize(device_events(cur["prof"]), cur["t0_ns"],
                                cur["t1_ns"], cur["spans"], top=None,
                                program=prog)
                busy += one["busy_s"]
                k1 += one["k1_s"] or 0.0
                window += (cur["t1_ns"] - cur["t0_ns"]) / 1e9
                for into, pairs in ((ops, one["device_ops"]),
                                    (gaps, one["idle_gaps"])):
                    for name, sec in pairs:
                        into[name] = into.get(name, 0.0) + sec
                idle = one["program_idle"]
            tables.append(span_table(prog, idle))
        spans = merge_tables(tables) if tables else None
        if not self.profile_device or not self.done:
            return None, spans
        return {"busy_s": busy, "k1_s": k1 if k1 > 0 else None,
                "window_s": window, "samples": len(self.done),
                "device_ops": _top(ops, 10), "idle_gaps": _top(gaps, 10)}, \
            spans


def span_table(items: Sequence[tuple],
               idle: Optional[Dict[str, float]] = None) -> Dict[str, dict]:
    """The program's spans of one sample by name.  ``items``: (name, start
    ns, end ns, parent index or -1, host syncs over the span) in the
    order recorded.  Per name: ``count``; ``total_s``, the spans' host
    seconds; ``self_s``, less their children's; ``outer_s``, the seconds
    of those that no span of the same layer (the name's part before its
    first dot) encloses; ``syncs``, self host syncs; and, where ``idle``
    gives them, ``idle_s``, the device's idle seconds put down to the
    name."""
    out: Dict[str, dict] = {}

    def entry(name):
        return out.setdefault(name, dict(count=0, total_s=0.0, self_s=0.0,
                                         outer_s=0.0, syncs=0))

    for name, a, b, parent, syncs in items:
        e, sec = entry(name), (b - a) / 1e9
        e["count"] += 1
        e["total_s"] += sec
        e["self_s"] += sec
        e["syncs"] += syncs
        if parent >= 0:
            p = entry(items[parent][0])
            p["self_s"] -= sec
            p["syncs"] -= syncs
        layer, up = name.split(".")[0], parent
        while up >= 0 and items[up][0].split(".")[0] != layer:
            up = items[up][3]
        if up < 0:
            e["outer_s"] += sec
    if idle is not None:
        for name, e in out.items():
            e["idle_s"] = idle.get(name, 0.0)
    return out


def merge_tables(tables: Sequence[Dict[str, dict]]) -> Dict[str, dict]:
    """``span_table``s summed name by name."""
    out: Dict[str, dict] = {}
    for t in tables:
        for name, e in t.items():
            into = out.setdefault(name, {})
            for k, v in e.items():
                into[k] = into.get(k, 0) + v
    return out


def costliest(spans: Dict[str, dict], n: int = 15) -> Dict[str, dict]:
    """The ``n`` names of a span table with the most self host seconds."""
    return dict(sorted(spans.items(), key=lambda kv: -kv[1]["self_s"])[:n])


def _top(d: Dict[str, float], n):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def device_events(session) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every operation the trace saw on the
    device (kernels, copies, sets)."""
    out = []
    for e in session.events():
        if "CUDA" not in str(e.device_type()):
            continue
        t0 = int(e.start_ns())
        out.append((e.name(), t0, t0 + int(e.duration_ns())))
    return out


def summarize(events, t0_ns: int, t1_ns: int, spans: Spans,
              top=10, program: Optional[Sequence[tuple]] = None) -> Dict:
    """Busy seconds (the union of the device's intervals inside the
    window), K1's device seconds, the device operations that took most
    time and the longest idle time by what the host was doing (the
    harness's ``spans``); with ``program`` (``span_table``'s items), also
    ``program_idle``: the idle seconds by the innermost program span
    (those outside every program span left out)."""
    by_name: Dict[str, float] = {}
    k1 = 0.0
    iv = []
    for name, a, b in events:
        a, b = max(a, t0_ns), min(b, t1_ns)
        if b <= a:
            continue
        iv.append((a, b))
        s = (b - a) / 1e9
        by_name[name] = by_name.get(name, 0.0) + s
        if any(k in name for k in K1_KERNELS):
            k1 += s
    iv.sort()
    gaps, cur_a, cur_b = {}, None, t0_ns
    merged = []
    for a, b in iv:
        if cur_a is None or a > cur_b:
            if cur_a is not None:
                merged.append((cur_a, cur_b))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_a is not None:
        merged.append((cur_a, cur_b))
    prev, holes = t0_ns, []
    for a, b in merged + [(t1_ns, t1_ns)]:
        if a > prev:
            holes.append((prev, a))
        prev = max(prev, b)
    mids = [(a + b) // 2 for a, b in holes]
    for (a, b), name in zip(holes, spans.attribute(mids)):
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e9
    busy = sum(b - a for a, b in merged) / 1e9
    out = {"busy_s": busy, "k1_s": k1 if k1 > 0 else None,
           "device_ops": [[n[:160], s] for n, s in _top(by_name, top)],
           "idle_gaps": _top(gaps, top)}
    if program is not None:
        prog = Spans()
        prog.items = [(n, a, b) for n, a, b, _, _ in program]
        idle: Dict[str, float] = {}
        for (a, b), name in zip(holes, prog.attribute(mids)):
            if name != Spans.NONE:
                idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
        out["program_idle"] = idle
    return out
