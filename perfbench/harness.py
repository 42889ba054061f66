"""One run of one cell: set up the port from the cell's configuration and
traffic files, serve the traffic through ``ContinuousBatcher.step_round``
for the measured window, judge what it served against the reference, and
read the cell's metrics.

Set-up (``setup_s``, from process start to the first timed round): the
port's import and the card, the weights drawn on the card from the seed,
the decode state, and the warm-up: an open loop runs its arrivals for the
mix's ``warmup_s`` so that the lanes reach steady occupancy; a closed loop
seats its lanes and runs ``warmup_rounds`` rounds.

Host clock (``time.perf_counter``): each round's start and end, and
``mega_fn``'s share of it (in a traced run up to the device's end of it:
a synchronise after ``mega_fn``, where the batcher's next line waits for
the device anyway); each request's due time, its admission, first sampled
token and last token, read at the end of the round that produced them.

A traced run serves the same load: the profiler and the host spans run
only in short samples spread over the window (``devtrace.Sampler``), and
each round records whether it lay in one, so that a reader takes host
times from the rounds outside them and device shares from those inside.
The program's own spans, recorded in the samples too, reach the readers
summed by name as ``window.spans`` (``devtrace.span_table``; None in a
timed run), and the 15 with the most self host time the result's
``spans``.

What belongs to the configuration's model (its weights' draws, the
port's parameter tree, the reference, the counts) comes from its model
modules (``perfbench/modules.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import pathlib
import time
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import check as CK
from perfbench import devtrace, port, stats, traffic
from perfbench.reference import weights as RW

HERE = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    metrics: List[dict]        # this cell's metrics for a run of its kind
    chips: int


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: dict, name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer
    metrics (``trace`` true): those without a ``workloads`` key, and
    those that name the cell."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if name in m.get("workloads", [name])]


def load_cell(root, name: str, trace: bool) -> Cell:
    """A cell of ``BENCHMARK.json`` with its files, found by name."""
    root = pathlib.Path(root)
    bench = load_json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = wl[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / cfg_entry["file"])
    mix = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    return Cell(name=name, config=config, mix=mix,
                metrics=cell_metrics(bench, name, trace), chips=w["chips"])


def reader(metric: str):
    """The reader of a metric: ``metrics/<name>.py``, where the name is the
    metric's up to its first dot (``mfu.open`` and ``mfu.closed`` share
    ``metrics/mfu.py``)."""
    path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Rec:
    """A request's record on the host clock."""
    req: object
    due: float
    admit_t: Optional[float] = None
    seat_round: Optional[int] = None
    first_t: Optional[float] = None
    last_t: Optional[float] = None
    n: int = 0                  # sampled tokens delivered so far


class Driver:
    """Drives the batcher round by round and keeps the record."""

    def __init__(self, srv, cfg: dict, mix: dict, draws, sync: bool,
                 sampler=None):
        self.srv, self.cfg, self.mix, self.draws = srv, cfg, mix, draws
        self.K = srv.K
        self.sync = sync
        self.sampler = sampler
        self.recs: Dict[int, Rec] = {}
        self.open: List[Rec] = []       # not finished
        self.round = 0
        self.rounds: List[dict] = []    # the window's rounds
        self.in_window = False
        self.next_req = 0
        self._mega_s = 0.0
        self._p01 = None
        mega, absorb = srv.mega_fn, srv._absorb
        dev = srv.device

        def timed_mega(*a, **kw):
            t0 = time.perf_counter()
            out = mega(*a, **kw)
            if self.sync:
                torch.cuda.synchronize(dev)
            self._mega_s += time.perf_counter() - t0
            return out

        def recorded_absorb(toks, p0, p1):
            self._p01 = (np.array(p0), np.array(p1))
            return absorb(toks, p0, p1)

        srv.mega_fn, srv._absorb = timed_mega, recorded_absorb

    def submit(self, due: float) -> None:
        i = self.next_req
        if i >= len(self.draws):
            raise RuntimeError("the mix ran out of requests: raise its "
                               "'requests'")
        req = port.request(i, self.draws[i])
        self.srv.sched.submit(req)
        rec = Rec(req=req, due=due)
        self.recs[i] = rec
        self.open.append(rec)
        self.next_req += 1

    def step(self):
        srv = self.srv
        self._mega_s = 0.0
        sampled = (self.in_window and self.sampler is not None
                   and self.sampler.before_round())
        syncs0 = port.counters()["host_syncs"]
        t0 = time.perf_counter()
        plan = srv.step_round()
        t1 = time.perf_counter()
        if sampled:
            self.sampler.after_round()
        self.round += 1
        for _, req in plan.admissions:
            rec = self.recs[req.req_id]
            rec.seat_round = self.round
            if rec.admit_t is None:
                rec.admit_t = t1
        delivered, got, still = 0, [], []
        for rec in self.open:
            n = len(rec.req.sampled)
            if n > rec.n:
                delivered += n - rec.n
                got.append((rec, n - rec.n))
                if rec.first_t is None:
                    rec.first_t = t1
                rec.last_t, rec.n = t1, n
            if not rec.req.done:
                still.append(rec)
        self.open = still
        if self.in_window:
            p0, p1 = self._p01
            self.rounds.append(dict(
                t0=t0, t1=t1, mega_s=self._mega_s, p0=p0, p1=p1,
                sampled=sampled,
                delivered=delivered, got=got,
                syncs=port.counters()["host_syncs"] - syncs0,
                keys_probed=srv.sched.rounds[-1].keys_probed))
        return plan

    def run_open(self, t_origin: float, warmup_s: float, seconds: float,
                 on_window):
        """Open loop: each request is submitted at the first round start
        at or after its due time; the window opens at the first round
        start past the warm-up and closes at the first one past its
        length.  The arrival clock and the window's end stand still while
        a traced run opens or closes a sample (``stolen``), so that a
        traced run offers the load of a timed one."""
        dues = t_origin + np.array([d.due_s for d in self.draws])
        ws = None
        while True:
            t = time.perf_counter() - self.stolen()
            if ws is None and t >= t_origin + warmup_s:
                on_window()
                ws = t = time.perf_counter()
            if ws is not None and t >= ws + seconds:
                break
            while (self.next_req < len(dues)
                   and dues[self.next_req] <= t):
                self.submit(float(dues[self.next_req]) + self.stolen())
            if self.srv.sched.drained:
                nxt = (dues[self.next_req] if self.next_req < len(dues)
                       else t + 0.05)
                stop = t_origin + warmup_s if ws is None else ws + seconds
                time.sleep(max(0.0, min(nxt, stop) - t))
                continue
            self.step()
        return ws

    def stolen(self) -> float:
        """Seconds the traced run's samples took to open and close."""
        return self.sampler.stolen if self.sampler is not None else 0.0

    def run_closed(self, warmup_rounds: int, seconds: float, on_window):
        """Closed loop: every lane seated at the start; a finished
        request's lane gets the next request the round after."""
        t = time.perf_counter()
        for _ in range(self.mix["lanes"]):
            self.submit(t)
        for _ in range(warmup_rounds):
            self._refill(self.step())
        on_window()
        ws = time.perf_counter()
        while time.perf_counter() - self.stolen() < ws + seconds:
            self._refill(self.step())
        return ws

    def _refill(self, plan):
        t = time.perf_counter()
        for _ in plan.finish_slots:
            self.submit(t)

    def snapshot(self) -> dict:
        """The allocator's state and the harness's record of the lanes,
        on the host."""
        st, srv = self.srv.state, self.srv
        held = np.array([r is not None for r in srv.sched.lanes])
        exp = np.zeros(len(held), np.int64)
        for s, r in enumerate(srv.sched.lanes):
            if r is not None:
                exp[s] = self.K * (self.round - self.recs[r.req_id]
                                   .seat_round)
        tab = st["table"]
        return dict(cells=tab.table.cpu().numpy(),
                    num_keys=int(tab.num_keys), num_tombs=int(tab.num_tombs),
                    table_seed=int(tab.seed),
                    block_table=st["block_table"].cpu().numpy(),
                    seq_ids=st["seq_ids"].cpu().numpy(),
                    pos=st["pos"].cpu().numpy(), held=held,
                    expected_pos=exp,
                    page_size=self.cfg["serving"]["page_size"])


def sampling(w, summary) -> dict:
    """What the samples cost: a token step's host time in the rounds
    inside the samples, and in those outside them before the first sample
    and after it (a timed run: every round, before)."""
    def ms(rounds):
        steps = w.K * len(rounds)
        return (sum(r["t1"] - r["t0"] for r in rounds) / steps * 1e3
                if steps else None)
    first = next((i for i, r in enumerate(w.rounds) if r["sampled"]),
                 len(w.rounds))
    return {"samples": summary["samples"] if summary else 0,
            "stolen_s": w.stolen_s,
            "rounds_sampled": sum(1 for r in w.rounds if r["sampled"]),
            "rounds": len(w.rounds),
            "ms_per_step_sampled": ms([r for r in w.rounds if r["sampled"]]),
            "ms_per_step_unsampled_before": ms(w.rounds[:first]),
            "ms_per_step_unsampled_after": ms(
                stats.unsampled(w.rounds[first:]))}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, hooks=None) -> dict:
    """One run.  Returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` when traced,
    ``checks``).  ``hooks`` lets a test break the program underneath."""
    cfg, mix = cell.config, cell.mix
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    draws = traffic.generate(mix, seed, cfg["vocab_size"])
    srv = port.batcher(cfg, mix, port.params(cfg, RW.draw(cfg, seed, dev)),
                       dev)
    if hooks:
        hooks(srv)
    sampler = devtrace.Sampler(srv, dev, cuda) if trace else None
    drv = Driver(srv, cfg, mix, draws, sync=trace and cuda, sampler=sampler)

    def on_window():
        if cuda:
            torch.cuda.synchronize(dev)
        if sampler is not None:
            sampler.start(time.perf_counter(), seconds)
        drv.in_window = True

    if mix["loop"] == "open":
        # one round with no request before the arrival clock starts: the
        # kernel library's first load (a build, in a fresh checkout) and
        # the first launches must not hold up arrivals already due
        srv.step_round()
        ws = drv.run_open(time.perf_counter(), float(mix["warmup_s"]),
                          seconds, on_window)
    else:
        ws = drv.run_closed(int(mix["warmup_rounds"]), seconds, on_window)
    if sampler is not None:
        sampler.close()
    if cuda:
        torch.cuda.synchronize(dev)
    we = drv.rounds[-1]["t1"] if drv.rounds else time.perf_counter()
    drv.in_window = False
    summary, spans = (sampler.summary() if sampler is not None
                      else (None, None))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    snap = drv.snapshot()
    pool = dict(pages=int(snap["cells"].size),
                live_pages_at_end=snap["num_keys"],
                bytes=int(sum(t.numel() * t.element_size()
                              for t in srv.state["pools"])))
    waiting = len(srv.sched.queue)
    served = [(r.req.prompt, np.asarray(r.req.sampled, np.int32))
              for r in drv.recs.values() if r.n > 0]
    finished = [r for r in drv.recs.values() if r.req.done]
    stops = [(len(r.req.sampled), min(r.req.total_len, mix["max_len"])
              - len(r.req.prompt)) for r in finished]
    window = types.SimpleNamespace(
        cfg=cfg, mix=mix, K=drv.K, ws=ws, we=we,
        seconds=seconds + drv.stolen(), stolen_s=drv.stolen(),
        setup_s=ws - t_process, rounds=drv.rounds,
        recs=list(drv.recs.values()),
        max_pages=-(-mix["max_len"] // cfg["serving"]["page_size"]),
        trace=summary, spans=spans,
        window_s=summary["window_s"] if summary is not None else None)
    # the program's state goes before the reference runs: the batcher's
    # wrappers hold it in a cycle
    del drv, srv, on_window, sampler, hooks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks = CK.judge(cfg, seed, dev, snap, served, stops)
    metrics = {}
    for m in cell.metrics:
        v = reader(m["name"])(window)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    due = [r for r in window.recs if ws <= r.due < ws + window.seconds]
    attempted = (len(due) if mix["loop"] == "open" else
                 sum(1 for r in window.recs if r.seat_round is not None))
    out = {"correct": checks["correct"], "attempted": attempted,
           "failed": checks["failed_requests"], "metrics": metrics,
           "device": {"platform": "gpu" if cuda else dev.type,
                      "kind": (torch.cuda.get_device_name(dev) if cuda
                               else dev.type),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if summary is not None:
        out["device"].update(busy_s=summary["busy_s"],
                             window_s=window.window_s)
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["requests"] = {"due_in_window": len(due),
                       "completed_in_window": sum(
                           1 for r in window.recs if r.req.done
                           and r.last_t is not None and ws <= r.last_t),
                       "submitted": len(window.recs),
                       "waiting_at_end": waiting}
    out["pool"] = pool
    out["sampling"] = sampling(window, summary)
    if spans is not None:
        out["spans"] = devtrace.costliest(spans)
    out["checks"] = checks["numbers"]
    return out
