"""Serving driver: continuous batching over the paged engine, scheduled by
``repro_torch.serving.sched`` (PyTorch port of ``launch/serve.py``).

The driver is thin: it owns the engine state and the megastep dispatch
(plus the reactive refused-suffix re-issue); every admit / evict / preempt
/ grow decision lives in the scheduler.  One round:

1. build the per-lane teacher-forcing arrays (chunked prefill shares the
   megastep budget with decode);
2. run ONE K-token megastep (``engine.make_serve_megastep``);
3. absorb the sampled tokens into their requests and, in verification
   mode, check the incremental block table against the wait-free lookup;
4. reactive safety net: if any lane ABORTed, rebuild into a 2x pool;
5. apply the scheduler's Plan: ``free_sequences`` + block-row
   invalidation for evicted lanes, ``rebuild_page_table`` for proactive
   growth, fresh sequence ids at position 0 for admissions, whose lanes'
   mamba state (the ssm and hybrid families) and ring buffers (gemma3's
   local layers) are reset first (``_reset_recurrent_state``).

The ssm family's state has no page table: every table step (block-table
checks, frees, grows, headroom, the trace's table health) is skipped for
it, as in the reference.  The batcher never runs the encoder: an encdec
state decodes over zero cross K/V unless the caller fills them
(``engine.prepare_encdec_state``), as in the reference.

Usage (GPU, qwen2.5-32b at full width, depth cut to 8 layers):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-32b \\
      --layers 8 --fused-kernel --batch 8 --max-len 1024 --page-size 16 \\
      --megastep 8 --requests 16 --verify-block-table --fail-on-abort
CPU smoke: add ``--smoke --device cpu``.  ``--probe-strategy
{linear,robinhood,hopscotch}`` picks the allocator.  ``--arch`` takes all
ten configs: dense, moe (``granite-moe-1b-a400m``,
``qwen3-moe-235b-a22b``), vlm (``qwen2-vl-7b``), gemma3 (``gemma3-12b``),
ssm (``mamba2-2.7b``), hybrid (``zamba2-1.2b``) and encdec
(``seamless-m4t-large-v2``).  gemma3's ``--layers`` must be a multiple of
its 6-layer superblock; zamba2's keeps the reference's grouping
(``layers // shared_attn_every`` shared-block invocations, then the
remaining mamba layers) and needs at least one group.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import os

import numpy as np
import torch

from repro_torch import obs as OBS
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import batched as BT
from repro_torch.device import host_int, host_numpy, resolve_device, to_card
from repro_torch.models.registry import get_model
from repro_torch.obs.trace import (record_spans, span, summarize,
                                   write_chrome_trace)
from repro_torch.serving import engine as EG
from repro_torch.serving import page_table as PT
from repro_torch.serving.sched import (Scheduler, churn_request,
                                       synthetic_workload)

logger = logging.getLogger(__name__)


class ContinuousBatcher:
    """Thin driver: B decode slots, one K-token megastep per round, all
    policy in ``scheduler``.  ``n_pages`` overcommits the page pool;
    ``auto_refill`` keeps an endless eviction-churn stream when no workload
    is submitted.  Runs on ``device`` (the card unless ``"cpu"``).

    With ``rules`` it runs SPMD on every rank of the bound mesh, on the
    rank's ``params`` pieces (``engine.mesh_param_specs``) and on the
    mesh's device.  Every rank runs the same scheduler, and each host
    decision reads only replicated values (the sampled tokens, positions,
    the table, ``aborted``, counters), so all ranks take the same branch
    and no collective is left waiting."""

    def __init__(self, cfg, params, *, batch: int, max_len: int,
                 page_size: int, rules=None, seed: int = 0,
                 megastep_k: int = 1, verify_block_table: bool = False,
                 scheduler: Scheduler | None = None,
                 n_pages: int | None = None, auto_refill: bool = True,
                 tracer: OBS.Tracer | None = None, device=None):
        self.cfg, self.params = cfg, params
        self.device = (resolve_device(device) if rules is None
                       else rules.mesh.device)
        self.B, self.max_len, self.page_size = batch, max_len, page_size
        self.K = max(1, int(megastep_k))
        self.verify = verify_block_table
        self.auto_refill = auto_refill
        self.strategy = getattr(cfg, "probe_strategy", "linear")
        self.pt = PT.for_strategy(self.strategy)
        self.state, _ = EG.make_decode_state(cfg, batch, S_max=max_len,
                                             rules=rules,
                                             page_size=page_size,
                                             n_pages=n_pages,
                                             device=self.device)
        self.state["active"] = torch.zeros((batch,), dtype=torch.bool,
                                           device=self.device)
        self.mega_fn = EG.make_serve_megastep(
            cfg, S_max=max_len, K=self.K, rules=rules, page_size=page_size)
        pool = EG.decode_headroom(self.state, strategy=self.strategy)
        self.sched = scheduler or Scheduler(
            slots=batch, page_size=page_size, max_len=max_len,
            megastep_k=self.K)
        self.sched.K = self.K
        self.sched.n_pages = None if pool is None else pool.n_pages
        self.tracer = tracer
        self.sched.tracer = tracer
        self.metrics = OBS.MetricsRegistry()
        self.metrics.source("fallback",
                            lambda: EG.fallback_report(cfg, rules))
        self.metrics.source("probe", lambda: dict(PT.PROBE_STATS))
        self._ctr_prev: dict = {}
        logger.info("engine fallback report: %s",
                    EG.fallback_report(cfg, rules))
        self.pos = np.zeros(batch, np.int32)
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32,
                                  device=self.device)
        self.next_seq_id = batch
        self.rng = np.random.default_rng(seed + 1)
        self._next_auto_id = 1 << 20          # ids disjoint from workloads
        self.lane_known = [np.zeros((0,), np.int32)] * batch
        self.lane_stop = np.zeros(batch, np.int32)

    def _t(self, a, dtype=None):
        return to_card(a, self.device, dtype)

    # -- compat conveniences ---------------------------------------------

    @property
    def evictions(self) -> int:
        return (self.sched.stats.completed
                + self.sched.stats.preemptive_evictions)

    @property
    def rebuilds(self) -> int:
        return (self.sched.stats.pool_grows
                + self.sched.stats.reactive_rebuilds)

    def table_stats(self):
        if "table" not in self.state:
            return None
        return self.pt.stats(self.state["table"])

    # -- the round --------------------------------------------------------

    def _check_block_table(self):
        mism = host_int(self.pt.verify_block_table(
            self.state["table"], self.state["seq_ids"],
            self._t(self.pos), self.state["block_table"],
            page_size=self.page_size))
        if mism:
            raise RuntimeError(
                f"block-table cache diverged from the wait-free lookup "
                f"({mism} entries) — invalidation/update invariant broken")

    def _refill(self):
        sch = self.sched
        deficit = self.B - len(sch.running()) - len(sch.queue)
        for _ in range(max(deficit, 0)):
            sch.submit(churn_request(self._next_auto_id, self.rng,
                                     vocab_size=self.cfg.vocab_size,
                                     max_len=self.max_len))
            self._next_auto_id += 1

    def _forcing(self):
        """Teacher-forcing arrays for this round (chunked prefill)."""
        B, K = self.B, self.K
        forced = np.zeros((B, K), np.int32)
        fmask = np.zeros((B, K), bool)
        for s, req in enumerate(self.sched.lanes):
            if req is None:
                continue
            known = self.lane_known[s]
            p0 = int(self.pos[s])
            for k in range(K):
                sp = p0 + k + 1
                if sp < known.size:
                    forced[s, k] = known[sp]
                    fmask[s, k] = True
        return forced, fmask

    def _absorb(self, toks: np.ndarray, p0: np.ndarray, p1: np.ndarray):
        """Fold the round's sampled tokens back into their requests."""
        clk = self.sched.clock
        for s, req in enumerate(self.sched.lanes):
            if req is None:
                continue
            nk = self.lane_known[s].size
            stop = int(self.lane_stop[s])
            for k in range(int(p1[s]) - int(p0[s])):
                sp = int(p0[s]) + k + 1
                if nk <= sp < stop:
                    req.sampled.append(int(toks[s, k]))
                    if req.first_token_at is None:
                        req.first_token_at = clk
                        self._emit("first_token", req=req.req_id)

    def _apply_plan(self, plan):
        st = self.sched
        evict = plan.evict_slots
        if evict and "table" in self.state:
            mask = np.zeros(self.B, bool)
            mask[evict] = True
            dmask = self._t(mask)
            maxP = -(-self.max_len // self.page_size)
            t_before = self.state["table"]
            self.state["table"] = self.pt.free_sequences(
                self.state["table"], self.state["seq_ids"],
                self._t(self.pos), page_size=self.page_size,
                max_pages=maxP, active=dmask)
            if "counters" in self.state:
                self.state["counters"] = OBS.note_free(
                    self.state["counters"], table_before=t_before,
                    table_after=self.state["table"])
            self.state["block_table"] = self.pt.invalidate_block_rows(
                self.state["block_table"], dmask)
        if evict:
            active = host_numpy(self.state["active"]).copy()
            active[evict] = False
            self.state["active"] = self._t(active)
        if plan.grow_to is not None and "table" in self.state:
            # proactive Section 4.3 rebuild, between megasteps
            with span("allocator.rebuild"):
                self.state = EG.rebuild_page_table(self.state,
                                                   n_pages=plan.grow_to,
                                                   strategy=self.strategy)
            self._emit("rebuild", reason="grow", n_pages=plan.grow_to)
        if plan.admissions:
            seq_ids = host_numpy(self.state["seq_ids"]).copy()
            active = host_numpy(self.state["active"]).copy()
            aborted = host_numpy(self.state["aborted"]).copy()
            tokens = host_numpy(self.tokens).copy()
            self._reset_recurrent_state([s for s, _ in plan.admissions])
            for slot, req in plan.admissions:
                known = req.known_tokens()
                self.lane_known[slot] = known
                self.lane_stop[slot] = st.stop_of(req)
                seq_ids[slot] = self.next_seq_id
                self.next_seq_id += 1
                self.pos[slot] = 0
                active[slot] = True
                aborted[slot] = False
                tokens[slot, 0] = known[0]
                # fresh admissions start at pos 0 with no pages: the
                # invalidated (-1) block-table rows are the right cache
            self.state["seq_ids"] = self._t(seq_ids)
            self.state["active"] = self._t(active)
            self.state["aborted"] = self._t(aborted)
            self.state["pos"] = self._t(self.pos)
            self.tokens = self._t(tokens)

    def _reset_recurrent_state(self, slots):
        """Reset the admitted lanes' per-lane state to what a fresh
        ``make_decode_state`` holds: the mamba state (``h`` and the conv
        tails, zeroed on their batch dim 1) and the ring buffers of
        gemma3's local layers (K/V zero, ``ring_pos`` -1).  Paged KV needs
        nothing (freed pages are unreachable once the block-table rows are
        invalidated).  The mamba recurrence carries the previous
        occupant's history into every later token, so without the reset
        the re-seated request decodes wrongly.  A ring entry of the
        previous occupant cannot pass the attention mask (slot s holds a
        position q = s mod W, and every stale q is refused); the ring
        reset keeps ``ring_pos`` equal to the reference's."""
        self.state = EG.reset_lanes(self.state, slots)

    def _emit(self, event: str, **fields):
        if self.tracer is not None:
            self.tracer.emit(event, self.sched.clock, **fields)

    def _emit_decode(self, p0: np.ndarray, p1: np.ndarray):
        reqs = [r.req_id for r in self.sched.lanes if r is not None]
        if self.tracer is None or not reqs:
            return
        ps = self.page_size
        pages = 0
        for s, r in enumerate(self.sched.lanes):
            if r is None:
                continue
            pages += sum(1 for p in range(int(p0[s]), int(p1[s]))
                         if p % ps == 0)
        self._emit("decode", reqs=reqs,
                   tokens=int((p1 - p0).sum()), pages=pages)

    def _read_counters(self):
        if "counters" not in self.state:
            return None
        snap = OBS.snapshot(self.state["counters"])
        d = OBS.delta(snap, self._ctr_prev)
        self._ctr_prev = snap
        for k, v in d.items():
            if v:
                self.metrics.inc(k, v)
        return d

    def step_round(self):
        """One scheduled megastep round (K tokens per occupied lane): the
        span ``batcher.round``, which carries the clock of the round's
        Tracer events (the clock after its K steps)."""
        with span("batcher.round", clock=self.sched.clock + self.K):
            return self._round()

    def _round(self):
        if self.auto_refill:
            self._refill()
        with PT.probe_stats_scope() as ps:
            with span("batcher.forcing"):
                forced, fmask = self._forcing()
            p0 = self.pos.copy()
            toks, self.state = self.mega_fn(
                self.params, self.state, self.tokens,
                self._t(self.lane_stop), self._t(forced), self._t(fmask))
            self.tokens = toks[:, -1:]
            self.pos = host_numpy(self.state["pos"]).copy()
            self.sched.advance(self.K)
            with span("batcher.absorb"):
                self._absorb(host_numpy(toks), p0, self.pos)
            self._emit_decode(p0, self.pos)
            if self.verify and "table" in self.state:
                self._check_block_table()
            n_ab = host_int(self.state["aborted"].sum())
            if n_ab:
                # reactive safety net: grow the pool, re-hash, move the KV
                # pages, rebuild the block table, clear the flags; the
                # refused suffix re-issues at the frozen positions
                n_pages = BT.size(self.state["table"])
                with span("allocator.rebuild"):
                    self.state = EG.rebuild_page_table(
                        self.state, n_pages=n_pages * 2,
                        strategy=self.strategy)
                self.sched.note_aborts(n_ab, grew_to=n_pages * 2)
                self._emit("rebuild", reason="reactive",
                           n_pages=n_pages * 2)
            pool = EG.decode_headroom(self.state, strategy=self.strategy)
            with span("scheduler.plan"):
                plan = self.sched.plan_round(self.pos, pool)
            with span("batcher.apply_plan"):
                self._apply_plan(plan)
            probed = ps["keys_probed"]
        self.metrics.inc("keys_probed", probed)
        ctr = self._read_counters()
        if pool is not None:
            self.metrics.set_gauge("live_pages", pool.live_pages)
            self.metrics.set_gauge("tombstones", pool.tombstones)
            self.metrics.set_gauge("free_cells", pool.free_cells)
            self.metrics.set_gauge("occupancy", pool.occupancy)
        if self.tracer is not None:
            health = None
            if "table" in self.state:
                t = self.state["table"]
                n = BT.size(t)
                live, tombs = host_int(t.num_keys), host_int(t.num_tombs)
                health = {
                    "live": live, "tombs": tombs, "n_cells": n,
                    "free": n - live, "tomb_density": tombs / max(n, 1),
                    "occupancy": (live + tombs) / max(n, 1),
                    "probe_p99": PT.PageTable.probe_p99(t),
                    "migrated": 0, "migration_left": 0}
            self._emit("round", counters=ctr, health=health,
                       keys_probed=probed)
        self.sched.end_round(keys_probed=probed)
        return plan

    def decode_round(self, steps: int):
        """Drive ~``steps`` decode steps (ceil(steps / K) rounds)."""
        for _ in range(-(-steps // self.K)):
            self.step_round()

    def run_until_drained(self, max_rounds: int = 1000) -> bool:
        """Run until every submitted request completed (requires
        ``auto_refill=False``).  Returns True when drained."""
        for _ in range(max_rounds):
            if self.sched.drained:
                return True
            self.step_round()
        return self.sched.drained

    # -- telemetry exporters ----------------------------------------------

    def metrics_text(self) -> str:
        return self.metrics.prometheus_text()

    def metrics_json(self) -> str:
        return self.metrics.json_snapshot()

    def emit_summary(self):
        self._emit("summary", **self.sched.summary())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-32b", choices=sorted(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0 = the config's)")
    ap.add_argument("--fused-kernel", action="store_true",
                    help="decode attention through the fused kernel "
                         "(cfg.fused_kernel)")
    ap.add_argument("--rounds", type=int, default=6,
                    help="print intervals (endless churn) or max run length"
                         " x steps-per-round (fixed workload)")
    ap.add_argument("--steps-per-round", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--megastep", type=int, default=4,
                    help="tokens per dispatch (K of make_serve_megastep)")
    ap.add_argument("--policy", default="fcfs",
                    choices=["fcfs", "priority", "deadline"])
    ap.add_argument("--requests", type=int, default=0,
                    help="fixed synthetic workload size (0 = endless churn)")
    ap.add_argument("--arrival-every", type=int, default=0)
    ap.add_argument("--slo-fraction", type=float, default=0.5)
    ap.add_argument("--overcommit", type=float, default=1.0,
                    help="pool size factor vs the worst-case plan")
    ap.add_argument("--no-proactive", action="store_true")
    ap.add_argument("--fail-on-abort", action="store_true")
    ap.add_argument("--verify-block-table", action="store_true")
    ap.add_argument("--probe-strategy", default="linear",
                    choices=["linear", "robinhood", "hopscotch"],
                    help="page-allocator probe strategy (cfg.probe_strategy;"
                         " hopscotch = tombstone-free deletes + scheduler "
                         "slack, see core/probe_strategies.py)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry", action="store_true")
    ap.add_argument("--trace", default=None, metavar="PATH")
    ap.add_argument("--metrics-out", default=None, metavar="PREFIX")
    ap.add_argument("--spans-out", default=None, metavar="PATH",
                    help="record the serving path's layer spans over the "
                         "rounds and write them as Chrome-trace JSON "
                         "(Perfetto)")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    over = {}
    if args.layers:
        over["num_layers"] = args.layers
        if cfg.layer_types:       # the first layers of the stack
            over["layer_types"] = cfg.layer_types[:args.layers]
    if args.fused_kernel:
        over["fused_kernel"] = True
    if args.telemetry:
        over["telemetry"] = True
    if args.probe_strategy != cfg.probe_strategy:
        over["probe_strategy"] = args.probe_strategy
    cfg = dataclasses.replace(cfg, **over)
    try:
        model = get_model(cfg)
    except ValueError as e:   # a depth off gemma3's superblocks, or a
        # hybrid below one group or without an attention layer
        ap.error(str(e))
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(cfg, gen, device)

    maxP = -(-args.max_len // args.page_size)
    default_pool = int(args.batch * maxP * 1.25) + 1
    n_pages = max(maxP, int(default_pool * args.overcommit))
    sched = Scheduler(slots=args.batch, page_size=args.page_size,
                      max_len=args.max_len, megastep_k=args.megastep,
                      policy=args.policy,
                      proactive=not args.no_proactive)
    fixed = args.requests > 0
    tracer = OBS.Tracer(args.trace) if args.trace else None
    srv = ContinuousBatcher(cfg, params, batch=args.batch,
                            max_len=args.max_len, page_size=args.page_size,
                            megastep_k=args.megastep,
                            verify_block_table=args.verify_block_table,
                            scheduler=sched, n_pages=n_pages,
                            auto_refill=not fixed, seed=args.seed,
                            tracer=tracer, device=device)
    print(f"[serve] device {device} "
          f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}); "
          f"fallback report: {EG.fallback_report(cfg, None)}")
    if fixed:
        sched.submit_many(synthetic_workload(
            args.requests, vocab_size=cfg.vocab_size, max_len=args.max_len,
            seed=args.seed, slo_fraction=args.slo_fraction,
            arrival_every=args.arrival_every))

    with (record_spans() if args.spans_out
          else contextlib.nullcontext()) as spans:
        for r in range(args.rounds):
            srv.decode_round(args.steps_per_round)
            st = srv.table_stats()
            s = sched.stats
            occ = ("" if st is None else
                   f" live_pages={int(st.live_pages)} "
                   f"tombs={int(st.tombstones)} "
                   f"occupancy={float(st.occupancy):.3f}")
            print(f"[serve] round {r}: done={s.completed} "
                  f"preempted={s.preemptive_evictions} "
                  f"queue={len(sched.queue)} aborts={s.aborts} "
                  f"avoided={s.aborts_avoided} grows={s.pool_grows}{occ}")
            if fixed and sched.drained:
                break
    if args.spans_out:
        write_chrome_trace(spans, args.spans_out)
        top = sorted(summarize(spans).items(), key=lambda kv: -kv[1]["self_s"])
        print(f"[serve] spans: {args.spans_out} ({len(spans)} spans; most "
              "self time: " + ", ".join(f"{n} {d['self_s']:.3f} s"
                                        for n, d in top[:5]) + ")")

    summary = sched.summary()
    print(f"[serve] summary ({sched.policy.name}, "
          f"{'proactive' if sched.proactive else 'reactive'}): "
          + " ".join(f"{k}={v:.0f}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in summary.items()))
    if tracer is not None:
        srv.emit_summary()
        tracer.close()
        print(f"[serve] trace: {tracer.path} ({tracer.n_events} events)")
    if args.metrics_out:
        d = os.path.dirname(args.metrics_out)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.metrics_out + ".prom", "w") as f:
            f.write(srv.metrics_text())
        with open(args.metrics_out + ".json", "w") as f:
            f.write(srv.metrics_json())
        print(f"[serve] metrics: {args.metrics_out}.prom / .json")
    if fixed and not sched.drained:
        print("[serve] FAIL: workload not drained")
        return 1
    if args.fail_on_abort and sched.stats.aborts:
        print(f"[serve] FAIL: {sched.stats.aborts} allocator ABORT(s) "
              "surfaced (--fail-on-abort)")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
