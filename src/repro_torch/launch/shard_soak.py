"""Simulated multi-host soak of the sharded page table (the port's
counterpart of the reference's ``tests/_multihost.py`` harness).

One process plays N host groups: each owns one ``TableShard`` of a
``ShardedPageTable``, its slice of decode lanes and its per-shard
``Scheduler`` (through ``PrefixRouter``).  Rounds follow
``launch/serve.py``'s protocol — K virtual decode steps, then plan/apply —
against the routed allocator, with the model replaced by the virtual
clock: pages and admission behave exactly as in serving.

A **shadow page map** (global slot -> page key, plus per-sequence page
sets) is the oracle: every allocation must claim an unclaimed slot, every
migration move must relocate exactly the shadow's entry, every lookup must
land on a slot whose shadow content is the looked-up key, and per-shard
live counters must equal the shadow's census.

Events: ``--grow-round R`` forces a lazy resize of one shard at round R
(buckets then migrate under the storm); ``--lose-round R`` kills a host
group at round R (the manifest reassigns its prefixes and the router
re-homes its requests through recompute preemption).  The shards' tables
live on ``--device`` (the card unless ``cpu``)::

    PYTHONPATH=src python -m repro_torch.launch.shard_soak --hosts 4 \\
        --requests 48 --overcommit 2.0 --lose-round 6 --grow-round 3 \\
        --fail-on-abort [--strategy hopscotch] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving import page_table as PT
from repro_torch.serving.sched import Request, synthetic_workload
from repro_torch.serving.sched.forecast import pages_held
from repro_torch.serving.sched.router import PrefixRouter
from repro_torch.serving.sharded_table import ShardedPageTable


class ShadowPages:
    """The oracle: who owns which global slot, kept from the same alloc /
    move / free stream the pools would consume."""

    def __init__(self):
        self.slot_key: Dict[int, int] = {}              # global slot -> key
        # seq -> {logical page: slot}
        self.seq_pages: Dict[int, Dict[int, int]] = {}

    def alloc(self, seq: int, logical: int, slot: int) -> None:
        key = seq * PT.MAX_LOGICAL_PAGES + logical
        prev = self.slot_key.get(slot)
        assert prev is None or prev == key, \
            f"slot {slot} double-claimed: {prev} vs ({seq},{logical})"
        self.slot_key[slot] = key
        self.seq_pages.setdefault(seq, {})[logical] = slot

    def move(self, src: int, dst: int) -> None:
        key = self.slot_key.pop(src)
        assert dst not in self.slot_key, f"move onto live slot {dst}"
        self.slot_key[dst] = key
        seq, logical = divmod(key, PT.MAX_LOGICAL_PAGES)
        self.seq_pages[seq][logical] = dst

    def free_seq(self, seq: int) -> int:
        pages = self.seq_pages.pop(int(seq), {})
        for slot in pages.values():
            del self.slot_key[slot]
        return len(pages)

    def census(self) -> int:
        return len(self.slot_key)


class SimHost:
    """One simulated host group: a shard's decode lanes."""

    def __init__(self, sid: int, slots: int):
        self.sid = sid
        self.seq = np.zeros(slots, np.uint32)
        self.pos = np.zeros(slots, np.int64)
        self.stop = np.zeros(slots, np.int64)   # lane target length
        self.active = np.zeros(slots, bool)


class SimCluster:
    """N simulated hosts over one ShardedPageTable + PrefixRouter."""

    def __init__(self, *, hosts: int, pages_per_shard: int,
                 slots_per_shard: int, page_size: int = 4,
                 max_len: int = 32, megastep_k: int = 4,
                 strategy: str = "linear", fail_on_abort: bool = False,
                 verbose: bool = False, device=None):
        max_pages = -(-max_len // page_size)
        self.spt = ShardedPageTable(hosts, pages_per_shard,
                                    strategy=strategy, page_size=page_size,
                                    max_pages=max_pages, device=device)
        self.router = PrefixRouter(self.spt, slots_per_shard=slots_per_shard,
                                   max_len=max_len, megastep_k=megastep_k,
                                   proactive=True, allow_grow=True)
        self.hosts: Dict[int, SimHost] = {
            sid: SimHost(sid, slots_per_shard)
            for sid in self.spt.live_shards()}
        self.K = megastep_k
        self.page_size = page_size
        self.shadow = ShadowPages()
        self.aborts = 0
        self.rounds_run = 0
        self.verifies = 0
        self.migrations_finished = 0
        self.fail_on_abort = fail_on_abort
        self.verbose = verbose

    # -- lane views --------------------------------------------------------

    def _gather(self):
        """Concatenate every live host's lanes (order = live_shards)."""
        sids = list(self.hosts)
        seq = np.concatenate([self.hosts[s].seq for s in sids])
        pos = np.concatenate([self.hosts[s].pos for s in sids])
        stop = np.concatenate([self.hosts[s].stop for s in sids])
        act = np.concatenate([self.hosts[s].active for s in sids])
        return sids, seq, pos, stop, act

    def _scatter_pos(self, sids, pos) -> None:
        off = 0
        for s in sids:
            n = self.hosts[s].pos.size
            self.hosts[s].pos[:] = pos[off:off + n]
            off += n

    def _moved(self, moves) -> None:
        for src, dst in moves:
            self.shadow.move(src, dst)

    def _count_finished(self, before) -> None:
        """Count the migrations in flight in ``before`` that have finished
        (on access or by the sweep) on a shard still live."""
        live = set(self.spt.live_shards())
        self.migrations_finished += sum(
            1 for sid in before
            if sid in live and not self.spt.shard(sid).migrating)

    # -- the round ---------------------------------------------------------

    def decode_substeps(self) -> None:
        """K virtual decode steps: page-boundary allocations through the
        routed table; every write slot is checked against the shadow."""
        for _ in range(self.K):
            sids, seq, pos, stop, act = self._gather()
            # lanes at their stop idle until the planner reaps them
            run = act & (pos < stop)
            before = self.spt.migrating()
            if run.any():
                ws, ab, moves = self.spt.alloc_step(seq, pos, active=run)
                self._moved(moves)
                n_ab = int(ab.sum())
                if n_ab:
                    self.aborts += n_ab
                    if self.fail_on_abort:
                        raise AssertionError(
                            f"proactive-path ABORT on lanes "
                            f"{np.nonzero(ab)[0].tolist()} at round "
                            f"{self.rounds_run}")
                live = run & ~ab
                assert (ws[live] >= 0).all(), "live lane denied a write slot"
                assert np.unique(ws[live]).size == int(live.sum()), \
                    "two lanes share a physical page"
                boundary = live & (pos % self.page_size == 0)
                for i in np.nonzero(boundary)[0]:
                    self.shadow.alloc(int(seq[i]),
                                      int(pos[i]) // self.page_size,
                                      int(ws[i]))
                self._scatter_pos(sids, pos + live.astype(np.int64))
            # migration makes progress every substep, like a helper thread
            self._moved(self.spt.service_migration())
            self._count_finished(before)

    def plan_and_apply(self) -> None:
        self.router.advance(self.K)
        for sid, sc in self.router.scheds.items():
            host = self.hosts[sid]
            for s, r in enumerate(sc.lanes):
                if (r is not None and r.first_token_at is None
                        and host.pos[s] > getattr(r, "_prefill_len", 0)):
                    r.first_token_at = sc.clock
        positions = {sid: self.hosts[sid].pos for sid in self.hosts}
        plans = self.router.plan_round(positions)
        for sid, plan in plans.items():
            host = self.hosts[sid]
            if plan.evict_slots:
                idx = np.asarray(plan.evict_slots)
                before = self.spt.migrating()
                self._moved(self.spt.free_sequences(
                    host.seq[idx], host.pos[idx], active=host.active[idx]))
                self._count_finished(before)
                for s in plan.evict_slots:
                    if host.active[s]:
                        self.shadow.free_seq(int(host.seq[s]))
                    host.active[s] = False
            for slot, req in plan.admissions:
                host.seq[slot] = self.router.seq_of[req.req_id]
                host.pos[slot] = 0
                host.stop[slot] = self.router.scheds[sid].stop_of(req)
                host.active[slot] = True
        self.router.end_round()

    def run_round(self) -> None:
        self.decode_substeps()
        self.plan_and_apply()
        self.rounds_run += 1

    # -- events ------------------------------------------------------------

    def force_grow(self, sid: Optional[int] = None, factor: int = 2) -> int:
        """Begin a lazy resize of one stable shard (first live by
        default)."""
        cands = [s for s in self.spt.live_shards()
                 if not self.spt.shard(s).migrating]
        if not cands:
            return -1
        sid = cands[0] if sid is None or sid not in cands else sid
        self.spt.grow_shard(sid, self.spt.shard(sid).n_cells() * factor)
        self.router.scheds[sid].n_pages = self.spt.headroom(sid).n_pages
        return sid

    def lose_host(self, sid: Optional[int] = None) -> int:
        """Kill a host group: shard + pages + lanes vanish; the router
        re-homes its requests (recompute preemption)."""
        live = self.spt.live_shards()
        if len(live) < 2:
            raise RuntimeError("cannot lose the last host")
        sid = live[-1] if sid is None else sid
        host = self.hosts.pop(sid)
        for s in np.nonzero(host.active)[0]:
            self.shadow.free_seq(int(host.seq[s]))  # pages died with host
        victims = self.router.lose_host(sid)
        if self.verbose:
            print(f"  [round {self.rounds_run}] lost host {sid}: "
                  f"{len(victims)} requests re-homed to "
                  f"{self.spt.manifest.live_shards()}")
        return len(victims)

    # -- verification ------------------------------------------------------

    def verify(self) -> None:
        """Shadow vs table, per-shard counters, lookup answers."""
        self.verifies += 1
        assert self.spt.total_live_pages() == self.shadow.census(), \
            (self.spt.counters(), self.shadow.census())
        for sid, host in self.hosts.items():
            held = sum(pages_held(int(p), self.page_size)
                       for p, a in zip(host.pos, host.active) if a)
            live = self.spt.shard(sid).live_pages()
            assert live == held, (sid, live, held, self.spt.counters())
        sids, seq, pos, stop, act = self._gather()
        if not act.any():
            return
        bt = self.spt.lookup_pages(seq[act], pos[act])
        for row, (s, p) in enumerate(zip(seq[act], pos[act])):
            held = pages_held(int(p), self.page_size)
            for logical in range(bt.shape[1]):
                g = int(bt[row, logical])
                if logical < held:
                    key = int(s) * PT.MAX_LOGICAL_PAGES + logical
                    assert g >= 0 and self.shadow.slot_key[g] == key, \
                        (int(s), logical, g)
                else:
                    assert g == -1

    # -- the storm ---------------------------------------------------------

    def run_storm(self, requests: List[Request], *, max_rounds: int = 400,
                  grow_round: Optional[int] = None,
                  lose_round: Optional[int] = None,
                  verify_every: int = 2) -> Dict[str, float]:
        self.router.submit_many(requests)
        while not self.router.drained:
            if self.rounds_run >= max_rounds:
                raise AssertionError(
                    f"storm did not drain in {max_rounds} rounds: "
                    f"{self.router.summary()}")
            if grow_round is not None and self.rounds_run == grow_round:
                self.force_grow()
            if lose_round is not None and self.rounds_run == lose_round:
                self.lose_host()
            self.run_round()
            if self.rounds_run % verify_every == 0:
                self.verify()
        self.verify()
        s = self.router.summary()
        s["rounds"] = self.rounds_run
        s["aborts_observed"] = self.aborts
        s["live_shards"] = len(self.spt.live_shards())
        s["migrations_finished"] = self.migrations_finished
        s["migrating_at_end"] = len(self.spt.migrating())
        s["verifies"] = self.verifies
        return s


def storm_workload(*, hosts: int, pages_per_shard: int, page_size: int,
                   max_len: int, requests: int, overcommit: float,
                   seed: int) -> List[Request]:
    """The soak's workload, sized to ``overcommit`` x the total pool:
    page demand of the whole workload vs every shard's capacity."""
    cap = hosts * pages_per_shard
    per_req = -(-max_len // page_size)   # worst case: a request at max_len
    n_req = max(requests, int(overcommit * cap / per_req))
    return synthetic_workload(n_req, vocab_size=256, max_len=max_len,
                              seed=seed, prompt_len=(2, 5),
                              max_new=(max_len - 8, max_len - 4))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--pages-per-shard", type=int, default=48)
    ap.add_argument("--slots-per-shard", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=32)
    ap.add_argument("--megastep-k", type=int, default=4)
    ap.add_argument("--strategy", default="linear",
                    choices=["linear", "robinhood", "hopscotch"])
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--overcommit", type=float, default=2.0)
    ap.add_argument("--grow-round", type=int, default=None)
    ap.add_argument("--lose-round", type=int, default=None)
    ap.add_argument("--max-rounds", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-on-abort", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the shards' tables (default: the "
                         "CUDA card)")
    args = ap.parse_args(argv)

    wl = storm_workload(hosts=args.hosts,
                        pages_per_shard=args.pages_per_shard,
                        page_size=args.page_size, max_len=args.max_len,
                        requests=args.requests, overcommit=args.overcommit,
                        seed=args.seed)
    cluster = SimCluster(
        hosts=args.hosts, pages_per_shard=args.pages_per_shard,
        slots_per_shard=args.slots_per_shard, page_size=args.page_size,
        max_len=args.max_len, megastep_k=args.megastep_k,
        strategy=args.strategy, fail_on_abort=args.fail_on_abort,
        verbose=True, device=args.device)
    print(f"shard-soak: hosts={args.hosts} pages/shard="
          f"{args.pages_per_shard} requests={len(wl)} "
          f"(overcommit~{args.overcommit}) K={args.megastep_k} "
          f"strategy={args.strategy} device={cluster.spt.device}")
    s = cluster.run_storm(wl, max_rounds=args.max_rounds,
                          grow_round=args.grow_round,
                          lose_round=args.lose_round)
    print(f"  drained in {int(s['rounds'])} rounds: completed="
          f"{int(s['completed'])}/{int(s['submitted'])} "
          f"rehomed={int(s['rehomed'])} preempt="
          f"{int(s['preemptive_evictions'])} grows={int(s['pool_grows'])} "
          f"migrations_finished={int(s['migrations_finished'])} "
          f"aborts={int(s['aborts_observed'])} "
          f"avoided={int(s['aborts_avoided'])} "
          f"ttft_p99={s['ttft_p99']:.0f} steps")
    ok = int(s["completed"]) == int(s["submitted"])
    if not ok:
        print("FAIL: lost requests", file=sys.stderr)
    if args.fail_on_abort and cluster.aborts:
        print(f"FAIL: {cluster.aborts} proactive-path aborts",
              file=sys.stderr)
        ok = False
    print("shard-soak OK" if ok else "shard-soak FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
