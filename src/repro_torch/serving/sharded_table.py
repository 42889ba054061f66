"""The serving-facing routing layer over the sharded page table (PyTorch
port of ``serving/sharded_table.py``).

``ShardedPageTable`` holds one ``dist.table_shard.TableShard`` per host
group and the prefix manifest that routes every operation to its owner.

**Routing unit = the sequence.**  ``page_key = seq_id * MAX_LOGICAL_PAGES
+ logical_page`` puts the sequence id in the key's top bits, so sharding
by a hash prefix of the sequence id pins every page of a sequence to one
shard, and admission is gated by that shard's ``Headroom`` alone
(``serving/sched/router.PrefixRouter``).

**Global slot space.**  Each table gets a contiguous region ``[start,
start + m)`` of one global slot space; a migrating shard owns two regions
(old and new) and every migration step returns its page moves as global
(src, dst) pairs.  The global space only grows (retired old regions are
not compacted), so every outstanding block-table entry stays valid.

**Elasticity.**  ``lose_shard`` drops a host group's tables and pages; the
manifest hands its prefixes to the survivors and the router re-admits the
lost lanes through recompute preemption.

**Checkpoints.**  ``checkpoint_sharded`` writes each live shard's live key
set through ``training/checkpoint.save_shard`` and commits the routing
manifest; ``restore_sharded_table`` re-homes every saved key onto any
shard count.

Everything here is host-driven eager PyTorch between megasteps, with the
shards' tables on ``device`` (the card unless ``"cpu"``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import batched as BT
from repro_torch.device import host_int, host_numpy, resolve_device
from repro_torch.dist import table_shard as TS
from repro_torch.serving import page_table as PT
from repro_torch.training import checkpoint as CKPT


def _page_keys(seq_ids, logical) -> np.ndarray:
    """``page_key`` on host arrays (int64 holding uint32 values)."""
    return PT.page_key(torch.from_numpy(np.asarray(seq_ids, np.int64)),
                       torch.from_numpy(np.asarray(logical, np.int64))
                       ).numpy()


@dataclasses.dataclass(frozen=True)
class Region:
    """Global slot range backing one table: local cell i -> start + i."""
    start: int
    size: int

    def lift(self, local_slots: np.ndarray) -> np.ndarray:
        return np.where(local_slots >= 0, local_slots + self.start, -1)


@dataclasses.dataclass
class _ShardState:
    shard: TS.TableShard
    cur: Region                      # region of shard.table
    old: Optional[Region] = None     # region of shard.old while migrating


class ShardedPageTable:
    """Hash-prefix-sharded page table with per-shard headroom, lazy
    incremental resize and elastic shard loss.  A mutable host object;
    the tables live inside the shards."""

    def __init__(self, n_shards: int, pages_per_shard: int, *,
                 strategy: str = "linear",
                 prefix_bits: int = TS.DEFAULT_PREFIX_BITS,
                 page_size: int = 16, max_pages: int = 64, seed: int = 0,
                 device=None):
        self.strategy = strategy
        self.page_size = page_size
        self.max_pages = max_pages
        self.device = resolve_device(device)
        self._pt = PT.for_strategy(strategy)
        self.manifest = TS.ShardManifest.balanced(n_shards, prefix_bits)
        self._shards: Dict[int, _ShardState] = {}
        self._next_start = 0
        for sid in range(n_shards):
            shard = TS.TableShard.create(sid, pages_per_shard,
                                         seed=seed + sid, strategy=strategy,
                                         device=self.device)
            self._shards[sid] = _ShardState(shard,
                                            self._claim(pages_per_shard))

    def _claim(self, size: int) -> Region:
        r = Region(self._next_start, size)
        self._next_start += size
        return r

    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(self.device)

    # -- topology --------------------------------------------------------

    @property
    def n_slots(self) -> int:
        """Extent of the global slot space (monotone)."""
        return self._next_start

    def live_shards(self) -> Tuple[int, ...]:
        return tuple(sorted(self._shards))

    def shard(self, sid: int) -> TS.TableShard:
        return self._shards[sid].shard

    def owner_of_seq(self, seq_ids) -> np.ndarray:
        return self.manifest.owner_of_seq(seq_ids)

    # -- per-shard headroom (the admission controller's input) -----------

    def headroom(self, sid: int) -> PT.Headroom:
        """The owner shard's ``Headroom``; during a migration
        ``free_cells = m_new - live_new - live_old`` keeps ``demand +
        safety + slack <= free_cells`` a no-ABORT proof through the
        resize."""
        st = self._shards[sid]
        m = BT.size(st.shard.table)
        live = st.shard.live_pages()
        tombs = host_int(st.shard.table.num_tombs)
        if st.shard.old is not None:
            tombs += host_int(st.shard.old.num_tombs)
        return PT.Headroom(
            n_pages=m, live_pages=live, tombstones=tombs,
            free_cells=st.shard.free_cells(),
            live_fraction=live / max(m, 1),
            occupancy=(live + tombs) / max(m, 1),
            strategy=self.strategy,
            slack=self._pt.forecast_slack(m))

    # -- routed operations ------------------------------------------------

    def _route(self, seq_ids, active: np.ndarray
               ) -> List[Tuple[int, np.ndarray]]:
        """(shard_id, lane mask) per live shard with active lanes; lanes
        whose owner is dead (mid-recovery) are dropped."""
        owners = self.manifest.owner_of_seq(np.asarray(seq_ids))
        out = []
        for sid in self.live_shards():
            mask = (owners == sid) & active
            if mask.any():
                out.append((sid, mask))
        return out

    def _lift(self, st: _ShardState, slots, in_old) -> np.ndarray:
        """Local find result -> global slots via the owning region."""
        slots = host_numpy(slots)
        g = st.cur.lift(slots)
        if st.old is not None:
            g = np.where(host_numpy(in_old), st.old.lift(slots), g)
        return g

    def alloc_step(self, seq_ids, positions, *, active=None
                   ) -> Tuple[np.ndarray, np.ndarray, List[Tuple[int, int]]]:
        """Routed per-step allocation: each lane's page-boundary crossing
        inserts into its owner shard; every live lane's current page slot
        is read back.  Returns (global write_slot int32[B] — -1 refusal,
        aborted bool[B], page moves [(src_global, dst_global)])."""
        seq_ids = np.asarray(seq_ids)
        positions = np.asarray(positions)
        B = positions.shape[0]
        act = (np.ones(B, bool) if active is None
               else np.asarray(active, bool))
        write_slot = np.full(B, -1, np.int32)
        aborted = np.zeros(B, bool)
        moves: List[Tuple[int, int]] = []
        keys_all = _page_keys(seq_ids, positions // self.page_size)
        need_new_all = ((positions % self.page_size) == 0) & act
        for sid, mask in self._route(seq_ids, act):
            st = self._shards[sid]
            keys = self._t(keys_all[mask])
            need = need_new_all[mask]
            shard, ret, mv = st.shard.insert(keys, active=self._t(need))
            moves += self._apply_moves(st, shard, mv)
            st.shard = shard
            ab = need & (host_numpy(ret) == 2)
            found, slots, in_old = shard.find(keys)
            g = self._lift(st, slots, in_old)
            g = np.where(host_numpy(found) & ~ab, g, -1)
            write_slot[mask] = g.astype(np.int32)
            aborted[mask] = ab
            PT._note_probes(int(need.sum()) + int(mask.sum()))
        return write_slot, aborted, moves

    def free_sequences(self, seq_ids, positions, *, active=None
                       ) -> List[Tuple[int, int]]:
        """Routed eviction: delete every page key of each sequence on its
        owner shard.  Returns any migrate-on-access page moves."""
        seq_ids = np.asarray(seq_ids)
        positions = np.asarray(positions)
        act = (np.ones(seq_ids.shape[0], bool) if active is None
               else np.asarray(active, bool))
        moves: List[Tuple[int, int]] = []
        logical = np.arange(self.max_pages, dtype=np.int64)
        for sid, mask in self._route(seq_ids, act):
            st = self._shards[sid]
            keys = _page_keys(seq_ids[mask, None],
                              logical[None, :]).reshape(-1)
            need = (logical[None, :] <=
                    positions[mask, None] // self.page_size).reshape(-1)
            shard, _, mv = st.shard.delete(self._t(keys),
                                           active=self._t(need))
            moves += self._apply_moves(st, shard, mv)
            st.shard = shard
            PT._note_probes(int(need.sum()))
        return moves

    def lookup_pages(self, seq_ids, positions) -> np.ndarray:
        """Routed wait-free block-table read: global physical slot of every
        logical page of every sequence (-1 absent / dead owner).
        int32[B, max_pages]."""
        seq_ids = np.asarray(seq_ids)
        positions = np.asarray(positions)
        B = seq_ids.shape[0]
        out = np.full((B, self.max_pages), -1, np.int32)
        logical = np.arange(self.max_pages, dtype=np.int64)
        for sid, mask in self._route(seq_ids, np.ones(B, bool)):
            st = self._shards[sid]
            keys = _page_keys(seq_ids[mask, None],
                              logical[None, :]).reshape(-1)
            found, slots, in_old = st.shard.find(self._t(keys))
            g = np.where(host_numpy(found),
                         self._lift(st, slots, in_old), -1)
            live = (logical[None, :] <=
                    positions[mask, None] // self.page_size)
            rows = g.reshape(-1, self.max_pages)
            out[mask] = np.where(live, rows, -1).astype(np.int32)
            PT._note_probes(int(mask.sum()) * self.max_pages)
        return out

    def insert_keys(self, keys) -> int:
        """Route raw page keys to their owners.  Returns the number
        inserted."""
        keys = np.asarray(keys).astype(np.int64)
        seqs = keys // PT.MAX_LOGICAL_PAGES
        n = 0
        for sid, mask in self._route(seqs, np.ones(keys.shape[0], bool)):
            st = self._shards[sid]
            shard, ret, mv = st.shard.insert(self._t(keys[mask]))
            self._apply_moves(st, shard, mv)
            st.shard = shard
            n += host_int((ret == 1).sum())
        return n

    # -- lazy incremental resize ------------------------------------------

    def grow_shard(self, sid: int, new_m: int) -> None:
        """Begin the lazy grow of one shard: O(1) now, buckets migrate
        under traffic (on access + ``service_migration`` sweeps); the
        shard's headroom jumps to the new capacity at once."""
        st = self._shards[sid]
        st.shard = st.shard.begin_migration(new_m)
        st.old = st.cur
        st.cur = self._claim(new_m)

    def service_migration(self, chunk: int = TS.MIGRATE_CHUNK
                          ) -> List[Tuple[int, int]]:
        """One bounded migration round across all migrating shards (once
        per serving round).  Returns global page moves to apply."""
        moves: List[Tuple[int, int]] = []
        for sid in self.live_shards():
            st = self._shards[sid]
            if not st.shard.migrating:
                continue
            shard, mv = st.shard.sweep_migrate(chunk)
            moves += self._apply_moves(st, shard, mv)
            st.shard = shard
        return moves

    def _apply_moves(self, st: _ShardState, shard: TS.TableShard,
                     mv: TS.MoveSet) -> List[Tuple[int, int]]:
        """Lift a MoveSet to global (src, dst) pairs; retire the old region
        when this step completed the migration."""
        out: List[Tuple[int, int]] = []
        if mv.n:
            assert st.old is not None
            src = st.old.lift(mv.old_slots)
            dst = st.cur.lift(mv.new_slots)
            out = list(zip(src.tolist(), dst.tolist()))
        if st.old is not None and not shard.migrating:
            st.old = None   # retired, not recycled (monotone space)
        return out

    def migrating(self) -> Tuple[int, ...]:
        return tuple(sid for sid in self.live_shards()
                     if self._shards[sid].shard.migrating)

    # -- elasticity --------------------------------------------------------

    def lose_shard(self, sid: int) -> TS.ShardManifest:
        """A host group dies with its tables and pages: reassign its
        prefix ranges to the survivors and return the new manifest."""
        if sid not in self._shards:
            raise KeyError(f"shard {sid} not live")
        del self._shards[sid]
        self.manifest = self.manifest.reassign(sid)
        return self.manifest

    # -- accounting --------------------------------------------------------

    def total_live_pages(self) -> int:
        return sum(st.shard.live_pages() for st in self._shards.values())

    def counters(self) -> Dict[int, Dict[str, int]]:
        """Per-shard counter snapshot for consistency checks."""
        out = {}
        for sid in self.live_shards():
            sh = self._shards[sid].shard
            mig, left = sh.migration_progress()
            out[sid] = {"live": sh.live_pages(),
                        "free": sh.free_cells(),
                        "n_cells": sh.n_cells(),
                        "migrated": mig, "migration_left": left}
        return out

    def health(self, sid: int) -> Dict[str, float]:
        """One shard's table-health gauge: tombstone density, probe-length
        p99 (over current + frozen-old cells during a migration) and the
        resize cursor's progress.  Host-side, report path only."""
        sh = self._shards[sid].shard
        mig, left = sh.migration_progress()
        n = sh.n_cells()
        tombs = host_int(sh.table.num_tombs)
        p99 = PT.PageTable.probe_p99(sh.table)
        if sh.old is not None:
            tombs += host_int(sh.old.num_tombs)
            p99 = max(p99, PT.PageTable.probe_p99(sh.old))
        live = sh.live_pages()
        return {"live": live, "tombs": tombs, "n_cells": n,
                "free": sh.free_cells(),
                "tomb_density": tombs / max(n, 1),
                "occupancy": (live + tombs) / max(n, 1),
                "probe_p99": p99,
                "migrated": mig, "migration_left": left}


# ---------------------------------------------------------------------------
# Sharded checkpointing (training/checkpoint.py format).  The table-layer
# payload per shard is its LIVE KEY SET: physical slots are not portable
# (the new job re-allocates pages and rebuilds block tables from the
# authoritative wait-free lookup, exactly as after a Section 4.3 rebuild),
# and the routing manifest rides in shards.json so restore can re-home
# every key onto a DIFFERENT shard count.


def checkpoint_sharded(spt: ShardedPageTable, ckpt_dir: str,
                       step: int) -> str:
    """Per-host shard writes + the manifest commit.  Returns the
    shards.json path (the commit point); safe to call again at the same
    step after the manifest changed (elastic remesh) — the re-commit
    replaces shards.json atomically."""
    for sid in spt.live_shards():
        sh = spt.shard(sid)
        live = []
        for ht in (sh.table, sh.old):
            if ht is not None:
                keys, n = BT.live_keys(ht)
                live.append(host_numpy(keys)[:host_int(n)])
        CKPT.save_shard(ckpt_dir, step, sid,
                        {"keys": np.concatenate(live).astype(np.uint32)},
                        extra={"strategy": spt.strategy,
                               "n_cells": sh.n_cells()})
    return CKPT.commit_sharded(
        ckpt_dir, step, shard_manifest=json.loads(spt.manifest.to_json()),
        extra={"page_size": spt.page_size, "max_pages": spt.max_pages})


def restore_sharded_table(ckpt_dir: str, n_shards: int,
                          pages_per_shard: int, *,
                          strategy: str = "linear",
                          step: Optional[int] = None,
                          page_size: Optional[int] = None,
                          max_pages: Optional[int] = None,
                          device=None) -> Tuple[ShardedPageTable, int]:
    """Restore onto ``n_shards`` shards — any count, not just the saved
    one: every saved live key re-routes through the NEW balanced manifest
    (``insert_keys``), the elastic-restore contract of the format."""
    shards, _saved_manifest, step = CKPT.restore_sharded(ckpt_dir, step=step)
    final = os.path.join(ckpt_dir, f"step_{step:08d}", "shards.json")
    with open(final) as f:
        extra = json.load(f).get("extra", {})
    spt = ShardedPageTable(
        n_shards, pages_per_shard, strategy=strategy,
        page_size=int(page_size or extra.get("page_size", 16)),
        max_pages=int(max_pages or extra.get("max_pages", 64)),
        device=device)
    total = 0
    for payload in shards:
        total += spt.insert_keys(payload["keys"])
    n_keys = sum(int(p["keys"].size) for p in shards)
    if total != n_keys:
        raise RuntimeError(
            f"restore re-homed {total}/{n_keys} keys — target pool too "
            f"small or duplicate keys across shards")
    return spt, step


def plan_table_shards(mesh) -> int:
    """Shard count implied by a mesh: one table shard per ``pod``-axis
    host group, single-shard otherwise.  Reads only ``mesh.shape``."""
    try:
        return int(mesh.shape.get("pod", 1))
    except AttributeError:
        return 1
