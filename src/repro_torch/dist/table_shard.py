"""Hash-prefix sharding + lazy incremental resize for the page table
(PyTorch port of ``dist/table_shard.py``).

* **Prefix routing** (``ShardManifest``): the key space is partitioned by a
  hash prefix of the sequence id; a manifest maps each of the
  ``2^prefix_bits`` prefixes to an owner shard.  Every page of a sequence
  lands on one shard, so admission is gated by the owner's headroom alone.
  The manifest is plain JSON-serializable data and supports
  ``reassign``: a lost shard's prefixes go to the survivors round-robin.

* **Lazy incremental resize** (``TableShard``): the Gao/Groote/Hesselink
  protocol on the batched, quiescent table.  A grown shard holds two
  tables, ``old`` (frozen for inserts) and ``table`` (the fresh, larger
  one), and a migration cursor.  Keys migrate out of ``old`` on access
  (``migrate_keys``, before an insert or delete lands) and by cursor sweep
  (``sweep_migrate``, a bounded chunk each serving round).  Lookups are
  wait-free union reads (new table first, then old).  Every migrated
  entry leaves a moved marker: a TOMBSTONE in the old cell plus a bit in
  the old table's ``meta`` words (``meta`` is empty for linear and
  robinhood, so the marker words take its place).  Under hopscotch the
  cell returning to EMPTY is the marker and no bit is set: ``meta`` there
  is the neighbourhood bitmap.

The markers are ORed on the host into uint32 words, which the int32
carrier holds bit for bit (slot % 32 == 31 is the sign bit).  Everything
here is host-driven between megasteps; each device read is a counted host
sync (``device.host_numpy`` / ``host_int``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import batched as BT
from repro_torch.core import encoding as E
from repro_torch.core import hashing as H
from repro_torch.device import host_int, host_numpy
from repro_torch.obs import counters as OC

PREFIX_SEED = 0x50D5EED   # routing hash seed — independent of probe hashes
DEFAULT_PREFIX_BITS = 6   # 64 prefix ranges: fine-grained enough to respread
MIGRATE_CHUNK = 32        # old cells swept per migration service round


def seq_prefix(seq_ids, prefix_bits: int = DEFAULT_PREFIX_BITS
               ) -> np.ndarray:
    """Hash prefix of each sequence id (read as uint32): the routing key of
    the distributed table.  Host ints."""
    ids = torch.from_numpy(np.asarray(seq_ids).astype(np.int64))
    return H.hash_keys(ids, 1 << prefix_bits, PREFIX_SEED).numpy()


@dataclasses.dataclass(frozen=True)
class ShardManifest:
    """Prefix-range -> owner-shard map.  ``owners[p]`` is the shard owning
    prefix ``p``; a shard with no prefixes is dead (lost / drained)."""
    prefix_bits: int
    owners: Tuple[int, ...]           # len == 2**prefix_bits

    @staticmethod
    def balanced(n_shards: int,
                 prefix_bits: int = DEFAULT_PREFIX_BITS) -> "ShardManifest":
        if n_shards < 1 or n_shards > (1 << prefix_bits):
            raise ValueError(
                f"n_shards={n_shards} not in [1, 2^{prefix_bits}]")
        owners = tuple(p % n_shards for p in range(1 << prefix_bits))
        return ShardManifest(prefix_bits, owners)

    @property
    def n_prefixes(self) -> int:
        return 1 << self.prefix_bits

    def live_shards(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.owners)))

    def owner_of_seq(self, seq_ids) -> np.ndarray:
        """Owner shard of each sequence id (host ints)."""
        return np.asarray(self.owners, np.int32)[
            seq_prefix(seq_ids, self.prefix_bits)]

    def reassign(self, lost_shard: int) -> "ShardManifest":
        """Hand the lost shard's prefix ranges to the survivors
        round-robin; survivors keep their own prefixes."""
        survivors = [s for s in self.live_shards() if s != lost_shard]
        if not survivors:
            raise ValueError("cannot reassign: no surviving shards")
        owners = list(self.owners)
        nxt = 0
        for p, o in enumerate(owners):
            if o == lost_shard:
                owners[p] = survivors[nxt % len(survivors)]
                nxt += 1
        return ShardManifest(self.prefix_bits, tuple(owners))

    def to_json(self) -> str:
        return json.dumps({"prefix_bits": self.prefix_bits,
                           "owners": list(self.owners)})

    @staticmethod
    def from_json(s: str) -> "ShardManifest":
        d = json.loads(s)
        return ShardManifest(int(d["prefix_bits"]), tuple(d["owners"]))


@dataclasses.dataclass(frozen=True)
class MoveSet:
    """Physical page moves of one migration step: the page at old-table
    cell ``old_slots[i]`` moves to new-table cell ``new_slots[i]`` (local
    indices)."""
    old_slots: np.ndarray   # int32[n]
    new_slots: np.ndarray   # int32[n]

    @property
    def n(self) -> int:
        return int(self.old_slots.size)

    @staticmethod
    def empty() -> "MoveSet":
        z = np.zeros((0,), np.int32)
        return MoveSet(z, z)


def _marker_words(m: int) -> int:
    return (m + 31) // 32


def _mask(active, B: int, device) -> torch.Tensor:
    if active is None:
        return torch.ones((B,), dtype=torch.bool, device=device)
    return torch.as_tensor(active, device=device).to(torch.bool)


@dataclasses.dataclass
class TableShard:
    """One shard of the distributed page table.  ``old is None`` = stable;
    otherwise a lazy resize is in flight."""
    shard_id: int
    strategy: str
    table: BT.HashTable                 # current (post-grow) table
    old: Optional[BT.HashTable] = None  # migrating-from table
    cursor: int = 0                     # next old cell the sweep visits
    migrated: int = 0                   # entries moved so far

    @property
    def migrating(self) -> bool:
        return self.old is not None

    @property
    def device(self) -> torch.device:
        return self.table.table.device

    def n_cells(self) -> int:
        return BT.size(self.table)

    def live_pages(self) -> int:
        """Live keys across both tables — each owns a physical page."""
        n = host_int(self.table.num_keys)
        if self.old is not None:
            n += host_int(self.old.num_keys)
        return n

    def free_cells(self) -> int:
        """``m_new - live_new - live_old``: every un-migrated old key has a
        new-table cell committed to it, so the forecaster's ``demand +
        safety + slack <= free_cells`` stays a no-ABORT proof through a
        migration."""
        return BT.size(self.table) - self.live_pages()

    def _keys(self, keys) -> torch.Tensor:
        return H.as_u32(torch.as_tensor(keys).to(self.device))

    @staticmethod
    def create(shard_id: int, m: int, seed: int = 0,
               strategy: str = "linear", *, device=None) -> "TableShard":
        return TableShard(shard_id=shard_id, strategy=strategy,
                          table=BT.create(m, seed=seed, strategy=strategy,
                                          device=device))

    # -- lazy resize ------------------------------------------------------

    def begin_migration(self, new_m: int,
                        seed: Optional[int] = None) -> "TableShard":
        """Start the lazy grow: a fresh table of ``new_m`` cells becomes
        current, the previous one freezes as ``old`` with moved-marker
        words on its ``meta``.  O(1): no rehash, no page sweep."""
        if self.migrating:
            raise RuntimeError(
                f"shard {self.shard_id}: migration already in flight")
        if new_m < self.live_pages():
            raise ValueError(
                f"shard {self.shard_id}: new_m={new_m} below live set "
                f"{self.live_pages()}")
        old = self.table
        if old.meta.numel() == 0:   # metadata-free strategy: meta carries
            old = old._replace(     # the per-entry moved markers
                meta=torch.zeros((_marker_words(BT.size(old)),),
                                 dtype=torch.int32, device=self.device))
        fresh = BT.create(new_m, seed=(host_int(self.table.seed) + 1
                                       if seed is None else seed),
                          strategy=self.strategy, device=self.device)
        return dataclasses.replace(self, table=fresh, old=old, cursor=0)

    def _mark_moved(self, old: BT.HashTable, slots: np.ndarray
                    ) -> BT.HashTable:
        if self.strategy == "hopscotch" or old.meta.numel() == 0 \
                or slots.size == 0:
            return old      # hopscotch: the EMPTY cell is the marker
        # host-side accumulating OR in uint32 (two slots of one word must
        # both land), viewed back as the int32 carrier bit for bit
        meta = host_numpy(old.meta).view(np.uint32).copy()
        np.bitwise_or.at(meta, slots // 32,
                         np.uint32(1) << (slots.astype(np.uint32) % 32))
        return old._replace(meta=torch.from_numpy(meta.view(np.int32)).to(
            self.device))

    def _migrate_active(self, keys: torch.Tensor, act: torch.Tensor
                        ) -> Tuple["TableShard", MoveSet]:
        """Migrate the active keys still in ``old``: insert into the
        current table, tombstone + mark the old cell, report the page
        moves."""
        assert self.old is not None
        found, old_slots = BT.find_batch(self.old, keys, act,
                                         strategy=self.strategy)
        mig = host_numpy(found & act)
        if not mig.any():
            return self, MoveSet.empty()
        mig_t = torch.from_numpy(mig).to(self.device)
        table, ret = BT.insert_batch(self.table, keys, active=mig_t,
                                     strategy=self.strategy)
        if host_int(((ret == 2) & mig_t).sum()):
            # begin_migration guarantees capacity; reaching here means the
            # caller grew below the live set — corruption, not overflow
            raise RuntimeError(
                f"shard {self.shard_id}: migration insert ABORTed — "
                f"new table smaller than the live set")
        _, new_slots = BT.find_batch(table, keys, active=mig_t,
                                     strategy=self.strategy)
        old, _ = BT.delete_batch(self.old, keys, active=mig_t,
                                 strategy=self.strategy)
        old_np = host_numpy(old_slots)[mig]
        old = self._mark_moved(old, old_np)
        moves = MoveSet(old_np.astype(np.int32),
                        host_numpy(new_slots)[mig].astype(np.int32))
        # host-plane telemetry: one old-table find per candidate plus
        # insert + find + delete per migrated key
        OC.note_host("migration_moved", moves.n)
        OC.note_host("probe_steps", host_int(act.sum()) + 3 * moves.n)
        shard = dataclasses.replace(self, table=table, old=old,
                                    migrated=self.migrated + moves.n)
        return shard._maybe_finish(), moves

    def migrate_keys(self, keys, active=None
                     ) -> Tuple["TableShard", MoveSet]:
        """Migrate-on-access: move the touched keys out of ``old`` before
        an insert/delete lands.  No-op when stable."""
        if not self.migrating:
            return self, MoveSet.empty()
        keys = self._keys(keys)
        return self._migrate_active(keys,
                                    _mask(active, keys.shape[0],
                                          self.device))

    def sweep_migrate(self, chunk: int = MIGRATE_CHUNK
                      ) -> Tuple["TableShard", MoveSet]:
        """Cursor sweep: migrate the live keys in the next ``chunk`` old
        cells; termination in ceil(m_old / chunk) calls."""
        if not self.migrating:
            return self, MoveSet.empty()
        assert self.old is not None
        m_old = BT.size(self.old)
        lo = self.cursor
        hi = min(lo + int(chunk), m_old)
        k = E.dec_key(self.old.table[lo:hi]).to(torch.int64)
        is_key = k != E.RESERVED_KEY
        shard, moves = self._migrate_active(torch.where(is_key, k, 0),
                                            is_key)
        shard = dataclasses.replace(shard, cursor=hi)
        return shard._maybe_finish(), moves

    def _maybe_finish(self) -> "TableShard":
        if self.old is None:
            return self
        left = host_int(self.old.num_keys)
        done_by_sweep = self.cursor >= BT.size(self.old)
        if left == 0 or done_by_sweep:
            if left:
                # the sweep covered every cell, so nothing live can remain
                raise RuntimeError(
                    f"shard {self.shard_id}: sweep completed with {left} "
                    f"keys left in old")
            return dataclasses.replace(self, old=None, cursor=0)
        return self

    # -- operations (route through these, never at BT directly) ----------

    def find(self, keys, active=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Wait-free union read: (found, local_slot, in_old).  ``in_old``
        marks hits whose page still lives at the old table's cell."""
        keys = self._keys(keys)
        found_n, slot_n = BT.find_batch(self.table, keys, active,
                                        strategy=self.strategy)
        if self.old is None:
            return found_n, slot_n, torch.zeros_like(found_n)
        found_o, slot_o = BT.find_batch(self.old, keys, active,
                                        strategy=self.strategy)
        return (found_n | found_o, torch.where(found_n, slot_n, slot_o),
                ~found_n & found_o)

    def insert(self, keys, active=None
               ) -> Tuple["TableShard", torch.Tensor, MoveSet]:
        """Insert into the current table, migrate-on-access first (a key
        can never be live in both tables).  Returns (shard', ret int32[B]
        — 1 inserted / 0 present / 2 ABORT, moves)."""
        keys = self._keys(keys)
        act = _mask(active, keys.shape[0], self.device)
        shard, moves = self.migrate_keys(keys, act)
        table, ret = BT.insert_batch(shard.table, keys, active=act,
                                     strategy=self.strategy)
        return dataclasses.replace(shard, table=table), ret, moves

    def delete(self, keys, active=None
               ) -> Tuple["TableShard", torch.Tensor, MoveSet]:
        """Delete from wherever the key lives (after migrate-on-access only
        the current table can hold it)."""
        keys = self._keys(keys)
        act = _mask(active, keys.shape[0], self.device)
        shard, moves = self.migrate_keys(keys, act)
        table, ret = BT.delete_batch(shard.table, keys, active=act,
                                     strategy=self.strategy)
        return dataclasses.replace(shard, table=table), ret, moves

    def migration_progress(self) -> Tuple[int, int]:
        """(entries migrated so far, entries still in old)."""
        left = 0 if self.old is None else host_int(self.old.num_keys)
        return self.migrated, left
