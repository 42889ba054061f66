"""The paper's hash table as the paged-KV page table / allocator (PyTorch
port of ``serving/page_table.py``).

The table has one cell per physical KV page, keyed by ``(seq_id,
logical_page)``; claiming cell i allocates physical page i.  ``insert`` is
page allocation, the wait-free ``lookup`` is the block-table read, and
``delete`` evicts a sequence: its pages become TOMBSTONEs that later
allocations reclaim directly (Proposition 2 as a memory allocator).

Key packing: key = seq_id * MAX_LOGICAL_PAGES + logical_page.

The incremental block table (``alloc_step_incremental``) keeps a persistent
int32[B, max_pages] cache updated at page-boundary crossings; the
wait-free lookup stays the authoritative read for admission, after a
Section 4.3 rebuild (``rebuild_block_table``) and in the verification
mode (``verify_block_table``).

The ``PageTable`` facade binds one probe strategy (``linear``,
``robinhood`` or ``hopscotch``, ``core/probe_strategies``) and threads it
through every operation.  Every state and result here equals the JAX
facade's bit for bit.  The
facade is functional: table and block table are returned, never written
in place.  ``PROBE_STATS`` counts every call (the port is eager; the JAX
package counts only its eager calls, not those inside a jitted megastep);
``PROBED_TOTAL`` counts the same keys but is never reset, so that a span
(``obs/trace``) can take its difference across any interval.  The
allocation, the frees and the headroom read are the spans
``allocator.alloc_step``, ``allocator.free`` and ``allocator.headroom``.
"""
from __future__ import annotations

import contextlib
import functools
import logging
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import batched as BT
from repro_torch.core import encoding as E
from repro_torch.core.probe_strategies import get_strategy
from repro_torch.device import host_int, host_numpy
from repro_torch.obs.trace import span

logger = logging.getLogger(__name__)

MAX_LOGICAL_PAGES = 2048  # 2^11 -> 500k tokens at page_size 256

PROBE_STATS = {"keys_probed": 0}
PROBED_TOTAL = {"keys_probed": 0}


def probe_stats_reset() -> None:
    PROBE_STATS["keys_probed"] = 0


@contextlib.contextmanager
def probe_stats_scope() -> Iterator[dict]:
    """Scoped probe accounting: inside the ``with`` block the counter starts
    at 0; on exit the enclosing value is restored exactly.  Read the scoped
    count from the yielded dict before the block exits; scopes nest."""
    outer = PROBE_STATS["keys_probed"]
    PROBE_STATS["keys_probed"] = 0
    try:
        yield PROBE_STATS
    finally:
        PROBE_STATS["keys_probed"] = outer


def _note_probes(n: int) -> None:
    PROBE_STATS["keys_probed"] += int(n)
    PROBED_TOTAL["keys_probed"] += int(n)


def page_key(seq_ids, logical_pages) -> torch.Tensor:
    """uint32 ``seq_id * MAX_LOGICAL_PAGES + logical_page`` as int64."""
    s = torch.as_tensor(seq_ids).to(torch.int64)
    p = torch.as_tensor(logical_pages, device=s.device).to(torch.int64)
    return (s * MAX_LOGICAL_PAGES + p) & 0xFFFFFFFF


class AllocStep(NamedTuple):
    """Result of one per-step allocation round.  ``write_slot`` is -1 for
    lanes that must NOT write KV this step (inactive, or ABORTed): a
    refusal, never an index."""
    table: BT.HashTable
    write_slot: torch.Tensor   # int32[B]
    aborted: torch.Tensor      # bool[B]


class PageTableStats(NamedTuple):
    live_pages: torch.Tensor
    tombstones: torch.Tensor
    occupancy: torch.Tensor


class Headroom(NamedTuple):
    """Occupancy/headroom view of the page pool (host ints — the admission
    controller's input).  ``free_cells = n_pages - live_pages``: with
    tombstone reuse a TOMBSTONE cell is immediately re-claimable.  Under
    hopscotch there are no tombstones, but displacement can fail before
    the pool is full, so ``slack`` carries the strategy's
    ``forecast_slack`` for the forecaster's gate ``demand + safety + slack
    <= free_cells``."""
    n_pages: int
    live_pages: int
    tombstones: int
    free_cells: int
    live_fraction: float
    occupancy: float
    strategy: str = "linear"
    slack: int = 0


def _bool(x, shape, device) -> torch.Tensor:
    if x is None:
        return torch.ones(shape, dtype=torch.bool, device=device)
    return torch.as_tensor(x, device=device).to(torch.bool)


class PageTable:
    """Strategy-bound facade over the allocator.  Table state is passed in
    and returned."""

    def __init__(self, strategy: str = "linear"):
        self._impl = get_strategy(strategy)  # validates the name eagerly
        self.strategy = strategy
        self._kernel_fallback_logged = False

    # -- construction / maintenance ------------------------------------

    def create_table(self, n_pages: int, seed: int = 0, *,
                     device=None) -> BT.HashTable:
        return BT.create(n_pages, seed=seed, strategy=self.strategy,
                         device=device)

    def rehash(self, table: BT.HashTable, n_pages: int,
               seed: Optional[int] = None):
        """Section 4.3 rebuild: re-insert every live key into a fresh table
        of ``n_pages`` cells (a new seed by default).  Returns (table',
        old_slot[m], new_slot[m], live[m]) — the page permutation the caller
        applies to the KV pools."""
        keys, n_live = BT.live_keys(table)
        dev = table.table.device
        live = torch.arange(keys.shape[0], device=dev) < n_live
        fresh = BT.create(n_pages,
                          seed=(host_int(table.seed) + 1 if seed is None
                                else seed),
                          strategy=self.strategy, device=dev)
        fresh, _ = BT.insert_batch(fresh, keys, active=live,
                                   strategy=self.strategy)
        _, old_slots = BT.find_batch(table, keys, live,
                                     strategy=self.strategy)
        _, new_slots = BT.find_batch(fresh, keys, live,
                                     strategy=self.strategy)
        return fresh, old_slots, new_slots, live

    # -- allocation -----------------------------------------------------

    def alloc_step(self, table: BT.HashTable, seq_ids, positions, *,
                   page_size: int, active=None) -> AllocStep:
        """Allocate the page for each sequence's current position when it
        crosses a page boundary; inactive lanes neither allocate nor get a
        ``write_slot``."""
        positions = torch.as_tensor(positions, device=table.table.device)
        act = _bool(active, positions.shape, positions.device)
        page_idx = positions // page_size
        need_new = ((positions % page_size) == 0) & act
        keys = page_key(seq_ids, page_idx)
        table, ret = BT.insert_batch(table, keys, active=need_new,
                                     strategy=self.strategy)
        aborted = need_new & (ret == 2)
        found, slots = BT.find_batch(table, keys, strategy=self.strategy)
        _note_probes(host_int(need_new.sum()) + positions.shape[0])
        return AllocStep(table, torch.where(found & act, slots, -1),
                         aborted)

    def alloc_step_incremental(self, table: BT.HashTable, seq_ids,
                               positions, block_table, *, page_size: int,
                               active=None
                               ) -> Tuple[AllocStep, torch.Tensor]:
        """``alloc_step`` with the incremental block-table cache: only the
        page-boundary crossings probe the table; every other lane's
        ``write_slot`` is served from ``block_table`` (int32[B, max_pages],
        -1 = absent).  Returns (AllocStep, block_table').  On ABORT the
        crossing entry is written as -1.

        When no lane crosses a page boundary the insert and the lookup
        are skipped: both are identities on such a batch, and skipping
        them saves their host syncs."""
        with span("allocator.alloc_step"):
            positions = torch.as_tensor(positions, device=table.table.device)
            B = positions.shape[0]
            act = _bool(active, positions.shape, positions.device)
            page_idx = (positions // page_size).to(torch.int64)
            need_new = ((positions % page_size) == 0) & act
            n_new = host_int(need_new.sum())
            if n_new:
                keys = page_key(seq_ids, page_idx)
                table, ret = BT.insert_batch(table, keys, active=need_new,
                                             strategy=self.strategy)
                aborted = need_new & (ret == 2)
                found, slots = BT.find_batch(table, keys, active=need_new,
                                             strategy=self.strategy)
                fresh_slot = torch.where(found & need_new, slots, -1)
            else:
                aborted = torch.zeros_like(need_new)
                fresh_slot = torch.full_like(block_table[:, 0], -1)
            _note_probes(2 * n_new)

            max_pages = block_table.shape[1]
            rows = torch.arange(B, device=positions.device)
            cached = block_table[rows, page_idx.clamp(0, max_pages - 1)]
            write_slot = torch.where(need_new, fresh_slot,
                                     torch.where(act, cached, -1))
            # scatter the crossings; other lanes write the trash column
            bt = torch.cat([block_table, block_table[:, :1]], dim=1)
            bt[rows, torch.where(need_new, page_idx, max_pages)] = fresh_slot
            return AllocStep(table, write_slot.to(torch.int32),
                             aborted), bt[:, :max_pages].contiguous()

    def prefill_alloc(self, table: BT.HashTable, seq_ids, lengths, *,
                      page_size: int, max_pages: int
                      ) -> Tuple[BT.HashTable, torch.Tensor]:
        """Allocate all pages for freshly prefilling sequences.  Returns
        (table', slots [B, max_pages])."""
        dev = table.table.device
        seq_ids = torch.as_tensor(seq_ids, device=dev)
        lengths = torch.as_tensor(lengths, device=dev)
        B = seq_ids.shape[0]
        logical = torch.arange(max_pages, dtype=torch.int64, device=dev)
        keys = page_key(seq_ids[:, None], logical[None, :]).reshape(-1)
        need = (logical[None, :] * page_size < lengths[:, None]).reshape(-1)
        table, _ = BT.insert_batch(table, keys, active=need,
                                   strategy=self.strategy)
        found, slots = BT.find_batch(table, keys, strategy=self.strategy)
        slots = torch.where(found & need, slots, -1)
        return table, slots.reshape(B, max_pages)

    # -- eviction -------------------------------------------------------

    def free_sequences(self, table: BT.HashTable, seq_ids, positions, *,
                       page_size: int, max_pages: int,
                       active=None) -> BT.HashTable:
        """Evict sequences: delete all their page keys.  Linear and
        robinhood leave TOMBSTONEs that later allocations reuse (no
        rebuild); hopscotch returns the cells to EMPTY outright."""
        with span("allocator.free"):
            dev = table.table.device
            seq_ids = torch.as_tensor(seq_ids, device=dev)
            positions = torch.as_tensor(positions, device=dev)
            B = seq_ids.shape[0]
            logical = torch.arange(max_pages, dtype=torch.int64, device=dev)
            keys = page_key(seq_ids[:, None], logical[None, :]).reshape(-1)
            act = ((logical[None, :] <= positions[:, None] // page_size)
                   & _bool(active, (B,), dev)[:, None]).reshape(-1)
            table, _ = BT.delete_batch(table, keys, active=act,
                                       strategy=self.strategy)
            _note_probes(host_int(act.sum()))
            return table

    # -- reads ----------------------------------------------------------

    def lookup_pages(self, table: BT.HashTable, seq_ids, positions, *,
                     page_size: int, max_pages: int) -> torch.Tensor:
        """Wait-free block-table read: physical slot of every logical page
        of every sequence (-1 where absent/not yet needed).
        [B, max_pages]."""
        dev = table.table.device
        seq_ids = torch.as_tensor(seq_ids, device=dev)
        positions = torch.as_tensor(positions, device=dev)
        B = seq_ids.shape[0]
        logical = torch.arange(max_pages, dtype=torch.int64, device=dev)
        keys = page_key(seq_ids[:, None], logical[None, :]).reshape(-1)
        found, slots = BT.find_batch(table, keys, strategy=self.strategy)
        _note_probes(B * max_pages)
        slots = slots.reshape(B, max_pages)
        found = found.reshape(B, max_pages)
        live = logical[None, :] <= (positions[:, None] // page_size)
        return torch.where(found & live, slots, -1)

    def rebuild_block_table(self, table: BT.HashTable, seq_ids,
                            max_pages: int, *,
                            use_kernel: bool = False) -> torch.Tensor:
        """(Re)build block-table rows from the authoritative wait-free
        lookup — on admission, after a Section 4.3 ``rehash`` and in the
        verification mode.  Every present page is cached regardless of the
        current position.  ``use_kernel=True`` serves the bulk lookup
        through the probe kernel K3 (``kernels/probe``): bitwise the same
        rows.  K3 walks the linear probe order: for a strategy it does not
        serve (hopscotch) the rows come from the strategy's ``find_batch``,
        logged once and shown by ``engine.fallback_report``."""
        dev = table.table.device
        seq_ids = torch.as_tensor(seq_ids, device=dev)
        B = seq_ids.shape[0]
        logical = torch.arange(max_pages, dtype=torch.int64, device=dev)
        keys = page_key(seq_ids[:, None], logical[None, :]).reshape(-1)
        if use_kernel and not self._impl.kernel_supported:
            if not self._kernel_fallback_logged:
                logger.warning(
                    "probe kernel fallback: strategy %r is not supported "
                    "by the probe kernel (linear probe order); serving "
                    "rebuild_block_table from the strategy's find_batch",
                    self.strategy)
                self._kernel_fallback_logged = True
            use_kernel = False
        if use_kernel:
            from repro_torch.kernels.probe import ops as PK
            found, slots = PK.probe_lookup(table, keys,
                                           strategy=self.strategy)
        else:
            found, slots = BT.find_batch(table, keys,
                                         strategy=self.strategy)
        _note_probes(B * max_pages)
        return torch.where(found, slots, -1).reshape(B, max_pages)

    @staticmethod
    def block_table_slots(block_table, positions, *,
                          page_size: int) -> torch.Tensor:
        """The per-step block-table read, cache flavoured: the same
        [B, max_pages] view as ``lookup_pages`` with zero probes."""
        max_pages = block_table.shape[1]
        logical = torch.arange(max_pages, dtype=torch.int32,
                               device=block_table.device)
        positions = torch.as_tensor(positions, device=block_table.device)
        live = logical[None, :] <= (positions[:, None] // page_size)
        return torch.where(live & (block_table >= 0), block_table, -1)

    @staticmethod
    def invalidate_block_rows(block_table, mask) -> torch.Tensor:
        """Rows where ``mask`` is True become all -1 (evicted lanes)."""
        mask = torch.as_tensor(mask, device=block_table.device)
        return torch.where(mask.to(torch.bool)[:, None], -1, block_table)

    def verify_block_table(self, table: BT.HashTable, seq_ids, positions,
                           block_table, *, page_size: int) -> torch.Tensor:
        """Mismatch count between the incremental cache and the
        authoritative wait-free lookup (0 = coherent)."""
        max_pages = block_table.shape[1]
        ref = self.lookup_pages(table, seq_ids, positions,
                                page_size=page_size, max_pages=max_pages)
        got = self.block_table_slots(block_table, positions,
                                     page_size=page_size)
        return (got != ref).sum()

    # -- accounting -----------------------------------------------------

    @staticmethod
    def stats(table: BT.HashTable) -> PageTableStats:
        return PageTableStats(live_pages=table.num_keys,
                              tombstones=table.num_tombs,
                              occupancy=BT.occupancy(table))

    def forecast_slack(self, n_pages: int) -> int:
        """Extra free cells the forecaster must hold for this strategy's
        no-ABORT guarantee (0 for linear/robinhood: Prop. 2 is exact)."""
        return self._impl.forecast_slack(n_pages)

    @staticmethod
    def probe_p99(table: BT.HashTable, q: float = 99.0) -> float:
        """Host-side probe-length percentile of the current pool: each live
        key's displacement from its hash slot (mod table size)."""
        tab = host_numpy(table.table)
        occ = (tab != E.EMPTY) & (tab != E.TOMBSTONE)
        idx = np.nonzero(occ)[0]
        if not idx.size:
            return 0.0
        ht = table._replace(seed=torch.from_numpy(host_numpy(table.seed)),
                            table=torch.from_numpy(tab))
        hv = BT._hash(ht, torch.from_numpy(tab[idx] >> 2)).numpy()
        d = (idx - hv) % tab.shape[0]
        return float(np.percentile(d, q))

    def headroom(self, table: BT.HashTable) -> Headroom:
        """Synchronous (host) headroom read."""
        with span("allocator.headroom"):
            m = BT.size(table)
            live = host_int(table.num_keys)
            tombs = host_int(table.num_tombs)
            return Headroom(n_pages=m, live_pages=live, tombstones=tombs,
                            free_cells=m - live,
                            live_fraction=live / max(m, 1),
                            occupancy=(live + tombs) / max(m, 1),
                            strategy=self.strategy,
                            slack=self.forecast_slack(m))


@functools.lru_cache(maxsize=None)
def for_strategy(strategy: str = "linear") -> PageTable:
    """The shared per-strategy facade."""
    return PageTable(strategy)
