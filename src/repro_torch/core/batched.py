"""Batched linear-probing hash table (PyTorch port of ``core/batched.py``).

The ``n`` asynchronous processes of the paper become the ``B`` lanes of a
batch; per-word CAS becomes scatter-min priority arbitration (optimistic
claim / check who won / retry); tombstone reuse carries over unchanged:
inserts claim EMPTY *or* TOMBSTONE cells (Proposition 2).  Between batch
applications the table is quiescent: cells hold only ``<v, final>``,
EMPTY or TOMBSTONE.  ``apply_batch`` linearizes a mixed batch as all
deletes < all inserts < all lookups, each group by batch index.

Every operation returns bitwise the JAX package's state and results.  The
table is an int32 tensor holding the reference's uint32 bit patterns (see
``core/encoding``).  Operations are functional: they return a new
``HashTable`` and never write into the one they were given.

Port notes:
* JAX's ``lax.while_loop``s become Python loops whose conditions are read
  on the host (``device.host_bool``), one sync per round.
* ``.at[...].min/set(mode="drop")`` has no torch counterpart: each scatter
  target gets a trash row at index ``m`` that is sliced off afterwards, and
  no negative index ever reaches an index op.
* ``_dedup_leaders`` builds a B x B matrix, O(B^2) as in the reference;
  callers keep batches to a few thousand keys.

Probe strategies: every operation takes a ``strategy`` keyword (default
``"linear"``).  ``linear`` and ``robinhood`` share one claim loop
(``_claim_insert``) that differs only in its priority and sentinel;
``robinhood``'s lookups and deletes are the linear ones.  ``hopscotch``
dispatches to ``core/probe_strategies``.  ``HashTable.meta`` carries the
strategy's metadata (hopscotch's neighbourhood bitmaps: int32 words holding
uint32 bit patterns; empty for linear and robinhood).  ``ROUND_STATS``
counts the arbitration rounds and displacement hops, each of which costs
one host sync.

Keys must lie in ``[0, encoding.MAX_KEY)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import encoding as E
from repro_torch.core import hashing as H
from repro_torch.device import host_bool, host_int, resolve_device, to_card

PROBE_CHUNK = 8  # cells fetched per probe round

# claim rounds of the insert loops, displacements and their hops (the
# hopscotch loop); each round and each hop is one counted host sync
ROUND_STATS = {"claim_rounds": 0, "displacements": 0, "hops": 0}


class HashTable(NamedTuple):
    """Quiescent table state."""
    table: torch.Tensor      # int32[m]: enc_final(key) / EMPTY / TOMBSTONE
    num_keys: torch.Tensor   # int32 []: live keys
    num_tombs: torch.Tensor  # int32 []: tombstones
    seed: torch.Tensor       # int32 []: hash seed
    meta: torch.Tensor       # int32[m] or int32[0]: strategy metadata


def _strategy_impl(strategy: str):
    from repro_torch.core.probe_strategies import get_strategy  # no cycle
    return get_strategy(strategy)


def create(m: int, seed: int = 0, strategy: str = "linear", *,
           device=None) -> HashTable:
    impl = _strategy_impl(strategy)  # raises ValueError on unknown names
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    meta = (torch.zeros((0,), **i32) if strategy == "linear"
            else impl.init_meta(m, dev))
    return HashTable(
        table=torch.full((m,), E.EMPTY, **i32),
        num_keys=torch.zeros((), **i32),
        num_tombs=torch.zeros((), **i32),
        seed=to_card(seed, dev, torch.int32),
        meta=meta,
    )


def size(ht: HashTable) -> int:
    return ht.table.shape[0]


def _keys(ht: HashTable, keys) -> torch.Tensor:
    """Keys as int64 tensor of uint32 values on the table's device."""
    return H.as_u32(torch.as_tensor(keys, device=ht.table.device))


def _hash(ht: HashTable, keys) -> torch.Tensor:
    """Bucket of each key; the table's seed is folded into the key stream
    exactly as the reference does (``keys ^ seed * 0x9E3779B9``)."""
    mix = H.mul_u32(H.as_u32(ht.seed), 0x9E3779B9)
    return H.hash_keys(_keys(ht, keys) ^ mix, size(ht), 0)


def _final_word(keys: torch.Tensor) -> torch.Tensor:
    """``(key << 2) | TAG_FINAL`` as an int32 cell word."""
    return (((keys << 2) | E.TAG_FINAL) & H.MASK32).to(torch.int32)


def _active_mask(B: int, active, device) -> torch.Tensor:
    if active is None:
        return torch.ones((B,), dtype=torch.bool, device=device)
    return torch.as_tensor(active, device=device).to(torch.bool)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 words with the same bit
    pattern (bit 31 becomes the sign bit), wrapped explicitly."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1 (0 if none), like ``jnp.argmax``
    over bool; ``torch.argmax`` rejects bool and also returns the first
    maximum."""
    return torch.argmax(mask.to(torch.int8), dim=1)


# ---------------------------------------------------------------------------
# Lookup — wait-free, read-only.

def find_batch(ht: HashTable, keys, active=None, *,
               strategy: str = "linear"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found bool[B], slot int32[B]) — slot of ``<key, final>``, or -1.

    Linear and robinhood scan each key's run in PROBE_CHUNK-cell windows
    until the key or an EMPTY cell (end of run) is found — the plain
    version of the probe kernel (``kernels/probe``); hopscotch gathers its
    bitmap-indicated neighbourhood instead."""
    if strategy not in ("linear", "robinhood"):
        return _strategy_impl(strategy).find_batch(ht, keys, active)
    keys = _keys(ht, keys)
    dev = ht.table.device
    m = size(ht)
    B = keys.shape[0]
    act = _active_mask(B, active, dev)
    hv = _hash(ht, keys).to(torch.int64)
    target = _final_word(keys)

    max_rounds = (m + PROBE_CHUNK - 1) // PROBE_CHUNK
    woff = torch.arange(PROBE_CHUNK, dtype=torch.int64, device=dev)
    scanning = act.clone()
    found = torch.zeros((B,), dtype=torch.bool, device=dev)
    slot = torch.full((B,), -1, dtype=torch.int32, device=dev)
    step = 0
    while step < max_rounds and host_bool(scanning.any()):
        pos = torch.remainder(hv[:, None] + step * PROBE_CHUNK
                              + woff[None, :], m)
        vals = ht.table[pos]                            # [B, W]
        hit = vals == target[:, None]
        empty = vals == E.EMPTY
        hit_any = hit.any(dim=1)
        empty_any = empty.any(dim=1)
        hit_first = _first_true(hit)
        empty_first = _first_true(empty)
        hit_valid = hit_any & (~empty_any | (hit_first <= empty_first))
        upd = scanning & hit_valid
        found = found | upd
        slot = torch.where(
            upd, pos.gather(1, hit_first[:, None])[:, 0].to(torch.int32),
            slot)
        scanning = scanning & ~hit_valid & ~empty_any
        step += 1
    return found, slot


def lookup_batch(ht: HashTable, keys, active=None, *,
                 strategy: str = "linear") -> torch.Tensor:
    found, _ = find_batch(ht, keys, active, strategy=strategy)
    return found


# ---------------------------------------------------------------------------
# Insert — scatter-min arbitration rounds (the batched CAS analog).

def _dup_of_earlier(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[i] = some j < i with ``mask[j]`` holds the same key (B x B)."""
    B = keys.shape[0]
    eq = keys[None, :] == keys[:, None]                  # [i, j]
    earlier = torch.tril(torch.ones((B, B), dtype=torch.bool,
                                    device=keys.device), diagonal=-1)
    return (eq & earlier & mask[None, :]).any(dim=1)


def _dedup_leaders(keys: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """leader[b] = is b the first *active* occurrence of keys[b]?"""
    return ~_dup_of_earlier(keys, act) & act


def _finalize_insert_ret(keys, act, leader, present, placed, aborted):
    """Insert return codes: 1 = inserted, 0 = present, duplicate or
    inactive, 2 = ABORT, with a non-leader duplicate of an aborted leader
    also aborting (sequentially the leader ran first and the table is still
    full)."""
    ret = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    ret = torch.where(placed, 1, ret)
    ret = torch.where(aborted, 2, ret)
    leader_aborted = _dup_of_earlier(keys, aborted)
    return torch.where(act & ~leader & ~present & leader_aborted, 2,
                       ret).to(torch.int32)


def _claim_insert(ht: HashTable, keys, active, claim_tombstones: bool,
                  priority, sentinel: int) -> Tuple[HashTable, torch.Tensor]:
    """The linear probe's claim loop: each round every pending lane tries
    the next cell of its probe sequence, and the lowest ``priority(cursor)``
    (int32[B]) wins each contested cell under scatter-min; ``sentinel``
    exceeds every priority.  ``linear`` ranks by batch index, ``robinhood``
    by displacement first (``core/probe_strategies``)."""
    keys = _keys(ht, keys)
    dev = ht.table.device
    m = size(ht)
    B = keys.shape[0]
    act = _active_mask(B, active, dev)
    hv = _hash(ht, keys).to(torch.int64)
    leader = _dedup_leaders(keys, act)
    present, _ = find_batch(ht, keys, act)
    word = _final_word(keys)

    trash = torch.full((1,), E.EMPTY, dtype=torch.int32, device=dev)
    table = torch.cat([ht.table, trash])                # row m = trash
    cursor = torch.zeros((B,), dtype=torch.int64, device=dev)
    pending = leader & ~present
    placed = torch.zeros((B,), dtype=torch.bool, device=dev)
    aborted = torch.zeros((B,), dtype=torch.bool, device=dev)
    tombs_used = torch.zeros((), dtype=torch.int64, device=dev)
    while host_bool(pending.any()):
        ROUND_STATS["claim_rounds"] += 1
        cand = torch.remainder(hv + cursor, m)
        cur = table[cand]
        if claim_tombstones:
            avail = E.is_available(cur) & pending
        else:
            avail = (cur == E.EMPTY) & pending
        pri = priority(cursor)
        claim_idx = torch.where(avail, cand, m)         # m -> trash
        claims = torch.full((m + 1,), sentinel, dtype=torch.int32,
                            device=dev)
        claims.scatter_reduce_(0, claim_idx, pri, reduce="amin")
        won = avail & (claims[cand] == pri)
        was_tomb = won & (cur == E.TOMBSTONE)
        table[torch.where(won, cand, m)] = word
        tombs_used = tombs_used + was_tomb.sum()
        placed = placed | won
        # losers / occupied cells: advance cursor; full cycle -> ABORT
        adv = pending & ~won
        cursor = torch.where(adv, cursor + 1, cursor)
        ab = adv & (cursor >= m)
        aborted = aborted | ab
        pending = pending & ~won & ~ab

    ret = _finalize_insert_ret(keys, act, leader, present, placed, aborted)
    ht2 = ht._replace(
        table=table[:m],
        num_keys=(ht.num_keys + placed.sum()).to(torch.int32),
        num_tombs=(ht.num_tombs - tombs_used).to(torch.int32))
    return ht2, ret


def insert_batch(ht: HashTable, keys, active=None,
                 claim_tombstones: bool = True, *,
                 strategy: str = "linear"
                 ) -> Tuple[HashTable, torch.Tensor]:
    """Insert a batch; ret int32[B]: 1 = inserted, 0 = present, duplicate
    in batch or inactive, 2 = ABORT (no available cell).

    ``claim_tombstones=False`` reproduces the no-reuse behaviour of [7,14]
    (only EMPTY cells are claimable; ``core/baselines/gao_noreuse``)."""
    if strategy != "linear":
        return _strategy_impl(strategy).insert_batch(ht, keys, active,
                                                     claim_tombstones)
    B = torch.as_tensor(keys).shape[0]
    lane = torch.arange(B, dtype=torch.int32, device=ht.table.device)
    # claim: lowest batch index wins each contested cell
    return _claim_insert(ht, keys, active, claim_tombstones,
                         lambda cursor: lane, sentinel=B)


# ---------------------------------------------------------------------------
# Delete — find + tombstone.

def delete_batch(ht: HashTable, keys, active=None, *,
                 strategy: str = "linear"
                 ) -> Tuple[HashTable, torch.Tensor]:
    if strategy not in ("linear", "robinhood"):
        return _strategy_impl(strategy).delete_batch(ht, keys, active)
    keys = _keys(ht, keys)
    dev = ht.table.device
    m = size(ht)
    B = keys.shape[0]
    act = _active_mask(B, active, dev)
    found, slot = find_batch(ht, keys, act)
    leader = _dedup_leaders(keys, act)
    win = found & leader
    trash = torch.full((1,), E.EMPTY, dtype=torch.int32, device=dev)
    table = torch.cat([ht.table, trash])
    # a Python number assigned to card memory is copied there first
    table[torch.where(win, slot.to(torch.int64), m)] = to_card(
        E.TOMBSTONE, dev, torch.int32)
    n = win.sum()
    ht2 = ht._replace(table=table[:m],
                      num_keys=(ht.num_keys - n).to(torch.int32),
                      num_tombs=(ht.num_tombs + n).to(torch.int32))
    return ht2, win.to(torch.int32)


# ---------------------------------------------------------------------------
# Mixed batch + maintenance.

def apply_batch(ht: HashTable, ops, keys, *, strategy: str = "linear"):
    """ops int32[B] (spec.OP_*), keys [B].  Linearization order:
    deletes < inserts < lookups (each group by batch index).
    Returns (ht', ret int32[B])."""
    from repro_torch.core.spec import OP_DELETE, OP_INSERT
    dev = ht.table.device
    ops = torch.as_tensor(ops, device=dev).to(torch.int32)
    keys = _keys(ht, keys)
    ht, del_ret = delete_batch(ht, keys, active=(ops == OP_DELETE),
                               strategy=strategy)
    ht, ins_ret = insert_batch(ht, keys, active=(ops == OP_INSERT),
                               strategy=strategy)
    look_ret = lookup_batch(ht, keys, strategy=strategy).to(torch.int32)
    ret = torch.where(ops == OP_DELETE, del_ret,
                      torch.where(ops == OP_INSERT, ins_ret, look_ret))
    return ht, ret


def occupancy(ht: HashTable) -> torch.Tensor:
    """Fraction of non-EMPTY cells (keys + tombstones)."""
    return (ht.num_keys + ht.num_tombs) / size(ht)


def live_keys(ht: HashTable) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64[m] live keys packed first in cell order, padded with
    MAX_KEY; int64 [] count).  The order is a STABLE sort, as in the
    reference — any other order changes the table after ``rebuild``."""
    k = E.dec_key(ht.table)
    is_key = k != E.RESERVED_KEY
    keys = torch.where(is_key, k, E.MAX_KEY).to(torch.int64)
    order = torch.argsort((~is_key).to(torch.int32), stable=True)
    return keys[order], is_key.sum()


def rebuild(ht: HashTable, new_m: int, new_seed: Optional[int] = None, *,
            strategy: str = "linear") -> HashTable:
    """Resize/rebuild (Section 4.3: triggered by ABORTs)."""
    keys_sorted, n_live = live_keys(ht)
    seed = host_int(ht.seed) if new_seed is None else new_seed
    fresh = create(new_m, seed, strategy=strategy, device=ht.table.device)
    live = torch.arange(size(ht), device=ht.table.device) < n_live
    fresh, _ = insert_batch(fresh, keys_sorted, active=live,
                            strategy=strategy)
    return fresh
