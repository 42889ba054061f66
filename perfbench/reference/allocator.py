"""What the page table must hold, worked out again from the harness's
record of which request holds which lane since which round, and the
table the program holds, judged against it (NumPy).

The allocator's contract (the paper's table as a KV page allocator): one
cell per physical page, keyed ``seq_id * 2048 + logical_page``, packed
``key << 2 | tag``.  Between megasteps the table is quiescent: every cell
is EMPTY, a TOMBSTONE or a FINAL key.  A lane that holds a request at
position ``pos`` owns exactly its pages ``0 .. ceil(pos / page_size) - 1``,
each a live key in one cell, found from its hash bucket by linear probing
without passing an EMPTY cell; the block-table row caches each page's
cell and -1 beyond; a lane that holds nothing owns no key and an all -1
row.  The lane's position is the megastep's K times the rounds since its
admission (the pool is sized so that no step is refused).
"""
from __future__ import annotations

import numpy as np

KEY_BITS = 28
RESERVED = (1 << KEY_BITS) - 1
EMPTY, TOMBSTONE = RESERVED << 2, (RESERVED << 2) | 1
TAG_FINAL = 1
PAGE_KEY_STRIDE = 2048
MASK32 = 0xFFFFFFFF


def _mul_u32(x: np.ndarray, a: int) -> np.ndarray:
    return (x.astype(np.uint64) * np.uint64(a)) & np.uint64(MASK32)


def multiplier(seed: int) -> int:
    """The odd multiplier of multiply-shift hashing (splitmix-style)."""
    z = (seed + 0x9E3779B9) & MASK32
    z = ((z ^ (z >> 16)) * 0x85EBCA6B) & MASK32
    z = ((z ^ (z >> 13)) * 0xC2B2AE35) & MASK32
    z = z ^ (z >> 16)
    return (z | 1) & MASK32


def bucket(keys: np.ndarray, m: int, table_seed: int) -> np.ndarray:
    """Home cell of each key: the table's seed folded into the key
    (``key ^ seed * 0x9E3779B9``), multiply-shift to ``log2 m`` bits, or
    to 16 bits scaled by ``m`` when ``m`` is not a power of two."""
    mix = int(_mul_u32(np.array([table_seed & MASK32]), 0x9E3779B9)[0])
    x = _mul_u32((keys.astype(np.uint64) & np.uint64(MASK32))
                 ^ np.uint64(mix), multiplier(0))
    if m & (m - 1) == 0:
        k = m.bit_length() - 1
        return (x >> np.uint64(32 - k)).astype(np.int64) if k else \
            np.zeros(len(keys), np.int64)
    return (((x >> np.uint64(16)) * np.uint64(m) & np.uint64(MASK32))
            >> np.uint64(16)).astype(np.int64)


def judge(*, cells, num_keys, num_tombs, table_seed, block_table, seq_ids,
          pos, held, expected_pos, page_size) -> dict:
    """Counts of faults (0 each when the allocator is right).

    ``cells`` int32[m] the table words, ``block_table`` int32[B, P],
    ``seq_ids``/``pos`` int[B] the program's; ``held`` bool[B] which lanes
    hold a request and ``expected_pos`` int[B] their positions, both from
    the harness's record."""
    cells = np.asarray(cells).astype(np.int64) & MASK32
    m = cells.size
    bt = np.asarray(block_table).astype(np.int64)
    held = np.asarray(held, bool)
    pos = np.asarray(pos).astype(np.int64)
    seq_ids = np.asarray(seq_ids).astype(np.int64)
    out = {}
    out["lane_pos"] = int((held & (pos != np.asarray(expected_pos))).sum())

    tag, key = cells & 3, cells >> 2
    live = (key != RESERVED) & (tag == TAG_FINAL)
    odd = ~live & (cells != EMPTY) & (cells != TOMBSTONE)
    faults = int(odd.sum())
    faults += int(live.sum() != int(num_keys))
    faults += int((cells == TOMBSTONE).sum() != int(num_tombs))
    live_idx = np.nonzero(live)[0]
    live_keys = key[live_idx]
    faults += int(live_keys.size - np.unique(live_keys).size)
    # every live key reachable from its bucket without passing an EMPTY
    home = bucket(live_keys, m, int(table_seed))
    dist = (live_idx - home) % m
    empty2 = np.concatenate([[0], np.cumsum(np.tile(cells == EMPTY, 2))])
    faults += int((empty2[home + dist] - empty2[home] > 0).sum())

    n_pages = np.where(held, -(-pos // page_size), 0)
    expect = np.concatenate([s * PAGE_KEY_STRIDE + np.arange(n)
                             for s, n in zip(seq_ids, n_pages)] or
                            [np.zeros(0, np.int64)])
    faults += int(np.setxor1d(expect, live_keys).size)
    faults += int(np.unique(seq_ids[held]).size != int(held.sum()))
    out["page_table"] = faults

    where = dict(zip(live_keys.tolist(), live_idx.tolist()))
    P = bt.shape[1]
    want = np.full(bt.shape, -1, np.int64)
    for s in np.nonzero(held)[0]:
        for p in range(min(int(n_pages[s]), P)):
            want[s, p] = where.get(int(seq_ids[s]) * PAGE_KEY_STRIDE + p, -2)
    out["block_table"] = int((want != bt).sum())
    return out
