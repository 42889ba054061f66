"""Plain versions of the probe-lookup kernel.  ``probe_lookup_ref`` is the
batched table's ``find_batch``: the kernel must agree with it exactly on
(found, slot).  ``probe_walk_plain`` models the CUDA kernel's own rounds
(aligned 4-cell vectors, L-lane groups), so the CPU tests can hold that
structure to ``find_batch`` at every L.  It is a second copy of the round
logic of ``csrc/probe.cu``: change each with the other."""
from __future__ import annotations

import torch

from repro_torch.core import batched as BT
from repro_torch.core import encoding as E
from repro_torch.core import hashing as H
from repro_torch.kernels.probe.probe import SEED_MIX


def probe_lookup_ref(table: torch.Tensor, keys, seed: int):
    """table: int32[m] quiescent cells; keys: integer [B].
    Returns (found bool[B], slot int32[B])."""
    i32 = dict(dtype=torch.int32, device=table.device)
    ht = BT.HashTable(table=table, num_keys=torch.zeros((), **i32),
                      num_tombs=torch.zeros((), **i32),
                      seed=torch.tensor(seed, **i32),
                      meta=torch.zeros((0,), **i32))
    return BT.find_batch(ht, keys)


def probe_walk_plain(table: torch.Tensor, keys, seed, lanes: int):
    """The kernel's walk, round by round: a group of ``lanes`` lanes per
    key, each lane one aligned 4-cell vector a round.  The vectors cover
    [h & ~3, m) with the cells before h masked, then [0, h); a cell at or
    past m is never read.  The first hit or EMPTY in probe order decides.
    Returns (found bool[B], slot int32[B], rounds int64[B])."""
    m, dev = table.shape[0], table.device
    k = torch.as_tensor(keys, device=dev).to(torch.int64) & H.MASK32
    n = k.shape[0]
    mix = H.mul_u32(torch.as_tensor(seed, device=dev).to(torch.int64)
                    & H.MASK32, SEED_MIX)
    h = H.hash_keys(k ^ mix, m).to(torch.int64)          # ``BT._hash``
    target = (((k << 2) | E.TAG_FINAL) & H.MASK32).to(torch.int32)
    base = h & ~3
    nv1 = (m - base + 3) >> 2
    nv = nv1 + ((h + 3) >> 2)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    rounds = torch.zeros((n,), dtype=torch.int64, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    lane = torch.arange(lanes, device=dev)[None, :]
    j = torch.arange(4, device=dev)
    r = 0
    while bool(active.any()):
        v = r * lanes + lane                                   # [n, L]
        first_lap = v < nv1[:, None]
        p = torch.where(first_lap, base[:, None] + 4 * v,
                        4 * (v - nv1[:, None]))
        lo = torch.where(first_lap, h[:, None], 0)[..., None]
        hi = torch.where(first_lap, m, h[:, None])[..., None]
        cell = p[..., None] + j                                # [n, L, 4]
        live = (v < nv[:, None])[..., None] & (cell >= lo) & (cell < hi)
        vals = table[cell.clamp(0, m - 1)]
        hit = (live & (vals == target[:, None, None])).reshape(n, -1)
        end = (live & (vals == E.EMPTY)).reshape(n, -1)
        event = hit | end
        first = BT._first_true(event)[:, None]
        decided = active & event.any(dim=1)
        is_hit = decided & hit.gather(1, first)[:, 0]
        found = found | is_hit
        slot = torch.where(is_hit, cell.reshape(n, -1).gather(1, first)[:, 0]
                           .to(torch.int32), slot)
        rounds = torch.where(active, r + 1, rounds)
        active = active & ~decided & ((r + 1) * lanes < nv)
        r += 1
    return found, slot, rounds
