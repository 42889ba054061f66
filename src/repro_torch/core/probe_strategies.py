"""ProbeStrategy: the probe order / claim arbitration / deletion contract
(PyTorch port of ``core/probe_strategies.py``).

Three strategies, each bitwise the reference's (tables, ``meta``,
counters and return codes):

``linear``
    The paper's algorithm, inline in ``core/batched.py``.

``robinhood``
    The same probe sequence, tombstone deletion and lookups as linear; the
    scatter-min priority of the shared claim loop is the displacement
    first, batch index second: ``(m - 1 - cursor) * B + lane`` in int32
    with the sentinel ``m * B`` (so ``m * B < 2**31``, asserted as in the
    reference).  A key's run still holds no EMPTY cell, so the probe
    kernel's EMPTY-terminated walk stays exact (``kernel_supported``).

``hopscotch``
    ``meta[h]`` is a uint32 bitmap (carried in an int32 word: bit 31 is
    the sign bit) — bit d set iff cell ``(h + d) mod m`` holds a key homed
    at h, ``d < H = min(32, m)``.  Lookups gather at most H cells; deletes
    return the cell to EMPTY and clear the home bit (no tombstones);
    inserts claim the first EMPTY cell of the neighbourhood by scatter-min,
    and a lane whose neighbourhood is full hops the first EMPTY cell
    backwards by relocating residents inside their own neighbourhoods.
    Bits are ORed by a scatter-add of powers of two, exact because the
    added bits of one word are distinct; it is accumulated in int64 and
    wrapped to int32 (``batched.wrap_i32``).

The displacement loop is sequential by design: one lane per arbitration
round, a hop loop inside it.  Each round and each hop is one counted host
sync (``device.host_numpy`` / ``host_bool``; ``batched.ROUND_STATS``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import batched as BT
from repro_torch.core import encoding as E
from repro_torch.device import host_bool, host_numpy, to_card

# Hopscotch neighbourhood size: capped by the uint32 bitmap carrier.
# Tables smaller than 32 cells use H = m.
H_NEIGHBORHOOD = 32


class ProbeStrategy:
    """The contract a probe strategy satisfies:

    * ``find_batch`` is wait-free: pure vectorized reads.
    * ``insert_batch``/``delete_batch`` leave the table quiescent and equal
      to a sequential execution of some serialization of the batch.
    * ``num_keys``/``num_tombs`` stay exact; ``forecast_slack`` is the
      extra headroom the forecaster must hold for the no-ABORT proof.
    """

    name: str = ""
    #: deletes leave TOMBSTONE cells (reused by inserts, Prop. 2)
    uses_tombstones: bool = True
    #: the probe kernel (kernels/probe) assumes this probe order
    kernel_supported: bool = False

    def forecast_slack(self, n_pages: int) -> int:
        return 0

    def init_meta(self, m: int, device=None) -> torch.Tensor:
        """Per-entry metadata (int32 words; empty for metadata-free
        strategies)."""
        return torch.zeros((0,), dtype=torch.int32, device=device)

    def find_batch(self, ht, keys, active=None):
        raise NotImplementedError

    def insert_batch(self, ht, keys, active=None, claim_tombstones=True):
        raise NotImplementedError

    def delete_batch(self, ht, keys, active=None):
        raise NotImplementedError


class LinearStrategy(ProbeStrategy):
    name = "linear"
    uses_tombstones = True
    kernel_supported = True

    def find_batch(self, ht, keys, active=None):
        return BT.find_batch(ht, keys, active, strategy="linear")

    def insert_batch(self, ht, keys, active=None, claim_tombstones=True):
        return BT.insert_batch(ht, keys, active, claim_tombstones,
                               strategy="linear")

    def delete_batch(self, ht, keys, active=None):
        return BT.delete_batch(ht, keys, active, strategy="linear")


class RobinHoodStrategy(LinearStrategy):
    name = "robinhood"
    kernel_supported = True

    def insert_batch(self, ht, keys, active=None, claim_tombstones=True):
        """Linear's claim loop with displacement as the priority: at every
        round a pending lane's displacement IS its cursor, so the furthest
        travelled lane wins each contested cell, batch index breaking
        ties."""
        m = BT.size(ht)
        B = torch.as_tensor(keys).shape[0]
        # priority fits int32: displacement < m, tiebreak < B
        assert m * B < 2**31, "robinhood priority key overflows int32"
        lane = torch.arange(B, dtype=torch.int64, device=ht.table.device)

        def priority(cursor):
            disp = cursor.clamp(0, m - 1)
            return ((m - 1 - disp) * B + lane).to(torch.int32)

        return BT._claim_insert(ht, keys, active, claim_tombstones,
                                priority, sentinel=m * B)


class HopscotchStrategy(ProbeStrategy):
    name = "hopscotch"
    uses_tombstones = False
    kernel_supported = False

    def neighborhood(self, m: int) -> int:
        return min(H_NEIGHBORHOOD, m)

    def forecast_slack(self, n_pages: int) -> int:
        # the neighbourhood covers the table: near-claim sees every EMPTY
        # cell, inserts abort only on a full pool, no slack needed
        if n_pages <= H_NEIGHBORHOOD:
            return 0
        # otherwise displacement can fail with ~H contiguous live cells
        # blocking a neighbourhood while free cells exist elsewhere
        return H_NEIGHBORHOOD

    def init_meta(self, m: int, device=None) -> torch.Tensor:
        return torch.zeros((m,), dtype=torch.int32, device=device)

    # -- lookup: gather <= H bitmap-indicated cells; wait-free, bounded.

    def find_batch(self, ht, keys, active=None):
        keys = BT._keys(ht, keys)
        dev = ht.table.device
        m = BT.size(ht)
        B = keys.shape[0]
        Hn = self.neighborhood(m)
        act = BT._active_mask(B, active, dev)
        hv = BT._hash(ht, keys).to(torch.int64)
        d = torch.arange(Hn, dtype=torch.int64, device=dev)
        pos = torch.remainder(hv[:, None] + d[None, :], m)      # [B, Hn]
        # int32 >> d sign-extends, but & 1 reads bit d for every d < 32
        member = ((ht.meta[hv].to(torch.int64)[:, None] >> d[None, :])
                  & 1) == 1
        target = BT._final_word(keys)
        hit = member & (ht.table[pos] == target[:, None]) & act[:, None]
        found = hit.any(dim=1)
        first = BT._first_true(hit)
        slot = torch.where(found, pos.gather(1, first[:, None])[:, 0],
                           -1).to(torch.int32)
        return found, slot

    # -- delete: cell -> EMPTY, clear the home bit.  No tombstones.

    def delete_batch(self, ht, keys, active=None):
        keys = BT._keys(ht, keys)
        dev = ht.table.device
        m = BT.size(ht)
        B = keys.shape[0]
        act = BT._active_mask(B, active, dev)
        hv = BT._hash(ht, keys).to(torch.int64)
        found, slot = self.find_batch(ht, keys, act)
        leader = BT._dedup_leaders(keys, act)
        win = found & leader
        slot = slot.to(torch.int64)
        table = _with_trash(ht.table, E.EMPTY)
        table[torch.where(win, slot, m)] = to_card(E.EMPTY, dev,
                                                   torch.int32)
        # winners hold distinct slots, so per home bucket each cleared bit
        # is distinct and a scatter-ADD of powers of two equals the OR
        d = torch.remainder(slot - hv, m).clamp(max=31)
        bit = torch.where(win, torch.ones_like(d) << d, 0)
        clear = torch.zeros((m + 1,), dtype=torch.int64, device=dev)
        clear.index_add_(0, torch.where(win, hv, m), bit)
        meta = _u32(ht.meta) & ~clear[:m]
        ht2 = ht._replace(table=table[:m], meta=BT.wrap_i32(meta),
                          num_keys=(ht.num_keys - win.sum()).to(torch.int32))
        return ht2, win.to(torch.int32)

    # -- insert: in-neighbourhood scatter-min claims; hop displacement for
    #    lanes whose first EMPTY lies outside, one lane per round.

    def insert_batch(self, ht, keys, active=None, claim_tombstones=True):
        # claim_tombstones is meaningless here (deletes never tombstone);
        # accepted for API uniformity
        del claim_tombstones
        keys = BT._keys(ht, keys)
        dev = ht.table.device
        m = BT.size(ht)
        B = keys.shape[0]
        Hn = self.neighborhood(m)
        act = BT._active_mask(B, active, dev)
        hv = BT._hash(ht, keys).to(torch.int64)
        leader = BT._dedup_leaders(keys, act)
        present, _ = self.find_batch(ht, keys, act)
        lane = torch.arange(B, dtype=torch.int32, device=dev)
        target = BT._final_word(keys)
        doff = torch.arange(Hn, dtype=torch.int64, device=dev)

        table = _with_trash(ht.table, E.EMPTY)          # row m = trash
        meta = _with_trash(_u32(ht.meta), 0)            # int64 uint32 words
        pending = leader & ~present
        placed = torch.zeros((B,), dtype=torch.bool, device=dev)
        aborted = torch.zeros((B,), dtype=torch.bool, device=dev)
        while True:
            # one data-parallel round of in-neighbourhood claims
            pos = torch.remainder(hv[:, None] + doff[None, :], m)  # [B, Hn]
            empty = table[pos] == E.EMPTY
            has = empty.any(dim=1) & pending
            first = BT._first_true(empty)
            cand = pos.gather(1, first[:, None])[:, 0]
            claims = torch.full((m + 1,), B, dtype=torch.int32, device=dev)
            claims.scatter_reduce_(0, torch.where(has, cand, m), lane,
                                   reduce="amin")
            won = has & (claims[cand] == lane)
            table[torch.where(won, cand, m)] = target
            # same home bucket => same first-EMPTY target => one winner per
            # bucket per round, so the scatter-ADD of the bit is the OR
            setmask = torch.zeros((m + 1,), dtype=torch.int64, device=dev)
            setmask.index_add_(0, torch.where(won, hv, m),
                               torch.where(won, torch.ones_like(first)
                                           << first, 0))
            meta = meta | setmask
            pending = pending & ~won
            placed = placed | won
            # one sync a round: anything pending, did any lane win, and the
            # lowest pending lane (displacement runs only when NO lane can
            # claim in-neighbourhood)
            more, any_won, b = (int(x) for x in host_numpy(torch.stack([
                pending.any().to(torch.int64), won.any().to(torch.int64),
                torch.where(pending, lane, B).min().to(torch.int64)])))
            BT.ROUND_STATS["claim_rounds"] += 1
            if not more:
                break
            if not any_won:
                ok = self._displace_one(ht, table, meta, hv[b:b + 1],
                                        target[b:b + 1], m, Hn)
                placed[b:b + 1] |= ok
                aborted[b:b + 1] |= ~ok
                pending[b] = False

        ret = BT._finalize_insert_ret(keys, act, leader, present, placed,
                                      aborted)
        ht2 = ht._replace(table=table[:m], meta=BT.wrap_i32(meta[:m]),
                          num_keys=(ht.num_keys + placed.sum()).to(
                              torch.int32))
        return ht2, ret

    def _displace_one(self, ht, table, meta, home, word, m: int, Hn: int):
        """Resolve one lane whose whole neighbourhood is full: claim the
        first EMPTY past the home bucket and hop it backwards by relocating
        residents within their own neighbourhoods.  ``home`` and ``word``
        are one-element tensors.  Writes ``table`` and ``meta`` (both with
        a trash row at m) in place; returns ok (bool[1]) — False is an
        ABORT."""
        BT.ROUND_STATS["displacements"] += 1
        dev = table.device
        if Hn >= m:
            # the neighbourhood covers the table, so near-claim saw every
            # EMPTY cell: the table is full -> ABORT
            return torch.zeros((1,), dtype=torch.bool, device=dev)
        one = torch.ones((1,), dtype=torch.int64, device=dev)
        idx = torch.arange(m, dtype=torch.int64, device=dev)
        dist_all = torch.remainder(idx - home, m)
        dmin = torch.where(table[:m] == E.EMPTY, dist_all, m).min()[None]
        stuck = dmin >= m                 # table completely full -> ABORT
        j = torch.remainder(home + dmin.clamp(max=m - 1), m)
        dist_j = torch.remainder(j - home, m)
        off = torch.arange(1, Hn, dtype=torch.int64, device=dev)
        while host_bool(((dist_j >= Hn) & ~stuck)[0]):
            BT.ROUND_STATS["hops"] += 1
            # candidates i = j - off: all non-EMPTY (j is the first EMPTY
            # from home and dist_j >= Hn keeps them in [home, j))
            i = torch.remainder(j - off, m)
            rhome = BT._hash(ht, E.dec_key(table[i])).to(torch.int64)
            movable = torch.remainder(j - rhome, m) < Hn
            any_mov = movable.any()[None]
            # the furthest-back movable resident maximizes progress
            isel = torch.remainder(
                j - torch.where(movable, off, 0).max()[None], m)
            moved = table[isel]
            h_k = BT._hash(ht, E.dec_key(moved)).to(torch.int64)
            old_d = torch.remainder(isel - h_k, m).clamp(max=31)
            new_d = torch.remainder(j - h_k, m).clamp(max=31)
            mword = (meta[h_k] & ~(one << old_d)) | (one << new_d)
            table[torch.where(any_mov, j, m)] = moved
            table[torch.where(any_mov, isel, m)] = to_card(
                E.EMPTY, dev, torch.int32)
            meta[torch.where(any_mov, h_k, m)] = mword
            j = torch.where(any_mov, isel, j)
            dist_j = torch.remainder(j - home, m)
            stuck = stuck | ~any_mov
        ok = ~stuck
        table[torch.where(ok, j, m)] = word
        mword = meta[home] | (one << dist_j.clamp(max=31))
        meta[torch.where(ok, home, m)] = mword
        return ok


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words as int64 holding their uint32 values."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _with_trash(x: torch.Tensor, fill) -> torch.Tensor:
    """A copy of ``x`` with one trash row appended (index ``len(x)``)."""
    return torch.cat([x, torch.full((1,), fill, dtype=x.dtype,
                                    device=x.device)])


STRATEGIES: Dict[str, ProbeStrategy] = {
    s.name: s for s in (LinearStrategy(), RobinHoodStrategy(),
                        HopscotchStrategy())
}


def get_strategy(name: str) -> ProbeStrategy:
    try:
        return STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown probe strategy {name!r}; expected one of "
            f"{sorted(STRATEGIES)}") from None
