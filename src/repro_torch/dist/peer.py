"""The peer transport: ranks that share one device move the payloads of
their collectives through each other's buffers on that device, with no
copy through the host.

Each rank owns a fixed workspace of ``SLOTS`` slots of ``SLOT_BYTES``,
allocated once when the mesh is built: on the card, CUDA memory whose IPC
handle every other rank opens (the handles cross once, over the gloo
group, in the pickled form ``torch.multiprocessing.reductions`` gives a
CUDA tensor); on the CPU, one file in the temp directory mapped by every
rank.  Beside it, in shared host memory (such a file on the card too),
each rank has a mailbox per group of the mesh and its read counts.  A
collective moves its payload in rounds of at most one slot:

1. the rank waits until every reader of the slot's previous payload has
   finished reading it (below), writes its piece of the payload into that
   slot and makes the write visible (it records its interprocess
   ``written`` event on its stream);
2. it passes a host barrier on the collective's group: it stamps (round,
   slot, bytes) into its mailbox for the group and waits until every
   member has stamped the same round, which also tells it where to read
   (a gloo all-gather of the same 16 bytes cost 1.4-4.4 ms a round
   between 4 ranks sharing an H100's host: ``PERF.md``);
3. it reads its peers' slots with device copies, each after a wait of its
   stream on that peer's ``written`` event, records its own ``read``
   event and counts one read of each peer in shared host memory.

A mailbox keeps two stamps, alternating by round: a member stamps round
r + 1 only after it has read every member's stamp of round r.  The slots
alternate too, so round i + 1 writes while peers may still read round
i.  A writer reuses a slot only when every reader of its last
payload has counted that read (host memory) and its stream has waited on
those readers' ``read`` events: a peer's copies may still be queued on
the card when its host has moved on.  The counts make this hold whatever
groups the collectives run on, since a reader of round i need not be a
member of round i + 1's group.  Nothing in a round waits for the card on
the host: the order is kept on the device by the events.

The protocol is written once over the two buffers; on the CPU copies and
events are synchronous, and the tests run the same rounds, slots and
chunking there (``tests/test_torch_collectives.py``).  No backend
reduction is used: ``dist/collectives`` builds every reduction from the
gathered pieces in member order, as it does on gloo and NCCL.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# a rank's workspace: SLOTS x SLOT_BYTES on its device (128 MiB on the card)
SLOT_BYTES = 64 << 20
SLOTS = 2
# a writer waiting longer than this for a reader fails the collective
WAIT_TIMEOUT_S = 300.0


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a 1-D uint8 view."""
    return t.reshape(-1).view(torch.uint8)


def _shared_host(nbytes: int, rank: int) -> torch.Tensor:
    """``nbytes`` of zeroed host memory mapped by every rank of the
    process group: a file in the temp directory, unlinked once every rank
    has mapped it.  Collective over the default group."""
    path: List[Optional[str]] = [None]
    if rank == 0:
        fd, path[0] = tempfile.mkstemp(prefix="repro_peer_")
        os.close(fd)
        os.truncate(path[0], nbytes)
    dist.broadcast_object_list(path, src=0)
    buf = torch.from_file(path[0], shared=True, size=nbytes,
                          dtype=torch.uint8)
    dist.barrier()
    if rank == 0:
        os.unlink(path[0])
    return buf


class PeerTransport:
    """This rank's workspace and its views of every peer's, over the
    default process group (all ``world`` ranks on ``device``), with a
    mailbox for each of ``groups`` kinds of group (a mesh's axis
    combinations: each rank is a member of one group of each kind).
    Built collectively, in the same order on every rank."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 groups: int):
        self.rank, self.world, self.device = rank, world, device
        self.slot_bytes = SLOT_BYTES
        self.cuda = device.type == "cuda"
        ws = SLOTS * self.slot_bytes
        counts = world * world * 8
        boxes = world * groups * 2 * 3 * 8
        host = _shared_host(counts + boxes
                            + (0 if self.cuda else world * ws), rank)
        # reads[r, w]: how many of w's payloads rank r has finished reading
        self._reads_np = host[:counts].view(torch.int64).view(
            world, world).numpy()
        # box[r, g, round % 2] = (round + 1, slot, bytes): rank r's stamp
        # for its group of kind g
        self._box = host[counts:counts + boxes].view(torch.int64).view(
            world, groups, 2, 3).numpy()
        self._rounds = [0] * groups
        host = host[counts + boxes:]
        if self.cuda:
            from torch.multiprocessing.reductions import reduce_tensor
            own = torch.zeros(ws, dtype=torch.uint8, device=device)
            self._written = torch.cuda.Event(interprocess=True)
            self._read = torch.cuda.Event(interprocess=True)
            # one handle for each peer: torch counts a share's opens, and
            # frees the workspace once every share has been closed
            mine = ([None if r == rank else reduce_tensor(own)
                     for r in range(world)],
                    self._written.ipc_handle(), self._read.ipc_handle())
            every = [None] * world
            dist.all_gather_object(every, mine)
            self._ws, self._written_by, self._read_by = [], [], []
            for r, (shares, wh, rh) in enumerate(every):
                if r == rank:
                    self._ws.append(own)
                    self._written_by.append(self._written)
                    self._read_by.append(self._read)
                else:
                    fn, args = shares[rank]
                    self._ws.append(fn(*args))
                    self._written_by.append(
                        torch.cuda.Event.from_ipc_handle(device, wh))
                    self._read_by.append(
                        torch.cuda.Event.from_ipc_handle(device, rh))
            torch.cuda.synchronize(device)
        else:
            self._ws = list(host.view(world, ws).unbind(0))
        dist.barrier()
        self._slot = 0
        # per slot, the readers of its last payload and the read count
        # each must reach; per peer, the payloads offered to it so far
        self._need: List[dict] = [{} for _ in range(SLOTS)]
        self._offered = [0] * world

    # -- one round ----------------------------------------------------------

    def _slot_view(self, r: int, slot: int, start: int, n: int):
        base = slot * self.slot_bytes + start
        return self._ws[r][base:base + n]

    def _wait(self, done, what: str) -> None:
        """Spin until ``done()``; fail after ``WAIT_TIMEOUT_S``."""
        deadline = time.monotonic() + WAIT_TIMEOUT_S
        while not done():
            if time.monotonic() > deadline:
                raise RuntimeError(f"peer transport: rank {self.rank} "
                                   f"waited {WAIT_TIMEOUT_S} s for {what}")
            time.sleep(0)

    def _barrier(self, group: int, members: Sequence[int], slot: int,
                 n: int) -> dict:
        """Stamp this round into the mailbox of kind ``group`` and wait
        for every member's stamp of the same round; returns each member's
        (slot, bytes)."""
        r = self._rounds[group]
        self._rounds[group] = r + 1
        mine = self._box[self.rank, group, r % 2]
        mine[1], mine[2] = slot, n
        mine[0] = r + 1          # the stamp last: it publishes the rest
        where = {}
        for peer in members:
            box = self._box[peer, group, r % 2]
            self._wait(lambda: box[0] == r + 1,
                       f"rank {peer}'s round {r} of group kind {group}")
            where[peer] = (int(box[1]), int(box[2]))
        return where

    def _claim(self, slot: int) -> None:
        """Wait until every reader of ``slot``'s last payload has read it:
        its count in host memory, then (on the card) its read event."""
        for r, want in self._need[slot].items():
            self._wait(lambda: self._reads_np[r, self.rank] >= want,
                       f"rank {r} to read slot {slot}")
            if self.cuda:
                torch.cuda.current_stream(self.device).wait_event(
                    self._read_by[r])

    def round(self, group: int, members: Sequence[int],
              payload: Optional[torch.Tensor], readers: Sequence[int],
              reads: Sequence[Tuple[int, int, torch.Tensor]]) -> None:
        """One round on this rank's group of kind ``group``, of global
        ranks ``members`` (every member calls it): write ``payload``
        (uint8, at most one slot; None to write nothing) into this rank's
        next slot for the ranks ``readers``, pass the barrier, then fill
        each ``(peer, start, out)`` of ``reads`` (``out`` a 1-D uint8
        tensor) from ``peer``'s slot of this round at byte ``start``."""
        slot, n = -1, 0
        if payload is not None:
            n = payload.numel()
            if n > self.slot_bytes:
                raise ValueError(f"peer round of {n} bytes > one slot "
                                 f"({self.slot_bytes})")
            slot = self._slot
            self._claim(slot)
            self._slot_view(self.rank, slot, 0, n).view(
                payload.shape).copy_(payload)
            if self.cuda:
                self._written.record(torch.cuda.current_stream(self.device))
            need = {}
            for r in readers:
                self._offered[r] += 1
                need[r] = self._offered[r]
            self._need[slot] = need
            self._slot = (slot + 1) % SLOTS
        where = self._barrier(group, members, slot, n)
        peers = []
        for peer, start, out in reads:
            ps, pn = where[peer]
            if ps < 0 or start + out.numel() > pn:
                raise RuntimeError(
                    f"peer transport: rank {self.rank} reads bytes "
                    f"[{start}, {start + out.numel()}) of rank {peer}'s "
                    f"payload of {pn} (slot {ps}): the members disagree")
            if self.cuda:
                torch.cuda.current_stream(self.device).wait_event(
                    self._written_by[peer])
            out.copy_(self._slot_view(peer, ps, start, out.numel()))
            if peer not in peers:
                peers.append(peer)
        if peers:
            if self.cuda:
                self._read.record(torch.cuda.current_stream(self.device))
            for peer in peers:
                self._reads_np[self.rank, peer] += 1

    # -- the four data-moving primitives --------------------------------------

    def gather(self, x: torch.Tensor, group: int, members: Sequence[int]
               ) -> torch.Tensor:
        """Every member's ``x`` stacked on a new dim 0 in member order."""
        n, me = len(members), members.index(self.rank)
        src = as_bytes(x)
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        nb = src.numel()
        if nb == 0:
            return out
        ob = as_bytes(out).view(n, nb)
        ob[me].copy_(src)
        others = [p for p in members if p != self.rank]
        for a in range(0, nb, self.slot_bytes):
            b = min(a + self.slot_bytes, nb)
            self.round(group, members, src[a:b], others,
                       [(p, 0, ob[j, a:b]) for j, p in enumerate(members)
                        if p != self.rank])
        return out

    def all_to_all(self, x: torch.Tensor, group: int,
                   members: Sequence[int]
                   ) -> torch.Tensor:
        """Chunk s of dim 0 of this rank's ``x`` to member s; the result
        holds member s's chunk for this rank at chunk s."""
        n, me = len(members), members.index(self.rank)
        out = torch.empty_like(x)
        if x.numel() == 0:
            return out
        src = as_bytes(x).view(n, -1)
        ob = as_bytes(out).view(n, -1)
        ob[me].copy_(src[me])
        c = src.shape[1]
        per = max(1, self.slot_bytes // n)
        others = [p for p in members if p != self.rank]
        for a in range(0, c, per):
            b = min(a + per, c)
            self.round(group, members, src[:, a:b], others,
                       [(p, me * (b - a), ob[j, a:b])
                        for j, p in enumerate(members) if p != self.rank])
        return out

    def gather_to_root(self, x: torch.Tensor, root: int, group: int
                       ) -> Optional[List[torch.Tensor]]:
        """Every rank's ``x`` at ``root``, in rank order, copied to the host
        once there; None elsewhere (``group``: the kind holding every
        rank)."""
        members = list(range(self.world))
        src = as_bytes(x)
        nb = src.numel()
        out = ob = None
        if self.rank == root:
            out = torch.empty((self.world,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device)
            if nb:
                ob = as_bytes(out).view(self.world, nb)
                ob[root].copy_(src)
        for a in range(0, nb, self.slot_bytes):
            b = min(a + self.slot_bytes, nb)
            if self.rank == root:
                self.round(group, members, None, [],
                           [(p, 0, ob[p, a:b]) for p in members
                            if p != root])
            else:
                self.round(group, members, src[a:b], [root], [])
        return None if out is None else list(out.cpu().unbind(0))

    def ppermute(self, x: torch.Tensor, group: int, members: Sequence[int],
                 dst: Optional[int], src: Optional[int]) -> torch.Tensor:
        """Send ``x`` to member ``dst`` and return what member ``src``
        sent (zeros without a source)."""
        data = as_bytes(x)
        out = torch.zeros_like(x)
        ob = as_bytes(out)
        nb = data.numel()
        for a in range(0, nb, self.slot_bytes):
            b = min(a + self.slot_bytes, nb)
            self.round(group, members,
                       None if dst is None else data[a:b],
                       [] if dst is None else [members[dst]],
                       [] if src is None else [(members[src], 0, ob[a:b])])
        return out
