"""Named-axis collectives over ``torch.distributed``: the port's stand-in
for ``jax.lax.psum`` / ``pmax`` / ``all_gather`` / ``all_to_all`` /
``ppermute`` / ``psum_scatter`` / ``axis_index`` inside the reference's
``shard_map`` bodies.

The port runs SPMD: one process per rank, every rank running the same
program on its own shards.  A ``Mesh`` names the axes of the process
group's ranks, row-major (rank r sits at the coordinates of r in the mesh
shape, the last axis fastest, as ``jax.make_mesh`` orders its devices).
For every combination of axes (whose size is above 1) the mesh builds one
``torch.distributed`` subgroup per coordinate of the other axes; the
subgroups are built once, in a fixed order, on every rank, because
``new_group`` is collective.  A collective over a tuple of axes runs on
the subgroup of this rank's coordinates, whose member order is the
row-major index over those axes (the reference's ``_chip_idx``).

Every reduction is a gather followed by a sum (or max) over the members
in that fixed order, computed the same way on every rank: all members end
with the same bits, and the sum's order does not depend on the backend's
algorithm.  The o partial of ``paged.merge_global`` is summed in bf16, as
in the reference, by adding bf16 tensors in member order.
``reduce_scatter`` is an ``all_to_all`` of the chunks followed by the same
member-order sum at each chunk's owner: it gives the bits of ``psum``'s
chunk without gathering n full copies.

Three transports move the bytes, one per mesh, fixed by where its ranks
are (``transport_for``; ``launch/mesh.card_of`` places them):

- ``"gloo"`` for ranks on the CPU: gloo's ``all_gather``,
  ``all_to_all_single``, ``gather`` and ``isend``/``irecv`` on host
  tensors.
- ``"peer"`` for ranks that share one card (NCCL refuses two ranks on
  one device): the payloads go through each rank's workspace on the card,
  opened by the others through CUDA IPC, with a barrier a round in
  shared host memory (``dist/peer``).
- ``"nccl"`` for ranks with a card each: ``all_gather_into_tensor`` and
  ``all_to_all_single`` on card tensors in NCCL subgroups built beside
  the gloo ones (``ppermute`` and ``gather_to_root`` are all-to-alls with
  one nonzero split).

A mesh's transport moves the tensors on the mesh's device; a host tensor
on a card mesh (the mesh DHT's CPU twin) takes gloo.  A mesh may be built
on the card with ``transport="gloo"`` to check one transport against
another: a collective on a CUDA tensor is then STAGED through the host
(copied out, gloo, copied back) and counted as such.  No transport uses
a backend's reduction, so all three give the same bits.  Every subgroup
keeps its gloo group, under every transport: it carries the host tensors
and the small host exchanges (the placement, the peer buffers' handles).
``gather_to_root``'s result is on the host at the root (a
checkpoint writes it): on the card its pieces meet on the card and cross
to the host once, at the root.

``COLLECTIVE_STATS`` counts the calls and the staged ones, and per op
(``by_op``) the calls and the bytes this rank put on the wire and took off
it, summed over the other members (a gather of x over n ranks sends x to
n - 1 of them; an all-to-all sends n - 1 of its n chunks), the same in
every transport; nothing falls back quietly.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist import peer as PEER

COLLECTIVE_STATS = {"calls": 0, "staged": 0, "by_op": {}}

_MESH: Optional["Mesh"] = None


class AbstractMesh:
    """A mesh's axis names and sizes, with no process behind it (the
    rule tables and the production shape only need these)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(n) for n in shape)))
        self.size = 1
        for n in self.shape.values():
            self.size *= n

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of ``rank`` (row-major, the last axis
        fastest)."""
        coords = {}
        for a in reversed(self.axis_names):
            coords[a] = rank % self.shape[a]
            rank //= self.shape[a]
        return {a: coords[a] for a in self.axis_names}

    def axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name or a tuple of names) in mesh order, without
        the axes of size 1."""
        if isinstance(axes, str):
            axes = (axes,)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"no mesh axis {a!r} in {self.shape}")
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)


class RecordingMesh(AbstractMesh):
    """A mesh of shape only, bound as one rank (coordinates 0) on the
    ``meta`` device: its collectives move nothing and return ``meta``
    tensors of the right shapes, and ``COLLECTIVE_STATS`` counts them as
    a real rank would.  The dry-run runs a step on it to record the step's
    collectives without allocating anything."""
    recording = True

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        super().__init__(shape, axis_names)
        self.device = torch.device("meta")
        self.rank = 0
        self.coords: Dict[str, int] = {a: 0 for a in self.axis_names}


def transport_for(device_type: str, cards: Sequence[int]) -> str:
    """The transport of a mesh whose ranks sit on ``cards`` (rank r on
    card ``cards[r]``): gloo on the CPU, the peer buffers where the ranks
    share one card, NCCL where each has its own."""
    if device_type != "cuda":
        return "gloo"
    if len(set(cards)) == 1:
        return "peer"
    if len(set(cards)) == len(cards):
        return "nccl"
    raise ValueError(f"ranks on cards {list(cards)}: neither one card "
                     f"shared by all nor one card a rank")


class Mesh(AbstractMesh):
    """The named mesh over the initialised default process group (or over
    one process when the mesh has a single rank and no group exists).
    ``device`` is where this rank's tensors live; ``transport`` follows
    from where the ranks are (``transport_for``) unless named, which is
    only for checking one transport against another."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device="cpu", transport: Optional[str] = None):
        super().__init__(shape, axis_names)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if dist.is_available() and dist.is_initialized():
            world, rank = dist.get_world_size(), dist.get_rank()
        else:
            world, rank = 1, 0
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, "
                             f"the process group has {world}")
        self.rank = rank
        self.coords: Dict[str, int] = self.coords_of(rank)
        cards = [self.device.index] * world
        if self.device.type == "cuda" and world > 1:
            dist.all_gather_object(cards, self.device.index)
        placed = transport_for(self.device.type, cards)
        # gloo moves anything; the peer buffers work over host memory too
        allowed = {placed, "gloo"} | ({"peer"} if self.device.type == "cpu"
                                      else set())
        if transport is None:
            transport = placed
        elif transport not in allowed:
            raise ValueError(f"transport {transport!r}: ranks on "
                             f"{self.device.type} {cards} take one of "
                             f"{sorted(allowed)}")
        self.transport = transport
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._members: Dict[Tuple[str, ...], List[int]] = {}
        self._nccl: Dict[Tuple[str, ...], object] = {}
        self._nccl_world = None
        if transport == "nccl" and world > 1:
            self._nccl_world = dist.new_group(list(range(world)),
                                              backend="nccl")
        names = [a for a in self.axis_names if self.shape[a] > 1]
        # the axis combinations in one fixed order; a combination's place
        # in it names its groups' mailboxes in the peer transport
        self._kinds = [axes for k in range(1, len(names) + 1)
                       for axes in itertools.combinations(names, k)]
        for axes in self._kinds:
            self._build_groups(axes, world)
        self.peer = (PEER.PeerTransport(rank, world, self.device,
                                        len(self._kinds))
                     if transport == "peer" and world > 1 else None)

    def _build_groups(self, axes: Tuple[str, ...], world: int) -> None:
        others = [a for a in self.axis_names if a not in axes]
        n = 1
        for a in axes:
            n *= self.shape[a]
        for oc in itertools.product(*(range(self.shape[a]) for a in others)):
            fixed = dict(zip(others, oc))
            ranks = []
            for ic in itertools.product(*(range(self.shape[a])
                                          for a in axes)):
                c = {**fixed, **dict(zip(axes, ic))}
                ranks.append(self.rank_of(c))
            group = (dist.group.WORLD if n == world
                     else dist.new_group(ranks=ranks, backend="gloo"))
            nccl = None
            if self.transport == "nccl":
                nccl = (self._nccl_world if n == world
                        else dist.new_group(ranks=ranks, backend="nccl"))
            if self.rank in ranks:
                self._groups[axes] = group
                self._members[axes] = ranks
                self._nccl[axes] = nccl

    def group(self, axes: Tuple[str, ...]):
        return self._groups[axes]

    def members(self, axes: Tuple[str, ...]) -> List[int]:
        """The global ranks of this rank's group over ``axes``, in member
        order."""
        return self._members[axes]

    def kind(self, axes: Tuple[str, ...]) -> int:
        """The index of the axis combination ``axes`` (its groups'
        mailboxes in the peer transport); the last holds every rank."""
        return self._kinds.index(axes)

    def route(self, x: torch.Tensor) -> str:
        """The transport that moves ``x``: the mesh's for tensors on its
        device type, gloo for the rest."""
        return (self.transport if x.device.type == self.device.type
                else "gloo")


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Bind this process's mesh: the axis names below resolve on it."""
    global _MESH
    _MESH = mesh


def current_mesh() -> Mesh:
    if _MESH is None:
        raise RuntimeError("no mesh is bound in this process "
                           "(launch.mesh.make_mesh binds one)")
    return _MESH


def _ordered(axes) -> Tuple[str, ...]:
    """``axes`` as given (the index order of ``axis_index``)."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(axes) -> int:
    mesh = current_mesh()
    n = 1
    for a in _ordered(axes):
        n *= mesh.shape[a]
    return n


def axis_index(axes) -> int:
    """This rank's row-major index over ``axes`` in the order given (the
    reference's ``axis_index`` for one axis, ``_chip_idx`` for several)."""
    mesh = current_mesh()
    idx = 0
    for a in _ordered(axes):
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


def reset_stats() -> None:
    """Zero ``COLLECTIVE_STATS``."""
    COLLECTIVE_STATS.update(calls=0, staged=0, by_op={})


def _count(op: str, sent: int, received: int, staged: bool) -> None:
    COLLECTIVE_STATS["calls"] += 1
    if staged:
        COLLECTIVE_STATS["staged"] += 1
    e = COLLECTIVE_STATS["by_op"].setdefault(
        op, {"calls": 0, "sent": 0, "received": 0})
    e["calls"] += 1
    e["sent"] += int(sent)
    e["received"] += int(received)


def _members(axes) -> Tuple[Tuple[str, ...], int]:
    """The axes of size > 1 (required in mesh order) and their rank
    count."""
    mesh = current_mesh()
    names = mesh.axes(axes)
    if names != tuple(a for a in _ordered(axes) if a in names):
        raise ValueError(f"collective over {axes}: give the axes in mesh "
                         f"order {mesh.axis_names}")
    n = 1
    for a in names:
        n *= mesh.shape[a]
    return names, n


def _gather(x: torch.Tensor, axes, op: str = "all_gather"
            ) -> Optional[torch.Tensor]:
    """The members' ``x`` stacked on a new dim 0 in member order, on x's
    device; None when the axes hold one rank."""
    mesh = current_mesh()
    names, n = _members(axes)
    if not names:
        return None
    if getattr(mesh, "recording", False):
        moved = (n - 1) * x.numel() * x.element_size()
        _count(op, moved, moved, False)
        return x.detach().new_empty((n,) + tuple(x.shape))
    src = x.detach().contiguous()
    moved = (n - 1) * src.numel() * src.element_size()
    route = mesh.route(src)
    _count(op, moved, moved, route == "gloo" and src.device.type != "cpu")
    if route == "peer":
        return mesh.peer.gather(src, mesh.kind(names), mesh.members(names))
    if route == "nccl":
        out = torch.empty((n,) + tuple(src.shape), dtype=src.dtype,
                          device=src.device)
        if src.numel():
            dist.all_gather_into_tensor(PEER.as_bytes(out),
                                        PEER.as_bytes(src),
                                        group=mesh._nccl[names])
        return out
    host = src.cpu()
    out = torch.empty((n,) + tuple(host.shape), dtype=host.dtype)
    dist.all_gather(list(out.unbind(0)), host, group=mesh.group(names))
    return out.to(x.device)


def _member_sum(parts: torch.Tensor) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` in member order."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum over the ranks of ``axes``, in member order, in x's dtype."""
    parts = _gather(x, axes, "psum")
    return x if parts is None else _member_sum(parts)


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    parts = _gather(x, axes, "pmax")
    return x if parts is None else parts.amax(dim=0)


def all_gather(x: torch.Tensor, axes, dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim`` (``tiled``) or stacked
    at ``dim``, in member order."""
    parts = _gather(x, axes)
    if parts is None:
        return x if tiled else x.unsqueeze(dim)
    if tiled:
        return torch.cat(list(parts.unbind(0)), dim=dim)
    return torch.stack(list(parts.unbind(0)), dim=dim)


def all_to_all(x: torch.Tensor, axes) -> torch.Tensor:
    """Tiled all-to-all on dim 0 (``split_axis = concat_axis = 0``): chunk
    s of this rank's ``x`` goes to member s, and the result holds member
    s's chunk for this rank at chunk s."""
    mesh = current_mesh()
    names, n = _members(axes)
    if not names:
        return x
    return _all_to_all(x, mesh, names, n, "all_to_all")


def _all_to_all(x: torch.Tensor, mesh, names, n: int,
                op: str) -> torch.Tensor:
    if getattr(mesh, "recording", False):
        moved = (n - 1) * (x.numel() // n) * x.element_size()
        _count(op, moved, moved, False)
        return x.detach().new_empty(x.shape)
    src = x.detach().contiguous()
    moved = (n - 1) * (src.numel() // n) * src.element_size()
    route = mesh.route(src)
    _count(op, moved, moved, route == "gloo" and src.device.type != "cpu")
    if route == "peer":
        return mesh.peer.all_to_all(src, mesh.kind(names),
                                    mesh.members(names))
    if route == "nccl":
        out = torch.empty_like(src)
        if src.numel():
            dist.all_to_all_single(PEER.as_bytes(out), PEER.as_bytes(src),
                                   group=mesh._nccl[names])
        return out
    host = src.cpu()
    out = torch.empty_like(host)
    dist.all_to_all_single(out, host, group=mesh.group(names))
    return out.to(x.device)


def _nccl_send_one(src: torch.Tensor, out: torch.Tensor, group, n: int,
                   dst: Optional[int], srcs: Sequence[int]) -> None:
    """One NCCL all-to-all over ``n`` members that moves ``src``'s bytes
    to member ``dst`` only (None: to nobody) and fills ``out``'s bytes
    from the members ``srcs`` in order: point-to-point traffic as one
    collective, so no rank waits on a send that its peer posts later."""
    sb = PEER.as_bytes(src) if dst is not None else src.new_empty(
        0, dtype=torch.uint8)
    nb = PEER.as_bytes(src).numel()
    ob = PEER.as_bytes(out) if srcs else out.new_empty(0, dtype=torch.uint8)
    dist.all_to_all_single(
        ob, sb, output_split_sizes=[nb if j in srcs else 0
                                    for j in range(n)],
        input_split_sizes=[nb if j == dst else 0 for j in range(n)],
        group=group)


def gather_to_root(x: torch.Tensor, root: int = 0
                   ) -> Optional[List[torch.Tensor]]:
    """Every rank's ``x`` (one shape on every rank) on rank ``root`` of
    the bound mesh, in rank order, on the host; None on the other ranks.
    Each rank's bytes cross once (a checkpoint's save, where only the
    writer needs the whole): on gloo one ``gather`` over the process
    group; on the card the pieces meet at the root's card, which copies
    them to the host once."""
    mesh = current_mesh()
    src = x.detach().contiguous()
    if mesh.size == 1:
        return [src.cpu()]
    nbytes = src.numel() * src.element_size()
    route = mesh.route(src)
    _count("gather", 0 if mesh.rank == root else nbytes,
           (mesh.size - 1) * nbytes if mesh.rank == root else 0,
           route == "gloo" and src.device.type != "cpu")
    if route == "peer":
        return mesh.peer.gather_to_root(src, root, len(mesh._kinds) - 1)
    if route == "nccl":
        out = (torch.empty((mesh.size,) + tuple(src.shape), dtype=src.dtype,
                           device=src.device)
               if mesh.rank == root else src.new_empty(0))
        if nbytes:
            _nccl_send_one(src, out, mesh._nccl_world, mesh.size, root,
                           list(range(mesh.size)) if mesh.rank == root
                           else [])
        return list(out.cpu().unbind(0)) if mesh.rank == root else None
    host = src.cpu()
    out = ([torch.empty_like(host) for _ in range(mesh.size)]
           if mesh.rank == root else None)
    dist.gather(host, out, dst=root)
    return out


def reduce_scatter(x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
    """The sum over the ranks of ``axes`` of ``x``, cut along ``dim`` into
    one chunk per member: this rank gets the chunk of its member index
    (``jax.lax.psum_scatter(..., tiled=True)``).  Chunk s of every member
    goes to member s (one ``all_to_all``), which sums the n pieces in
    member order: the bits of ``psum(x, axes)``'s chunk, with one x's
    bytes on the wire instead of n."""
    mesh = current_mesh()
    names, n = _members(axes)
    if not names:
        return x
    d = dim % x.dim()
    if x.shape[d] % n:
        raise ValueError(f"reduce_scatter over {names}: dim {d} of "
                         f"{tuple(x.shape)} not divisible by {n}")
    xs = x.movedim(d, 0)
    rest = tuple(xs.shape[1:])
    chunks = xs.reshape((n, xs.shape[0] // n) + rest)
    parts = _all_to_all(chunks, mesh, names, n, "reduce_scatter")
    return _member_sum(parts).movedim(0, d)


def ppermute(x: torch.Tensor, axis: str, perm) -> torch.Tensor:
    """``jax.lax.ppermute`` along one mesh axis: ``perm`` lists (source,
    destination) indices along ``axis``; this rank sends ``x`` to its
    destination and returns what its source sent, or zeros when it has
    none.  Point to point: gloo ``isend``/``irecv`` on the host, a round
    of the peer buffers, or one NCCL all-to-all with a single nonzero
    split each way."""
    mesh = current_mesh()
    if mesh.shape[axis] == 1:
        return torch.zeros_like(x) if not any(s == d for s, d in perm) \
            else x
    me = mesh.coords[axis]
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation")

    def peer(i):
        return mesh.rank_of({**mesh.coords, axis: i})

    if getattr(mesh, "recording", False):
        nbytes = x.numel() * x.element_size()
        _count("ppermute", nbytes if dst else 0, nbytes if src else 0, False)
        return torch.zeros_like(x)
    buf = x.detach().contiguous()
    nbytes = buf.numel() * buf.element_size()
    route = mesh.route(buf)
    _count("ppermute", nbytes if dst else 0, nbytes if src else 0,
           route == "gloo" and buf.device.type != "cpu")
    names = (axis,)
    if route == "peer":
        return mesh.peer.ppermute(buf, mesh.kind(names),
                                  mesh.members(names),
                                  dst[0] if dst else None,
                                  src[0] if src else None)
    if route == "nccl":
        out = torch.zeros_like(buf)
        if nbytes:
            _nccl_send_one(buf, out, mesh._nccl[names], mesh.shape[axis],
                           dst[0] if dst else None, src)
        return out
    host = buf.cpu()
    out = torch.zeros_like(host)
    reqs = []
    if dst:
        reqs.append(dist.isend(host, peer(dst[0])))
    if src:
        reqs.append(dist.irecv(out, peer(src[0])))
    for r in reqs:
        r.wait()
    return out.to(x.device)
