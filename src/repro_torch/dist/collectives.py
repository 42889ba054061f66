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

The backend is ``gloo``, also on the card: NCCL refuses two ranks on one
device, and the port's mesh shares one H100 between its ranks.  ``gloo``
runs ``all_gather`` and ``all_to_all`` on host tensors only, so a
collective on a CUDA tensor is STAGED through the host here, explicitly:
the tensor is copied to the host, the collective runs there, and the
result is copied back.  ``COLLECTIVE_STATS`` counts the calls and the
staged ones, and per op (``by_op``) the calls and the bytes this rank put
on the wire and took off it, summed over the other members (a gather of
x over n ranks sends x to n - 1 of them; an all-to-all sends n - 1 of its
n chunks); nothing falls back quietly.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

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


class Mesh(AbstractMesh):
    """The named mesh over the initialised default process group (or over
    one process when the mesh has a single rank and no group exists).
    ``device`` is where this rank's tensors live."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device="cpu"):
        super().__init__(shape, axis_names)
        self.device = torch.device(device)
        if dist.is_available() and dist.is_initialized():
            world, rank = dist.get_world_size(), dist.get_rank()
        else:
            world, rank = 1, 0
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, "
                             f"the process group has {world}")
        self.rank = rank
        self.coords: Dict[str, int] = self.coords_of(rank)
        self._groups: Dict[Tuple[str, ...], object] = {}
        names = [a for a in self.axis_names if self.shape[a] > 1]
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                self._build_groups(axes, world)

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
            if self.rank in ranks:
                self._groups[axes] = group

    def group(self, axes: Tuple[str, ...]):
        return self._groups[axes]


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
    group = mesh.group(names)
    staged = x.device.type != "cpu"
    src = x.detach().contiguous()
    if staged:
        src = src.cpu()
    out = torch.empty((n,) + tuple(src.shape), dtype=src.dtype)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    moved = (n - 1) * src.numel() * src.element_size()
    _count(op, moved, moved, staged)
    if staged:
        out = out.to(x.device)
    return out


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
    group = mesh.group(names)
    staged = x.device.type != "cpu"
    src = x.detach().contiguous()
    if staged:
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    moved = (n - 1) * (src.numel() // n) * src.element_size()
    _count(op, moved, moved, staged)
    if staged:
        out = out.to(x.device)
    return out


def gather_to_root(x: torch.Tensor, root: int = 0
                   ) -> Optional[List[torch.Tensor]]:
    """Every rank's ``x`` (one shape on every rank) on rank ``root`` of
    the bound mesh, in rank order, on the host; None on the other ranks.
    One gloo ``gather`` over the process group: each rank's bytes cross
    once (a checkpoint's save, where only the writer needs the whole)."""
    mesh = current_mesh()
    staged = x.device.type != "cpu"
    src = x.detach().contiguous().cpu()
    if mesh.size == 1:
        return [src]
    nbytes = src.numel() * src.element_size()
    out = ([torch.empty_like(src) for _ in range(mesh.size)]
           if mesh.rank == root else None)
    dist.gather(src, out, dst=root)
    _count("gather", 0 if mesh.rank == root else nbytes,
           (mesh.size - 1) * nbytes if mesh.rank == root else 0, staged)
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
    none.  Point-to-point over the host (gloo ``isend``/``irecv``)."""
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
    staged = x.device.type != "cpu"
    buf = x.detach().contiguous()
    if staged:
        buf = buf.cpu()
    out = torch.zeros_like(buf)
    reqs = []
    if dst:
        reqs.append(dist.isend(buf, peer(dst[0])))
    if src:
        reqs.append(dist.irecv(out, peer(src[0])))
    for r in reqs:
        r.wait()
    nbytes = buf.numel() * buf.element_size()
    _count("ppermute", nbytes if dst else 0, nbytes if src else 0, staged)
    return out.to(x.device) if staged else out
