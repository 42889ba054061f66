"""Named-axis collectives over ``torch.distributed``: the port's stand-in
for ``jax.lax.psum`` / ``pmax`` / ``all_gather`` / ``all_to_all`` /
``axis_index`` inside the reference's ``shard_map`` bodies.

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

The backend is ``gloo``, also on the card: NCCL refuses two ranks on one
device, and the port's mesh shares one H100 between its ranks.  ``gloo``
runs ``all_gather`` and ``all_to_all`` on host tensors only, so a
collective on a CUDA tensor is STAGED through the host here, explicitly:
the tensor is copied to the host, the collective runs there, and the
result is copied back.  ``COLLECTIVE_STATS`` counts the calls and the
staged ones; nothing falls back quietly.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

COLLECTIVE_STATS = {"calls": 0, "staged": 0}

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
        self.coords: Dict[str, int] = {}
        r = rank
        for a in reversed(self.axis_names):
            self.coords[a] = r % self.shape[a]
            r //= self.shape[a]
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

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

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


def _gather(x: torch.Tensor, axes) -> Optional[torch.Tensor]:
    """The members' ``x`` stacked on a new dim 0 in member order, on x's
    device; None when the axes hold one rank."""
    mesh = current_mesh()
    names = mesh.axes(axes)
    if not names:
        return None
    if names != tuple(a for a in _ordered(axes) if a in names):
        raise ValueError(f"collective over {axes}: give the axes in mesh "
                         f"order {mesh.axis_names}")
    group = mesh.group(names)
    n = 1
    for a in names:
        n *= mesh.shape[a]
    staged = x.device.type != "cpu"
    src = x.detach().contiguous()
    if staged:
        src = src.cpu()
    out = torch.empty((n,) + tuple(src.shape), dtype=src.dtype)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    COLLECTIVE_STATS["calls"] += 1
    if staged:
        COLLECTIVE_STATS["staged"] += 1
        out = out.to(x.device)
    return out


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum over the ranks of ``axes``, in member order, in x's dtype."""
    parts = _gather(x, axes)
    if parts is None:
        return x
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    parts = _gather(x, axes)
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
    names = mesh.axes(axes)
    if not names:
        return x
    group = mesh.group(names)
    staged = x.device.type != "cpu"
    src = x.contiguous()
    if staged:
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    COLLECTIVE_STATS["calls"] += 1
    if staged:
        COLLECTIVE_STATS["staged"] += 1
        out = out.to(x.device)
    return out
