"""Mesh construction and the SPMD launcher (PyTorch port of
``launch/mesh.py``).

The port's mesh is a real ``torch.distributed`` program: one process per
rank, each holding only its own shards (``dist/collectives.Mesh``).
``run_spmd`` starts the ranks ("spawn"), joins the process group over
``gloo`` at ``tcp://localhost:<free port>`` with a timeout, runs one
function on every rank and returns what each rank returned.  A rank that
raises, or waits on a collective longer than the timeout, fails the whole
call.

Ranks on the card are placed by ``card_of``: rank r on card r when the
host has a card for every rank ("per card"; their meshes move collectives
with NCCL), every rank on card 0 otherwise ("shared"; the peer buffers on
that card, see ``dist/peer``).  The gloo group stays in both: it carries
the launcher's barriers, host tensors and the small host exchanges.

``make_production_mesh`` returns the production shape as data only; it
starts no process.
"""
from __future__ import annotations

import datetime
import gc
import os
import socket
import tempfile
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from repro_torch.dist import collectives as C

DEFAULT_TIMEOUT_S = 120


def make_production_mesh(*, multi_pod: bool = False) -> C.AbstractMesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return C.AbstractMesh(shape, axes)


def card_of(rank: int, world: int, n_cards: int) -> int:
    """The card of ``rank`` among ``world`` ranks on a host with
    ``n_cards``: its own when every rank has one, else card 0."""
    return rank if n_cards >= world else 0


def placement(world: int, n_cards: int) -> str:
    """"per card" or "shared" (``card_of``'s two cases)."""
    return "per card" if n_cards >= world > 1 else "shared"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device=None, transport=None) -> C.Mesh:
    """The named mesh over the initialised process group, bound as this
    process's mesh; this rank's tensors live on its card
    (``torch.cuda.current_device()``, set by ``run_spmd``) unless
    ``device="cpu"``.  ``transport`` follows from the placement
    (``collectives.transport_for``); name it only to check one transport
    against another."""
    from repro_torch.device import resolve_device
    mesh = C.Mesh(shape, axis_names, resolve_device(device),
                  transport=transport)
    C.set_mesh(mesh)
    return mesh


def make_host_mesh(data: int = 2, model: int = 2, device=None) -> C.Mesh:
    """A (data, model) mesh over the process group's ranks, the data axis
    cut to what the ranks allow, as the reference's."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = min(data, max(1, n // model))
    return make_mesh((data, model), ("data", "model"), device)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world: int, port: int, out_dir: str,
               timeout_s: float, threads: int, device: str) -> None:
    torch.set_num_threads(threads)
    args = torch.load(os.path.join(out_dir, "args.pt"), weights_only=False)
    if device == "cuda":
        torch.cuda.set_device(card_of(rank, world,
                                      torch.cuda.device_count()))
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    out = fn(rank, *args)
    torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    # the meshes go (a peer workspace goes to torch's IPC limbo while a
    # peer still maps it); no rank tears its connections down while
    # another still uses them; then the workspaces are freed
    C.set_mesh(None)
    gc.collect()
    dist.barrier()
    if device == "cuda":
        torch.cuda.ipc_collect()
    dist.destroy_process_group()


def run_spmd(fn: Callable[..., Any], world: int, args=(), *,
             device: str = "cpu", timeout_s: float = DEFAULT_TIMEOUT_S,
             threads: int = 1) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``world`` spawned ranks joined in one
    gloo process group, on the card placed by ``card_of`` when ``device``
    is "cuda"; returns the ranks' return values (saved with
    ``torch.save``, so tensors should be on the host) in rank order.
    ``fn`` must be importable by name (a module-level function).  Raises
    when a rank fails; a rank stuck in a collective fails after
    ``timeout_s``.  ``args`` reach the ranks through a file: spawn's pipe
    would hand them over one rank at a time, each waiting for the last
    to start."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as out_dir:
        torch.save(tuple(args), os.path.join(out_dir, "args.pt"))
        mp.start_processes(
            _rank_main, args=(fn, world, _free_port(), out_dir, timeout_s,
                              threads, device),
            nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"{r}.pt"),
                           weights_only=False) for r in range(world)]
