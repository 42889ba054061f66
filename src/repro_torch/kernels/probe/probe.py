"""Wait-free batched lookup kernel K3: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/probe/probe.py``
``_probe_kernel``.  The kernel is ``repro_torch/csrc/probe.cu``
``probe_kernel``: one launch per call, with the table's hash computed in
the kernel from the seed on the device (``hash_constants``), int64 keys
read as they are and ``found`` written as ``torch.bool``.  A group of
``LANES`` lanes serves one key and reads 4 aligned cells a lane a round;
one warp vote finds each group's first hit or EMPTY, and the earlier
decides.  The walk goes on until it decides or has read all m cells, so
every key is resolved and no fallback is needed.
``ref.probe_walk_plain`` is a plain model of the same rounds.  Bound:
bytes (``lookup_bytes``).

For CPU tables the wrapper runs the plain version (``BT.find_batch``); for
CUDA tables it launches the kernel or raises.  ``probe_lookup_kernel.
launches`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.core import batched as BT
from repro_torch.core import encoding as E
from repro_torch.core import hashing as H
from repro_torch.kernels import _build

SEED_MIX = 0x9E3779B9   # the seed's mix constant (``BT._hash``)
# L, the lanes a key: csrc/probe.cu's LANES, the one instance it builds.
# 16 was the fastest of 4, 8, 16 and 32 at the probe phase's 2^18 lookups
# and within noise of the others at the rebuild's 512
# (tools/probe_variants.py on the card, PERF.md)
LANES = 16
KEY_BYTES, FOUND_BYTES, SLOT_BYTES, SEED_BYTES = 8, 1, 4, 4


def hash_constants(m: int):
    """(A0, shift) that the kernel hashes a table of m cells with:
    ``x = (key ^ seed * SEED_MIX) * A0 mod 2^32``, then ``x >> shift`` for
    a power of two (shift 32: every key in bucket 0), and the general
    branch ``((x >> 16) * m mod 2^32) >> 16`` where shift is -1."""
    a0 = H.derive_multiplier(0)       # ``BT._hash`` hashes with seed 0
    if H.is_pow2(m):
        return a0, 32 - (m.bit_length() - 1)
    return a0, -1


def probe_lookup_kernel(ht: BT.HashTable, keys):
    """(found bool[B], slot int32[B]) for every key — bitwise
    ``BT.find_batch(ht, keys)``.  Keys are read by their low 32 bits;
    int64 keys on the table's device go to the kernel as they are, others
    take one conversion."""
    table = ht.table
    if table.dtype != torch.int32 or table.dim() != 1 \
            or not table.is_contiguous():
        raise ValueError("probe_lookup_kernel: table must be contiguous "
                         "int32[m]")
    if table.device.type == "cpu":
        return BT.find_batch(ht, keys)
    if table.data_ptr() % 16:
        raise ValueError("probe_lookup_kernel: the table must be 16-byte "
                         "aligned (the kernel reads 4 cells a load)")
    dev = table.device
    keys = torch.as_tensor(keys, device=dev)
    if keys.dim() != 1:
        raise ValueError("probe_lookup_kernel: keys must be 1-D")
    keys = keys.to(torch.int64).contiguous()
    seed = torch.as_tensor(ht.seed, dtype=torch.int32, device=dev)
    n, m = keys.shape[0], BT.size(ht)
    found = torch.empty((n,), dtype=torch.bool, device=dev)
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return found, slot
    a0, shift = hash_constants(m)
    lib = _build.library()
    rc = lib.probe_lookup_launch(
        _build.ptr(table), m, _build.ptr(keys), n, _build.ptr(seed), a0,
        shift, _build.ptr(found), _build.ptr(slot), _build.stream(dev))
    _build.check(rc, "probe_lookup_kernel")
    probe_lookup_kernel.launches += 1
    return found, slot


probe_lookup_kernel.launches = 0


def run_cells(table: torch.Tensor, hv, slot, found) -> torch.Tensor:
    """Cells each lookup's run covers, in probe order from its bucket: up
    to its hit when found, else up to and with the first EMPTY (all m
    cells when there is none).  int64[B] on the CPU."""
    tab = table.cpu()
    m = tab.shape[0]
    h = torch.as_tensor(hv).cpu().to(torch.int64)
    empties = torch.nonzero(tab == E.EMPTY).flatten()
    if empties.numel():
        i = torch.searchsorted(empties, h) % empties.numel()
        to_empty = (empties[i] - h) % m + 1
    else:
        to_empty = torch.full_like(h, m)
    to_hit = (torch.as_tensor(slot).cpu().to(torch.int64) - h) % m + 1
    return torch.where(torch.as_tensor(found).cpu(), to_hit, to_empty)


def lookup_bytes(table: torch.Tensor, hv, slot, found) -> int:
    """Bytes these lookups must move at least: the union of the table
    cells their runs cover, each cell counted once (4 B), plus 8 B of
    int64 key, 1 B of found and 4 B of slot per lookup, plus the seed."""
    m = table.shape[0]
    h = torch.as_tensor(hv).cpu().to(torch.int64)
    n = h.shape[0]
    length = run_cells(table, h, slot, found)
    # cover [h, h + length) on a doubled axis, then fold it onto [0, m)
    edge = torch.zeros(2 * m + 1, dtype=torch.int64)
    edge.index_add_(0, h, torch.ones_like(h))
    edge.index_add_(0, h + length, -torch.ones_like(h))
    cover = torch.cumsum(edge, 0)[:2 * m] > 0
    cells = int((cover[:m] | cover[m:]).sum())
    return (4 * cells + (KEY_BYTES + FOUND_BYTES + SLOT_BYTES) * n
            + SEED_BYTES)
