"""Wait-free batched lookup kernel K3: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/probe/probe.py``
``_probe_kernel``.  The kernel is ``repro_torch/csrc/probe.cu``
``probe_kernel``: one warp per key reads 32 consecutive cells a round
(coalesced, wrapping mod m) and ``__ballot_sync`` finds the first hit and
the first EMPTY; the earlier decides.  The walk goes on until it decides or
has read all m cells, so every key is resolved and no oracle fallback is
needed.  Bound: bytes — the cells each key's run needs, 4 B each, plus the
key and results, over the card's memory rate.

For CPU tables the wrapper runs the plain version (``BT.find_batch``); for
CUDA tables it launches the kernel or raises.  ``probe_lookup_kernel.
launches`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.core import batched as BT
from repro_torch.kernels import _build


def probe_lookup_kernel(ht: BT.HashTable, keys):
    """(found bool[B], slot int32[B]) for every key — bitwise
    ``BT.find_batch(ht, keys)``."""
    keys = BT._keys(ht, keys)
    if ht.table.dtype != torch.int32 or ht.table.dim() != 1 \
            or not ht.table.is_contiguous():
        raise ValueError("probe_lookup_kernel: table must be contiguous "
                         "int32[m]")
    if ht.table.device.type == "cpu":
        return BT.find_batch(ht, keys)
    n, m = keys.shape[0], BT.size(ht)
    hv = BT._hash(ht, keys).contiguous()
    keys32 = keys.to(torch.int32).contiguous()
    found = torch.empty((n,), dtype=torch.int32, device=keys.device)
    slot = torch.empty((n,), dtype=torch.int32, device=keys.device)
    lib = _build.library()
    rc = lib.probe_lookup_launch(
        _build.ptr(ht.table), m, _build.ptr(keys32), _build.ptr(hv), n,
        _build.ptr(found), _build.ptr(slot), _build.stream(keys.device))
    _build.check(rc, "probe_lookup_kernel")
    probe_lookup_kernel.launches += 1
    return found.to(torch.bool), slot


probe_lookup_kernel.launches = 0
