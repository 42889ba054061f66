"""Plain version of the probe-lookup kernel: the batched table's
``find_batch``.  The kernel must agree exactly on (found, slot)."""
from __future__ import annotations

import torch

from repro_torch.core import batched as BT


def probe_lookup_ref(table: torch.Tensor, keys, seed: int):
    """table: int32[m] quiescent cells; keys: integer [B].
    Returns (found bool[B], slot int32[B])."""
    i32 = dict(dtype=torch.int32, device=table.device)
    ht = BT.HashTable(table=table, num_keys=torch.zeros((), **i32),
                      num_tombs=torch.zeros((), **i32),
                      seed=torch.tensor(seed, **i32),
                      meta=torch.zeros((0,), **i32))
    return BT.find_batch(ht, keys)
