"""Baseline: tombstones WITHOUT reuse — the [7,14] design point (PyTorch
port of ``core/baselines/gao_noreuse.py``).

Gao-Groote-Hesselink (2005) and Maier-Sanders-Dementiev (2019) mark
deleted cells with tombstones that inserts may NOT claim.  Occupancy (keys
+ tombstones) then grows monotonically with churn, and once it nears m the
table must be rebuilt even though few keys are live — the rebuild the
paper's tombstone reuse removes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import batched as BT

create = BT.create
lookup_batch = BT.lookup_batch
delete_batch = BT.delete_batch


def insert_batch(ht: BT.HashTable, keys,
                 active=None) -> Tuple[BT.HashTable, torch.Tensor]:
    """Insert claiming only EMPTY cells (no tombstone reuse)."""
    return BT.insert_batch(ht, keys, active=active, claim_tombstones=False)


def needs_rebuild(ht: BT.HashTable, slack: float = 0.95) -> torch.Tensor:
    """True (bool tensor []) when occupancy (keys + tombstones) nears
    capacity; inserts then start ABORTing even if few keys are live."""
    return BT.occupancy(ht) >= slack


def rebuild(ht: BT.HashTable,
            new_m: Optional[int] = None) -> BT.HashTable:
    """Rebuild into a fresh table (drops tombstones): the periodic cost the
    paper's reuse scheme avoids."""
    return BT.rebuild(ht, new_m or BT.size(ht))
