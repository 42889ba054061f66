"""Wrapper for the probe-lookup kernel."""
from __future__ import annotations

import torch

from repro_torch.core import batched as BT
from repro_torch.kernels import stats as KS
from repro_torch.kernels.probe.probe import (FOUND_BYTES, KEY_BYTES,
                                             SEED_BYTES, SLOT_BYTES,
                                             probe_lookup_kernel)


def probe_lookup(ht: BT.HashTable, keys, *, use_kernel: bool = True,
                 strategy: str = "linear"):
    """Wait-free batched lookup through the probe kernel.  Returns
    (found bool[B], slot int32[B]), a drop-in for ``batched.find_batch``.

    The kernel walks the LINEAR probe run, so it serves exactly the
    strategies whose lookup scan is the linear one (``kernel_supported``:
    ``linear`` and ``robinhood``, whose claims land only on cells walked in
    probe order, so a key's run holds no EMPTY cell); ``hopscotch``'s
    neighbourhood gather raises, as in the reference — the page-table
    facade routes it to the strategy's ``find_batch`` instead.  A kernel
    call notes in ``kernels.stats`` the bytes it moves whatever the data:
    int64 keys, found, slot and the seed.  (The reference notes its TPU
    staging of two TB-cell table blocks per key tile instead; the CUDA
    kernel stages nothing, and the table cells it reads depend on the data
    — ``probe.lookup_bytes``.)"""
    if strategy != "linear":
        from repro_torch.core.probe_strategies import get_strategy
        if not get_strategy(strategy).kernel_supported:
            raise ValueError(
                f"probe_lookup: strategy {strategy!r} does not probe in "
                f"linear order — use the strategy's find_batch (the facade "
                f"routes this automatically)")
    if use_kernel:
        n = torch.as_tensor(keys).shape[0]
        KS.note_bytes("probe_bytes", n * (KEY_BYTES + FOUND_BYTES
                                          + SLOT_BYTES) + SEED_BYTES)
        return probe_lookup_kernel(ht, keys)
    return BT.find_batch(ht, keys)


def resolved_fraction(ht: BT.HashTable, keys, **kw) -> float:
    """Fraction of keys the kernel resolves without the oracle.  Always
    1.0: the CUDA kernel walks a key's run until it decides or has read all
    m cells, so — unlike the TPU kernel's two-block window — no key is left
    unresolved and there is no fallback leg."""
    return 1.0
