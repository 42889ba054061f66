"""Quickstart: the paper's hash table in three layers (the port's
counterpart of ``examples/quickstart.py``).

1. The faithful layer — Algorithms 1-6 executed event by event under an
   adversarial scheduler, with a linearizability check.
2. The batched layer — scatter-min arbitration, tombstone reuse.
3. The integration — the table as a paged-KV page allocator.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import batched as BT
from repro_torch.core import schedulers as SCH
from repro_torch.core import simulator as SIM
from repro_torch.core.linearizability import check_history
from repro_torch.device import resolve_device
from repro_torch.serving import page_table as PT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=" * 64)
    print("1) faithful layer: concurrent processes, adversarial interleaving")
    rng = np.random.default_rng(0)
    P, K, m = 6, 4, 32
    wl = SCH.random_workload(rng, P=P, K=K, num_keys=8)   # high contention
    sched = SCH.uniform_schedule(rng, P, T=4000)
    state = SIM.simulate(wl, m, sched, mode=SIM.MODE_LLSC, check_inv=True,
                         device=dev)
    rows = SIM.history_arrays(state, wl)
    ok = check_history(rows)
    print(f"   {len(rows)} ops, {P} processes, random schedule "
          f"-> linearizable: {ok}, invariants held: {bool(state.inv_ok)}")
    if not ok:
        raise AssertionError("history is not linearizable")

    print("=" * 64)
    print("2) batched layer: one mixed batch, tombstone reuse")
    ht = BT.create(64, device=dev)
    keys = torch.arange(20, dtype=torch.int32, device=dev)
    ht, ret = BT.insert_batch(ht, keys)
    print(f"   inserted {int(ret.sum())} keys; occupancy "
          f"{float(BT.occupancy(ht)):.2f}")
    ht, _ = BT.delete_batch(ht, keys[:10])
    print(f"   deleted 10 -> tombstones {int(ht.num_tombs)}")
    ht, ret = BT.insert_batch(ht, keys[:10] + 1000)
    print(f"   re-inserted 10 new keys; occupancy still "
          f"{float(BT.occupancy(ht)):.2f} (tombstones reclaimed: "
          f"{10 - int(ht.num_tombs)})")

    print("=" * 64)
    print("3) the integration: table slots ARE physical KV pages")
    pt = PT.for_strategy("linear")
    table = pt.create_table(32, device=dev)
    seqs = torch.arange(4, dtype=torch.int32, device=dev)
    for pos in range(12):
        table, _, _ = pt.alloc_step(
            table, seqs, torch.full((4,), pos, dtype=torch.int32, device=dev),
            page_size=4)
    print(f"   4 sequences x 12 tokens @ page_size 4 -> "
          f"{int(table.num_keys)} pages allocated")
    table = pt.free_sequences(
        table, seqs[:2], torch.full((2,), 12, dtype=torch.int32, device=dev),
        page_size=4, max_pages=8)
    print(f"   evicted 2 sequences -> {int(table.num_tombs)} tombstoned pages "
          f"(immediately reusable, no compaction)")
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
