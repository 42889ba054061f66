"""Host-sharded distributed page table and the mesh-sharded DHT (the port's
counterpart of ``examples/distributed_dht.py``): hash-prefix routing,
per-shard admission, lazy incremental resize and elastic host loss through
the simulated multi-host soak (``launch/shard_soak``), then the DHT of
``core/sharded`` over real ranks — ``launch/mesh.run_spmd`` starts 4
processes joined in one gloo group, each holding one shard, the routing
done by all-to-all collectives (gloo on the CPU, the peer buffers or
NCCL on the card) — where the reference forces 8 fake
devices.

Run: PYTHONPATH=src python -m repro_torch.examples.distributed_dht
     [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.device import resolve_device

HOSTS = 4
RANKS = 4


def dht_rank(rank: int, device: str) -> dict:
    """One shard of a DHT over a 4-rank ``model`` axis: every rank inserts
    its own keys and looks up everyone's, each answer held to a Python set
    of what was inserted."""
    import torch
    from repro_torch.core import sharded as SHT
    from repro_torch.core.spec import OP_INSERT, OP_LOOKUP, RET_TRUE
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((RANKS,), ("model",), device)
    st, apply_fn = SHT.make_sharded_table(mesh, "model", m_global=4096,
                                          capacity=256)
    mine = np.arange(rank * 1000 + 1, rank * 1000 + 201, dtype=np.int64)
    st, ret, over = apply_fn(st, np.full(mine.shape, OP_INSERT, np.int32),
                             mine)
    inserted = int((ret == RET_TRUE).sum())
    everyone = np.concatenate([np.arange(r * 1000 + 1, r * 1000 + 201)
                               for r in range(RANKS)] + [np.arange(
                                   90001, 90101)])
    st, ret, over2 = apply_fn(st, np.full(everyone.shape, OP_LOOKUP,
                                          np.int32), everyone)
    want = np.arange(everyone.shape[0]) < RANKS * 200
    found = ret.cpu().numpy() == RET_TRUE
    return {"inserted": inserted, "overflow": int(over.sum() + over2.sum()),
            "lookups_ok": bool((found == want).all()),
            "shard_keys": int(st.num_keys.sum()), "transport": mesh.transport}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from repro_torch.dist import table_shard as TSH
    from repro_torch.dist.fault_tolerance import elastic_table_plan
    from repro_torch.launch.mesh import run_spmd
    from repro_torch.launch.shard_soak import SimCluster
    from repro_torch.serving.sched import synthetic_workload

    # --- 1. the routing layer: hash-prefix manifest ----------------------
    man = TSH.ShardManifest.balanced(HOSTS)
    owners = man.owner_of_seq(np.arange(1, 257, dtype=np.uint32))
    counts = np.bincount(owners, minlength=HOSTS)
    print(f"   manifest: {1 << man.prefix_bits} prefixes over {HOSTS} hosts; "
          f"256 seqs land as {counts.tolist()} (hash-balanced)")

    # --- 2. the storm: admission + lazy grow + host loss under traffic ---
    cluster = SimCluster(hosts=HOSTS, pages_per_shard=32, slots_per_shard=3,
                         page_size=4, max_len=32, megastep_k=4,
                         fail_on_abort=True, verbose=True, device=dev)
    wl = synthetic_workload(32, vocab_size=256, max_len=32, seed=0,
                            prompt_len=(2, 5), max_new=(20, 28))
    print(f"   storm: {len(wl)} requests over {HOSTS} hosts on {dev} "
          f"(grow @r3, host loss @r6)")
    s = cluster.run_storm(wl, grow_round=3, lose_round=6)
    print(f"   drained in {int(s['rounds'])} rounds: "
          f"completed={int(s['completed'])}/{int(s['submitted'])} "
          f"rehomed={int(s['rehomed'])} grows={int(s['pool_grows'])} "
          f"aborts={int(s['aborts_observed'])}")
    if int(s["completed"]) != int(s["submitted"]) or \
            int(s["aborts_observed"]):
        raise AssertionError(f"lost requests or aborts: {s}")

    # --- 3. the elastic plan the loss triggered --------------------------
    new_man, shape, names = elastic_table_plan(man, lost_shard=HOSTS - 1,
                                               model_parallel=16)
    print(f"   elastic_table_plan: survivors={new_man.live_shards()} "
          f"mesh={dict(zip(names, shape))}")
    if len(new_man.live_shards()) != len(cluster.spt.live_shards()):
        raise AssertionError("the plan and the cluster disagree")

    # --- 4. the DHT over real ranks --------------------------------------
    outs = run_spmd(dht_rank, RANKS, (dev.type,), device=dev.type)
    print(f"   mesh DHT over {RANKS} ranks ({outs[0]['transport']}): inserted "
          f"{[o['inserted'] for o in outs]}, keys per shard "
          f"{[o['shard_keys'] for o in outs]}")
    if not all(o["lookups_ok"] and o["overflow"] == 0 for o in outs) or \
            sum(o["shard_keys"] for o in outs) != RANKS * 200:
        raise AssertionError(f"mesh DHT: {outs}")
    print("[example] distributed_dht OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
