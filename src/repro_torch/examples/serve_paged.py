"""Serve a small model with batched requests through the paged engine (the
port's counterpart of ``examples/serve_paged.py``): continuous batching
under the SLO-aware scheduler, sequence eviction, tombstone-reuse page
recycling, proactive headroom control, and a check of decode against the
full forward on one request stream.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_paged
     [--arch qwen2.5-32b] [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import ContinuousBatcher
from repro_torch.models.registry import get_model
from repro_torch.serving import engine as EG
from repro_torch.serving.sched import Scheduler, synthetic_workload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-32b", choices=sorted(ARCH_IDS))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    print("[example] greedy-decode correctness vs full forward")
    B, T = 2, 16
    toks = torch.randint(0, cfg.vocab_size, (B, T), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        ref, _ = model.forward(cfg, params, toks)
        state, _ = EG.make_decode_state(cfg, B, S_max=64, page_size=8,
                                        device=dev)
        step = EG.make_serve_step(cfg, S_max=64, page_size=8)
        for t in range(T):
            logits, state = step(params, state,
                                 toks[:, t:t + 1].to(torch.int32),
                                 torch.full((B,), t, dtype=torch.int32,
                                            device=dev))
    err = float((logits - ref[:, -1].float()).abs().max())
    print(f"   last-token logits err vs forward: {err:.2e}")
    if not err < 6e-2:
        raise AssertionError(f"decode differs from the forward by {err}")

    print("[example] continuous batching under churn (tombstone reuse), "
          "megastep K=4: one call per 4 greedy tokens")
    srv = ContinuousBatcher(cfg, params, batch=4, max_len=48, page_size=8,
                            megastep_k=4, device=dev)
    for r in range(6):
        srv.decode_round(8)
        st = srv.table_stats()
        print(f"   round {r}: evictions={srv.evictions:3d} "
              f"live={int(st.live_pages):3d} tombs={int(st.tombstones):3d} "
              f"occupancy={float(st.occupancy):.3f}")
    if srv.sched.stats.aborts:
        raise AssertionError("the proactive batcher aborted")
    print("[example] serve_paged OK — pages recycled in place, no rebuild")

    print("[example] SLO-aware scheduling on an OVERCOMMITTED pool (the "
          "forecaster keeps the allocator out of ABORT)")
    sched = Scheduler(slots=4, page_size=8, max_len=48, megastep_k=4,
                      policy="deadline", proactive=True)
    wl = synthetic_workload(12, vocab_size=cfg.vocab_size, max_len=48,
                            seed=0, slo_fraction=0.5, arrival_every=2)
    srv2 = ContinuousBatcher(cfg, params, batch=4, max_len=48, page_size=8,
                             megastep_k=4, scheduler=sched,
                             n_pages=14,         # < half the worst-case plan
                             auto_refill=False, verify_block_table=True,
                             device=dev)
    sched.submit_many(wl)
    if not srv2.run_until_drained(max_rounds=400):
        raise AssertionError("workload did not drain")
    s = sched.stats
    print(f"   completed={s.completed} aborts={s.aborts} "
          f"aborts_avoided={s.aborts_avoided} grows={s.pool_grows} "
          f"preempted={s.preemptive_evictions} "
          f"deadline_misses={s.deadline_misses}")
    lat = sched.latency_summary()
    print(f"   queue_wait p50/p99 = {lat['queue_wait_p50']:.0f}/"
          f"{lat['queue_wait_p99']:.0f} steps, "
          f"ttft p50/p99 = {lat['ttft_p50']:.0f}/{lat['ttft_p99']:.0f} steps")
    if s.completed != 12 or s.aborts:
        raise AssertionError(f"completed {s.completed}, aborts {s.aborts}")
    print("[example] scheduler OK — zero ABORTs on an overcommitted pool")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
