#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and runs, in
order, each phase printing one JSON line:

1. build     — build seconds, the library path, the card.
2. attention — K1 (fused decode) and K2 (paged attention) against their
               plain PyTorch versions at B in {8, 64}, KH=8, G=6, D=128,
               PS in {16, 256}, up to 4096 tokens per sequence, in bf16
               and int8 with scales, with stale rows, -1 holes and
               positions on page boundaries; at the serve shape with each
               lane on an edge of the split layout (empty tail splits, a
               split of holes only, no live token, a position past the
               table); and over a sweep of head counts (G 1 to 16), head
               dims (8 to 256) and all six q x pool dtype pairs.  In every
               case K1 == the K2 composition (slots view, then K2) bit for
               bit.
3. probe     — K3 against the plain ``find_batch``, (found, slot) bit for
               bit at its lane count L: on edge tables
               (m in {1, 3, 5, 192, 384}, full tables and tombstones;
               m = 200000, the general hash branch above 2^16; m = 2^12
               with one run longer than 32 x 32 cells; seeds other than
               0; int64 keys >= 2^32 and negative keys), then on a
               2^20-cell table at load 0.9, churned (tombstones, runs that
               wrap), 2^18 lookups half present, timed warm (CUDA-graph
               replay) and cold (L2 flushed before each call) beside the
               byte bound of ``probe.lookup_bytes``.
4. strategies — for each of linear, robinhood and hopscotch: a recorded
               mixed insert/delete/lookup trace at m = 2^14 replayed
               through ``apply_batch`` on the card and on the CPU, table,
               meta, counters and returns equal after every batch; then a
               2^20-cell table filled to load 0.9 through ``insert_batch``
               (robinhood in batches of 2047 keys: its int32 priority
               needs m * B < 2^31), a tenth deleted and refilled, and four
               churn rounds of 2^14 deletes and inserts at a fixed live
               set, the invariants checked after each (every live key
               found where it lies, absent keys not found, counters equal
               to the census; hopscotch's meta equal to the membership of
               its cells, no tombstone).  Fill seconds, arbitration rounds
               and host syncs per batch, ABORTs (0 required but for
               hopscotch, whose displacement can fail below full).  The
               Gao no-reuse baseline runs the linear churn beside it until
               its occupancy reaches ``needs_rebuild``.  K3 == find_batch
               on the robinhood-built table, timed warm and cold beside
               its byte bound; ``probe_lookup(strategy="hopscotch")``
               raises.
5. serve     — the main path: ``ContinuousBatcher`` serving qwen2.5-32b at
               full width with the depth cut from 64 to 8 layers (the 64
               layers' bf16 weights, about 65.5 GB, would leave too little
               of the card for anything else), random bf16 weights from a
               seed, ``fused_kernel=True``, 16 requests.  The same
               workload runs in lockstep with ``fused_kernel=False`` (plain
               ``attend_local``); table, meta and block table must be
               equal bit for bit after every round, and after every round
               K1 is held bit for bit to the K2 composition on the live
               state.  Then the same under ``probe_strategy="robinhood"``
               (0 aborts) and ``"hopscotch"`` (every request completes;
               aborts and pool grows printed).
6. rebuild   — each serve run's state after its third round, re-hashed
               into a 2x pool with ``use_kernel=True`` and without: table,
               block table and pools equal bit for bit; K3 launches once
               for linear and robinhood, never for hopscotch, whose
               fallback ``fallback_report`` names.
7. logits    — one serve step with K1 and one with the plain attention on
               clones of the linear serve state with the most live pages:
               the live lanes' logits within ``LOGITS_REL_TOL``.
8. kernels   — each kernel's device time at the main path's shapes (the
               serve state with the most live pages; the rebuild's keys),
               from CUDA-graph replay, beside its plain version's, its
               bound and bound share, a library call's and its eager
               per-call time; for K1 and K2 also the split count and the
               same numbers at the attention phase's long-context case
               (B=64, PS=16, MP=256, bf16, up to 4096 tokens a sequence);
               for K3 its lane count, the device ops one call launches
               (counted under ``torch.profiler``: 1 for int64 keys), cold
               times, the probe phase's numbers and the robinhood table's;
9. families  — phase ``serve``'s machinery (the fused run in lockstep with
               the plain one, tables equal and K1 == the K2 composition
               every round, the rebuild with K3) for the other model
               families, random bf16 weights from the seed:
               ``moe``    granite-moe-1b-a400m at full width (32 experts
                          top-8), depth cut 24 -> 12 for time, the serve
                          traffic;
                          one megastep run twice from clones of one state
                          must give the same bits (the MoE combine has no
                          atomic add);
               ``gemma3`` gemma3-12b at full width and the published 1024
                          window, depth cut 48 -> 12 (two 5:1 superblocks:
                          10 ring layers, 2 paged), 12 requests of 900-1100
                          new tokens on 8 lanes, max_len 1536, so every
                          lane passes the window and 4 lanes are re-seated
                          (their rings reset); one lane's decode logits
                          past the window are held to ``lm.forward`` of
                          the same tokens within ``FORWARD_REL_TOL``;
               ``vlm``    qwen2-vl-7b at full width (28 -> 32 q-heads over
                          4 KV heads: G = 8 on K1, M-RoPE), 8 layers;
               ``int8``   the serve phase's qwen2.5-32b with
                          ``kv_cache_dtype="int8"``: int8 pools with bf16
                          scales through the engine and K1;
               ``zamba2`` zamba2-1.2b at full width (d_inner 4096, N 64;
                          the shared attention block over its own pools
                          after every 6 mamba layers, K1 at KH 32, G 1,
                          D 64), depth cut 38 -> 14 for time (2 of the 6
                          groups and the 2-layer tail), the serve
                          traffic, so re-seated lanes have their mamba
                          state reset; one lane's tokens near position
                          200 replayed through the engine in float32 and
                          held to the float32 ``hybrid.forward`` (the
                          bf16 state's distance printed beside it);
               ``mamba2`` mamba2-2.7b at full width (d 2560, d_inner 5120,
                          80 heads of 64, N 128), depth cut 64 -> 16 for
                          time; no page table, so no plain twin and no
                          kernel launch; the serve traffic, the float32
                          replay against ``ssm_lm.forward``, and the first
                          request seated on a re-seated lane served again
                          alone in a fresh batcher: the same tokens;
               ``seamless`` seamless-m4t-large-v2 at full width and depth
                          (24 + 24 layers, vocab 256206): the encoder
                          prefill on seeded frame embeddings [8, 128,
                          1024], then the megastep driven directly over
                          the 8 lanes for 256 tokens (64-token prompts
                          forced), the pool grown as the scheduler would;
                          the self attention on the plain ``attend_local``
                          as in the reference (no K1); lane 0's decode
                          logits against ``encdec.forward``.
               Each run with K1 on its path also holds one K1 and one
               plain serve step on clones of its state with the most live
               pages within ``LOGITS_REL_TOL`` and times K1 at its shape;
               each runs a megastep twice from one state for the same
               bits.
10. sharded  — ``PrefixRouter`` over a ``ShardedPageTable`` of 4
               simulated host groups, all on the card, at the reference's
               shard-soak settings (48 requests at 2x overcommit, a lazy
               grow at round 3, a host group lost at round 6), for linear
               and hopscotch, held to a shadow page map: every request
               completes, 0 proactive aborts, a migration finishes, and
               the counters equal the shadow's census;
               then a profile of three serve rounds: the device's busy
               share and the kernels that take its time.

Launch counts are zeroed just before each serve run and read after its
rebuild: K1 must have launched once per paged layer per token step, K2
never (the engine's attention is K1) and K3 once (the rebuild) for linear
and robinhood, never for hopscotch; the linear run is the main path of the
kernels line, ``launches_by_strategy`` holds all three and
``launches_by_family`` the families' (mamba2 launches none, seamless only
K3's rebuild).  The per-round check's launches are counted apart
(``check_launches``).  A wrapper counts one launch per call, though K1 and
K2 each make two CUDA launches (the split kernel and the merge).  Any failure raises and the script exits
non-zero.  The last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repository around it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"
SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores

# tolerances against the plain PyTorch versions: the kernels sum in another
# order (per 32-token chunk, fused multiply-adds) than torch's einsum
BF16_TOL = 1e-2               # bf16 outputs, atol = rtol
PARTIALS_TOL = 2e-3           # f32 (o, m, l) partials, atol = rtol
# one serve step with K1 against one with the plain attention, on the same
# mid-run state: ||fused - plain|| / ||plain|| over the live lanes' logits.
# The two attentions differ by f32 rounding; cast to bf16 that flips a few
# elements by one ulp (2^-8), which 8 bf16 layers carry to the logits; a
# wrong page or mask moves them by O(1)
LOGITS_REL_TOL = 2e-2

# the serve phase
ARCH = "qwen2.5-32b"
LAYERS = 8
BATCH, MAX_LEN, PAGE_SIZE, MEGASTEP = 8, 1024, 16, 8
N_REQUESTS = 16
SERVE_TRAFFIC = dict(max_len=MAX_LEN, requests=N_REQUESTS,
                     prompt_len=(64, 256), max_new=(64, 256))
# pool size factor vs the worst-case plan: 0.15 gives 96 pages, which this
# workload outgrows, so the scheduler grows the pool (at 0.5, 320 pages,
# it never does)
OVERCOMMIT = 0.15

# the families phase: (run, arch, layers (0 = the config's), config
# overrides, traffic).  gemma3's lanes decode past its 1024-token window and
# 12 requests on 8 lanes re-seat 4 of them.  Depth is cut for the script's
# time limit: granite-moe 24 -> 12, zamba2 38 -> 14 (two groups of 6 mamba
# layers, each followed by the shared block, and the 2-layer tail), mamba2
# 64 -> 16
FAMILIES = [
    ("moe", "granite-moe-1b-a400m", 12, {}, SERVE_TRAFFIC),
    ("gemma3", "gemma3-12b", 12, {},
     dict(max_len=1536, requests=12, prompt_len=(64, 256),
          max_new=(900, 1100))),
    ("vlm", "qwen2-vl-7b", LAYERS, {}, SERVE_TRAFFIC),
    ("int8", ARCH, LAYERS, {"kv_cache_dtype": "int8"}, SERVE_TRAFFIC),
    ("zamba2", "zamba2-1.2b", 14, {}, SERVE_TRAFFIC),
    ("mamba2", "mamba2-2.7b", 16, {}, SERVE_TRAFFIC),
    ("seamless", "seamless-m4t-large-v2", 0, {},
     dict(max_len=MAX_LEN, tokens=256, prompt=64)),
]
# gemma3's decode logits past the window against ``lm.forward`` of the same
# tokens, ||decode - forward|| / ||forward||: the two compute each token's
# q/k/v in bf16 through matrix products of other shapes (one token against
# the whole sequence), whose last-bit differences 12 bf16 layers carry to
# the logits; a wrong ring slot or mask moves them by O(1)
FORWARD_REL_TOL = 5e-2
# the forward check's lane: the first one this many tokens past the window
WINDOW_MARGIN = 64
# the ssm and hybrid runs' forward check: the first lane past this
# position, so that its at most 200 tokens make one SSD chunk (the
# reference's forward needs the length to be a multiple of the chunk, 256,
# when it is longer).  Their bf16 decode drifts from their bf16 forward by
# more than FORWARD_REL_TOL in the reference too (zamba2 at 38 layers, d
# 512: 0.13-0.43 over 200 tokens, on the CPU), so the check replays the
# lane's tokens through the engine in float32 and holds that to the
# float32 forward; the served bf16 state's distance is printed beside it
SSM_FORWARD_POS = 192
# the expected ``fallback_report()["fused_kernel"]`` of each family run
FUSED_REPORT = {
    "ssm": "attention-free SSM stack: no paged decode attention",
    "encdec": "cross-attention decode state not wired to the fused kernel"}

# the strategies phase: the 2^20-cell tables at load 0.9 and their churn
# rounds (CHURN_KEYS deleted and as many inserted a round, 1/64 of the
# table), and the card-vs-CPU replay at m = 2^14
STRAT_M = 1 << 20
CHURN_ROUNDS, CHURN_KEYS = 4, (1 << 20) // 64
REPLAY_M, REPLAY_BATCH, REPLAY_BATCHES = 1 << 14, 1024, 16

# the sharded phase: the reference's shard-soak settings (4 host groups,
# 48 requests at 2x overcommit, a forced lazy grow at round 3, a host
# group lost at round 6)
SOAK = dict(hosts=4, requests=48, overcommit=2.0, grow_round=3,
            lose_round=6)


T0 = time.time()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``t`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, "t": round(time.time() - T0, 1),
                      **fields}), flush=True)


def pool_pages(max_len: int = MAX_LEN) -> int:
    """A serve run's starting pool: the worst-case plan times
    ``OVERCOMMIT``."""
    maxP = -(-max_len // PAGE_SIZE)
    return max(maxP, int((int(BATCH * maxP * 1.25) + 1) * OVERCOMMIT))


def kernel_wrappers() -> dict:
    from repro_torch.kernels.fused_decode import fused_decode_kernel
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.probe import probe_lookup_kernel
    return {"K1": fused_decode_kernel, "K2": paged_attention_kernel,
            "K3": probe_lookup_kernel}


@contextlib.contextmanager
def uncounted(checks: dict):
    """Launches inside are a check's, not the main path's: each wrapper's
    count is restored on exit and the check's launches go to ``checks``."""
    wrappers = kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    try:
        yield
    finally:
        for k, w in wrappers.items():
            checks[k] += w.launches - before[k]
            w.launches = before[k]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``n`` calls after a
    warm-up, timed with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int, reps: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``n`` calls captured in one
    CUDA graph and replayed, so the host's launch overhead is not in the
    number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * reps)


def cold_ms(fn, n: int, flush_mb: int = 256) -> float:
    """Device milliseconds per call of ``fn`` with L2 cold: a
    ``flush_mb`` MB buffer (over 2.5x the 50 MB L2) is written before each
    call, and each call, captured in a CUDA graph, is timed with its own
    CUDA events; the mean over ``n`` calls."""
    import torch
    flush = torch.empty(flush_mb << 20, dtype=torch.uint8, device=DEV)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda.synchronize()
    for start, end in events:
        flush.fill_(1)
        start.record()
        g.replay()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / n


def device_ops(fn, calls: int = 4):
    """Device operations (kernels, copies, fills) that one call of ``fn``
    launches, counted under ``torch.profiler`` over ``calls`` calls, and
    their names."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    count, names = 0, []
    for e in prof.key_averages():
        if "CUDA" in str(getattr(e, "device_type", "")):
            count += e.count
            names.append(e.key[:80])
    return count / calls, sorted(names)


def close(a, b, tol: float) -> float:
    """Max abs error; raises unless |a-b| <= tol + tol*|b| everywhere."""
    import torch
    a, b = a.float(), b.float()
    err = (a - b).abs()
    bad = err > tol + tol * b.abs()
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} entries out of tolerance "
                             f"{tol}: max abs err {float(err.max())}")
    return float(err.max())


# ---------------------------------------------------------------------------
# Phase 2: the attention kernels against their plain versions.

def attention_inputs(B, PS, MP, kv_dtype, seed):
    """Pools with distinct pages per sequence, block-table rows with stale
    entries past the horizon and -1 holes, positions with page-boundary
    cases."""
    import numpy as np
    import torch
    KH, G, D = 8, 6, 128
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, MP * PS, size=B)
    pos[0] = MP * PS - 1                       # full table
    pos[1] = PS * (MP // 2)                    # first token of a page
    pos[2] = PS * (MP // 3) - 1                # last token of a page
    pos[3] = 0                                 # one token
    NP = B * MP
    perm = rng.permutation(NP)
    bt = np.full((B, MP), -1, np.int32)
    n = 0
    for b in range(B):
        for p in range(MP):
            if (p <= pos[b] // PS and (p == 0 or rng.random() > 0.05)) \
                    or rng.random() < 0.2:     # holes; stale rows
                bt[b, p] = perm[n]
                n += 1
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, KH * G, D), generator=g, device=dev).to(
        torch.bfloat16)
    shape = (NP, PS, KH, D)
    scales = None
    if kv_dtype == torch.int8:
        k = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        scales = tuple((torch.rand((NP, PS, KH), generator=g, device=dev)
                        * 0.04 + 0.01).to(torch.bfloat16) for _ in range(2))
    else:
        k = torch.randn(shape, generator=g, device=dev).to(kv_dtype)
        v = torch.randn(shape, generator=g, device=dev).to(kv_dtype)
    return (q, k, v, torch.from_numpy(bt).to(dev),
            torch.from_numpy(pos.astype(np.int32)).to(dev), scales)


def split_edge_inputs(kv_dtype, seed):
    """The serve shape (B=8, KH=8, G=6, D=128, PS=16, MP=64) with each
    lane on an edge of the kernel's split layout (S splits of
    ceil(P/S) live pages each): one token; the last token of the last
    split; fewer live pages than splits (empty tail splits); a split whose
    range holds only holes; no live token at all (first entry -1); the
    full table; a position past the table; random holes."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention.paged_attention import \
        split_count
    B, PS, MP = 8, 16, 64
    q, k, v, _, _, sc = attention_inputs(B, PS, MP, kv_dtype, seed)
    S = split_count(B, k.shape[2], MP, PS, torch.cuda.get_device_properties(
        0).multi_processor_count)
    rng = np.random.default_rng(seed)
    bt = np.arange(B * MP, dtype=np.int32).reshape(B, MP)
    P2 = min(2 * S, MP)                        # two pages per split
    pos = np.array([0, P2 * PS - 1, PS + 3, P2 * PS - 5, 5, MP * PS - 1,
                    MP * PS + 37, min(3 * S, MP) * PS - 9], np.int32)
    bt[3, 2:4] = -1                            # split 1 of lane 3: holes
    bt[4, 0] = -1                              # lane 4: no live token
    bt[7, rng.random(MP) < 0.1] = -1
    return (q, k, v, torch.from_numpy(bt).to(DEV),
            torch.from_numpy(pos).to(DEV), sc, S)


def sweep_inputs(B, QH, KH, D, NP, PS, MP, q_dtype, kv_dtype, seed):
    """Small inputs at other head counts, head dims and dtypes, with -1
    holes, one lane at position 0 and (B > 1) one with no live token."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, QH, D)).astype(
        np.float32)).to(DEV).to(q_dtype)
    shape = (NP, PS, KH, D)
    sc = None
    if kv_dtype == torch.int8:
        k, v = (torch.from_numpy(rng.integers(-127, 128, shape).astype(
            np.int8)).to(DEV) for _ in range(2))
        sc = tuple(torch.from_numpy(rng.uniform(0.01, 0.05, shape[:3]).astype(
            np.float32)).to(DEV).to(torch.bfloat16) for _ in range(2))
    else:
        k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(DEV).to(kv_dtype) for _ in range(2))
    pos = rng.integers(0, MP * PS, size=B).astype(np.int32)
    pos[0] = 0
    bt = rng.integers(0, NP, size=(B, MP)).astype(np.int32)
    bt[rng.random((B, MP)) < 0.1] = -1
    bt[0, 0] = 0
    if B > 1:
        pos[1], bt[1, 0] = PS - 1, -1
    return (q, k, v, torch.from_numpy(bt).to(DEV),
            torch.from_numpy(pos).to(DEV), sc)


def check_attention(q, k, v, bt, pos, sc, errs):
    """K1 and K1's partials against the plain version, K2 on the slots view
    against its plain version (over the lanes with a valid token: the
    plain oracle gives NaN for the others), and K1 == the K2 composition
    bit for bit.  Returns the errors and the equality."""
    import torch
    from repro_torch.kernels.fused_decode import (block_table_slots_ref,
                                                  fused_decode_kernel,
                                                  fused_decode_plain,
                                                  fused_decode_ref)
    from repro_torch.kernels.paged_attention import (paged_attention_kernel,
                                                     paged_attention_ref)
    PS = k.shape[1]
    o1 = fused_decode_kernel(q, k, v, bt, pos, scales=sc)
    e1 = close(o1, fused_decode_plain(q, k, v, bt, pos, scales=sc), BF16_TOL)
    part = fused_decode_kernel(q, k, v, bt, pos, scales=sc, partials=True)
    ref = fused_decode_plain(q, k, v, bt, pos, scales=sc, partials=True)
    ep = max(close(a, b, PARTIALS_TOL) for a, b in zip(part, ref))
    slots = block_table_slots_ref(bt, pos, page_size=PS)
    lens = (pos + 1).to(torch.int32)
    o2 = paged_attention_kernel(q, k, v, slots, lens, scales=sc)
    ok = (slots >= 0).any(dim=1)
    e2 = close(o2[ok], paged_attention_ref(q, k, v, slots, lens,
                                           scales=sc)[ok], BF16_TOL)
    same = torch.equal(o1, fused_decode_ref(q, k, v, bt, pos, scales=sc))
    torch.cuda.synchronize()
    if not same:
        raise AssertionError(f"K1 != K2 composition at q {tuple(q.shape)} "
                             f"{q.dtype}, pools {tuple(k.shape)} {k.dtype}")
    errs["K1"] = max(errs["K1"], e1, ep)
    errs["K2"] = max(errs["K2"], e2)
    return {"k1_err": e1, "k1_partials_err": ep, "k2_err": e2,
            "k1_eq_k2": same}


# (B, QH, KH, D, NP, PS, MP): MHA, GQA, MQA, 16 query heads a kv head (two
# head groups), head dims 8, 16, 64, 96 (lanes past D masked) and 256
SWEEP = [(3, 4, 4, 32, 64, 8, 6), (2, 8, 2, 32, 16, 8, 4),
         (3, 4, 1, 16, 32, 4, 8), (1, 4, 2, 64, 8, 16, 2),
         (4, 32, 2, 128, 256, 16, 32), (2, 12, 1, 256, 128, 16, 16),
         (4, 16, 2, 8, 64, 4, 8), (2, 6, 3, 96, 64, 32, 8)]


def phase_attention(errs):
    import torch
    cases = []
    for B in (8, 64):
        for PS, MP in ((16, 64), (16, 256), (256, 16)):
            for kv in (torch.bfloat16, torch.int8):
                q, k, v, bt, pos, sc = attention_inputs(
                    B, PS, MP, kv, seed=len(cases))
                cases.append({"B": B, "PS": PS, "MP": MP,
                              "kv": str(kv).replace("torch.", ""),
                              **check_attention(q, k, v, bt, pos, sc,
                                                errs)})
    for kv in (torch.bfloat16, torch.int8):
        q, k, v, bt, pos, sc, S = split_edge_inputs(kv, seed=100)
        cases.append({"B": 8, "PS": 16, "MP": 64, "split_edges": True,
                      "splits": S, "kv": str(kv).replace("torch.", ""),
                      **check_attention(q, k, v, bt, pos, sc, errs)})
    sweep = []
    for shape in SWEEP:
        for qd in (torch.float32, torch.bfloat16):
            for kv in (torch.float32, torch.bfloat16, torch.int8):
                args = sweep_inputs(*shape, qd, kv, seed=sum(shape))
                r = check_attention(*args, errs)
                sweep.append(max(r["k1_err"], r["k1_partials_err"],
                                 r["k2_err"]))
    emit("attention", tolerance={"bf16": BF16_TOL, "partials": PARTIALS_TOL},
         cases=cases, sweep={"shapes": SWEEP, "dtype_pairs": 6,
                             "max_err": max(sweep), "k1_eq_k2": True})


# ---------------------------------------------------------------------------
# Phase 3: the probe kernel on edge tables and a large churned table.

def check_probe(ht, queries, errs) -> dict:
    """K3 == ``find_batch`` bit for bit."""
    import torch
    from repro_torch.core import batched as BT
    from repro_torch.kernels.probe import probe_lookup_kernel
    fp, sp = BT.find_batch(ht, queries)
    fk, sk = probe_lookup_kernel(ht, queries)
    torch.cuda.synchronize()
    if not (fk.dtype == torch.bool and torch.equal(fk, fp)
            and torch.equal(sk, sp)):
        raise AssertionError(f"probe kernel != find_batch on m={BT.size(ht)}")
    errs["K3"] = max(errs["K3"], float((sk - sp).abs().max()))
    return {"m": BT.size(ht), "seed": int(ht.seed),
            "live": int(ht.num_keys), "tombstones": int(ht.num_tombs),
            "lookups": int(queries.shape[0]), "found": int(fp.sum())}


def probe_edge_cases(rng, errs) -> list:
    """Small and odd tables, the general hash branch above 2^16, a run
    longer than 32 x 32 cells, and keys read by their low 32 bits."""
    import torch
    from repro_torch.core import batched as BT
    from repro_torch.core import encoding as E

    def table(m, seed, keys, delete_every=0):
        ht = BT.create(m, seed=seed, device=DEV)
        ht, ret = BT.insert_batch(ht, keys)
        if bool((ret == 2).any()):
            raise AssertionError(f"insert ABORTed on the m={m} edge table")
        if delete_every:
            ht, _ = BT.delete_batch(ht, keys[::delete_every])
        return ht

    def keys(n):
        return torch.from_numpy(rng.choice(1 << 27, size=n,
                                           replace=False)).to(DEV)

    cases = []
    for m, seed, n_live, delete_every in ((1, 3, 1, 0), (3, 0, 3, 0),
                                          (5, 9, 4, 2), (192, 1, 172, 4),
                                          (384, 0, 345, 5),
                                          (200000, 21, 4096, 7)):
        drawn = keys(n_live + 64)
        live, absent = drawn[:n_live], drawn[n_live:]
        ht = table(m, seed, live, delete_every)
        high = live + (torch.arange(live.shape[0], device=DEV) % 7 + 1
                       ) * (1 << 32)              # keys >= 2^32
        queries = torch.cat([live, absent, high, live - (1 << 32),
                             -absent])            # negative keys
        cases.append({**check_probe(ht, queries, errs),
                      "keys_ge_2p32": True, "negative_keys": True})
    # m = 2^12: 1100 keys homed in the first 64 buckets make one run of
    # more than 32 x 32 cells
    m = 1 << 12
    ht = BT.create(m, seed=5, device=DEV)
    cand = keys(1 << 18)
    band = cand[BT._hash(ht, cand) < 64]
    if band.shape[0] < 1228:
        raise AssertionError("too few keys homed in the band")
    ht = table(m, 5, band[:1100], delete_every=9)
    empty = torch.nonzero(ht.table == E.EMPTY).flatten()
    run = int(torch.diff(empty, append=empty[:1] + m).max()) - 1
    if run <= 32 * 32:
        raise AssertionError(f"the long run has {run} cells")
    cases.append({**check_probe(ht, torch.cat([band[:1100], band[1100:1228]]),
                                errs), "run_cells": run})
    return cases


def churned_table(rng, strategy: str = "linear"):
    """The probe phase's state: a ``STRAT_M``-cell table (2^20) filled to
    load 0.9 through ``insert_batch`` under ``strategy``, a tenth deleted
    and refilled (tombstones, but none under hopscotch), with keys homed
    in the last 256 cells inserted first so a run wraps past 0; and 2^18
    queries, half present, 1024 of them deleted keys.  Robinhood inserts
    in batches of 2047 keys (its int32 priority needs m * B < 2^31), the
    others in 4096.  Returns (table, queries, fill seconds, info): info
    holds the live keys, the never-inserted keys, the ABORTs (0 required
    but for hopscotch), the batches, and the arbitration rounds and host
    syncs they took."""
    import torch
    from repro_torch.core import batched as BT
    from repro_torch.core import encoding as E
    from repro_torch.device import SYNC_STATS
    m, load = STRAT_M, 0.9
    chunk = 2047 if strategy == "robinhood" else 4096
    universe = torch.from_numpy(
        rng.choice(1 << 27, size=int(1.2 * m), replace=False)).to(DEV)
    ht = BT.create(m, seed=SEED + 7, strategy=strategy, device=DEV)
    tail = BT._hash(ht, universe) >= m - 256
    universe = torch.cat([universe[tail], universe[~tail]])
    n_live = int(load * m)
    first = universe[:n_live]
    refill = universe[n_live:n_live + m // 10]
    absent = universe[n_live + m // 10:]
    gone = first[torch.from_numpy(rng.permutation(n_live)[:m // 10]).to(DEV)]
    stats0 = dict(BT.ROUND_STATS)
    syncs0 = SYNC_STATS["host_syncs"]
    aborted, batches = [], 0
    t0 = time.perf_counter()
    for keys, op in ((first, BT.insert_batch), (gone, BT.delete_batch),
                     (refill, BT.insert_batch)):
        for i in range(0, keys.shape[0], chunk):
            ht, ret = op(ht, keys[i:i + chunk], strategy=strategy)
            batches += 1
            if op is BT.insert_batch:
                aborted.append(keys[i:i + chunk][ret == 2])
    fill_s = time.perf_counter() - t0
    aborted = torch.cat(aborted)
    if aborted.numel() and strategy != "hopscotch":
        raise AssertionError(f"{strategy}: insert ABORTed while filling")
    tab = ht.table
    if strategy == "hopscotch":
        # no probe runs and no tombstones: neighbourhoods wrap instead
        if int(ht.num_tombs):
            raise AssertionError("hopscotch: the churned table holds "
                                 "tombstones")
    elif not (bool(tab[0] != E.EMPTY) and bool(tab[-1] != E.EMPTY)) \
            or int(ht.num_tombs) == 0:
        raise AssertionError(f"{strategy}: the churned table has no "
                             f"wrapping run or no tombstone")
    n = 1 << 18
    present = first[torch.isin(first, torch.cat([gone, aborted]),
                               invert=True)]
    live = torch.cat([present, refill[torch.isin(refill, aborted,
                                                 invert=True)]])
    present = present[torch.from_numpy(
        rng.permutation(present.shape[0])[:n // 2]).to(DEV)]
    queries = torch.cat([present, absent[:n // 2 - 1024], gone[:1024]])
    info = {"live": live, "absent": absent, "aborts": int(aborted.numel()),
            "batches": batches,
            "round_stats": {k: BT.ROUND_STATS[k] - stats0[k]
                            for k in stats0},
            "host_syncs": SYNC_STATS["host_syncs"] - syncs0}
    return ht, queries, fill_s, info


def phase_probe(errs) -> dict:
    """Returns K3's numbers at the probe phase's shape for the kernels
    line."""
    import numpy as np
    from repro_torch.core import batched as BT
    from repro_torch.kernels.probe import probe_lookup_kernel
    from repro_torch.kernels.probe.probe import LANES, lookup_bytes, run_cells
    rng = np.random.default_rng(SEED + 3)
    edges = probe_edge_cases(rng, errs)
    ht, queries, fill_s, info = churned_table(rng)
    check_probe(ht, queries, errs)
    fp, sp = BT.find_batch(ht, queries)
    hv = BT._hash(ht, queries)
    cells = run_cells(ht.table, hv, sp, fp)
    ms = graph_ms(lambda: probe_lookup_kernel(ht, queries), 10)
    cold = cold_ms(lambda: probe_lookup_kernel(ht, queries), 20)
    plain = cuda_ms(lambda: BT.find_batch(ht, queries), 2)
    nbytes = lookup_bytes(ht.table, hv, sp, fp)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"m": BT.size(ht), "lookups": int(queries.shape[0]),
           "L": LANES, "ms": ms, "cold_ms": cold, "plain_ms": plain,
           "bytes": nbytes, "bound_ms": bound, "bound_by": "bytes",
           "bound_share": bound / ms, "cold_bound_share": bound / cold}
    emit("probe", edge_cases=edges, live=int(ht.num_keys),
         tombstones=int(ht.num_tombs), wrap_run=True, found=int(fp.sum()),
         equal=True, fill_s=fill_s, cells_mean=float(cells.float().mean()),
         cells_max=int(cells.max()), **out)
    return out, (ht, queries, fill_s, info)


# ---------------------------------------------------------------------------
# Phase 4: the three probe strategies and the no-reuse baseline.

def strategy_replay(strategy: str) -> dict:
    """A recorded mixed insert/delete/lookup trace (made from the seed) at
    m = ``REPLAY_M`` through ``apply_batch`` on the card and the same port
    functions on the CPU: table, meta, counters and return codes equal
    after every batch."""
    import numpy as np
    import torch
    from repro_torch.core import batched as BT
    from repro_torch.core.spec import OP_DELETE, OP_INSERT, OP_LOOKUP
    rng = np.random.default_rng(SEED + 23)
    m, B = REPLAY_M, REPLAY_BATCH
    universe = rng.choice(1 << 27, size=m + m // 4, replace=False)
    g = BT.create(m, seed=SEED + 5, strategy=strategy, device=DEV)
    c = BT.create(m, seed=SEED + 5, strategy=strategy, device="cpu")
    aborts = 0
    for i in range(REPLAY_BATCHES):
        p_ins = 0.7 if i < REPLAY_BATCHES // 2 else 0.4
        ops = rng.choice([OP_INSERT, OP_DELETE, OP_LOOKUP], size=B,
                         p=[p_ins, (1 - p_ins) / 2, (1 - p_ins) / 2])
        keys = universe[rng.integers(0, universe.size, size=B)]
        ops_t = torch.from_numpy(ops.astype(np.int32))
        keys_t = torch.from_numpy(keys.astype(np.int64))
        g, rg = BT.apply_batch(g, ops_t.to(DEV), keys_t.to(DEV),
                               strategy=strategy)
        c, rc = BT.apply_batch(c, ops_t, keys_t, strategy=strategy)
        same = (torch.equal(g.table.cpu(), c.table)
                and torch.equal(g.meta.cpu(), c.meta)
                and int(g.num_keys) == int(c.num_keys)
                and int(g.num_tombs) == int(c.num_tombs)
                and torch.equal(rg.cpu(), rc))
        if not same:
            raise AssertionError(f"{strategy}: card and CPU differ after "
                                 f"replay batch {i}")
        aborts += int(((ops_t == OP_INSERT) & (rc == 2)).sum())
    return {"m": m, "batches": REPLAY_BATCHES, "batch": B,
            "live": int(c.num_keys), "tombstones": int(c.num_tombs),
            "aborts": aborts, "equal_every_batch": True}


def check_invariants(ht, strategy: str, live, absent) -> None:
    """Every live key found at a slot that holds it; absent keys not
    found; num_keys/num_tombs equal the census; for hopscotch, ``meta``
    equal to the membership recomputed from the cells and no tombstone."""
    import torch
    from repro_torch.core import batched as BT
    from repro_torch.core import encoding as E
    chunk = 1 << 17
    for i in range(0, live.shape[0], chunk):
        keys = live[i:i + chunk]
        found, slot = BT.find_batch(ht, keys, strategy=strategy)
        if not bool(found.all()) or not torch.equal(
                ht.table[slot.long()], BT._final_word(BT._keys(ht, keys))):
            raise AssertionError(f"{strategy}: a live key is lost")
    for i in range(0, absent.shape[0], chunk):
        found, _ = BT.find_batch(ht, absent[i:i + chunk], strategy=strategy)
        if bool(found.any()):
            raise AssertionError(f"{strategy}: an absent key is found")
    tab = ht.table
    is_key = E.dec_key(tab) != E.RESERVED_KEY
    if not (int(ht.num_keys) == int(is_key.sum()) == live.shape[0]
            and int(ht.num_tombs) == int((tab == E.TOMBSTONE).sum())):
        raise AssertionError(f"{strategy}: counters differ from the census")
    if strategy == "hopscotch":
        m = BT.size(ht)
        idx = torch.nonzero(is_key).flatten()
        home = BT._hash(ht, E.dec_key(tab[idx])).long()
        d = torch.remainder(idx - home, m)
        mem = torch.zeros((m,), dtype=torch.int64, device=tab.device)
        mem.index_add_(0, home, torch.ones_like(d) << d.clamp(max=40))
        if int(ht.num_tombs) or bool((d >= 32).any()) \
                or not torch.equal(BT.wrap_i32(mem), ht.meta):
            raise AssertionError("hopscotch: meta differs from the "
                                 "membership of the cells")


def churn(ht, strategy, live, absent, rng, rounds, gao=None):
    """``rounds`` churn rounds at a fixed live set: each deletes
    ``CHURN_KEYS`` random live keys and inserts as many fresh ones, then
    checks the invariants.  With ``gao`` (a copy of the table) the same
    rounds run on it through the no-reuse baseline until it needs a
    rebuild.  Returns the tables, the live set and the per-round
    numbers."""
    import torch
    from repro_torch.core import batched as BT
    from repro_torch.core.baselines import gao_noreuse as GN
    chunk = 2047 if strategy == "robinhood" else 4096
    C, nxt = CHURN_KEYS, 0
    per_round = []
    for r in range(rounds):
        pick = torch.from_numpy(rng.permutation(live.shape[0])[:C]).to(DEV)
        dead = live[pick]
        fresh = absent[nxt:nxt + C]
        nxt += C
        if fresh.shape[0] < C:
            raise AssertionError("churn ran out of fresh keys")
        aborts = 0
        for i in range(0, C, chunk):
            ht, _ = BT.delete_batch(ht, dead[i:i + chunk], strategy=strategy)
        for i in range(0, C, chunk):
            ht, ret = BT.insert_batch(ht, fresh[i:i + chunk],
                                      strategy=strategy)
            ok = ret != 2
            aborts += int((~ok).sum())
            fresh_ok = fresh[i:i + chunk][ok]
            live = torch.cat([live, fresh_ok])
        keep = torch.ones(live.shape[0], dtype=torch.bool, device=DEV)
        keep[pick] = False
        live = live[keep]
        if aborts and strategy != "hopscotch":
            raise AssertionError(f"{strategy}: {aborts} ABORTs below full")
        check_invariants(ht, strategy, live, absent[nxt:nxt + STRAT_M // 16])
        row = {"occupancy": float(BT.occupancy(ht)),
               "tombstones": int(ht.num_tombs), "aborts": aborts}
        if gao is not None and not bool(GN.needs_rebuild(gao)):
            g_ab = 0
            for i in range(0, C, chunk):
                gao, _ = GN.delete_batch(gao, dead[i:i + chunk])
            for i in range(0, C, chunk):
                gao, ret = GN.insert_batch(gao, fresh[i:i + chunk])
                g_ab += int((ret == 2).sum())
            row.update(gao_occupancy=float(BT.occupancy(gao)),
                       gao_aborts=g_ab,
                       gao_needs_rebuild=bool(GN.needs_rebuild(gao)))
        per_round.append(row)
    return ht, live, per_round


def robinhood_probe(ht, queries, errs) -> dict:
    """K3 on the robinhood-built table: equal to ``find_batch`` bit for
    bit, timed warm and cold beside the byte bound; and K3 refuses a
    hopscotch lookup as the reference does."""
    from repro_torch.core import batched as BT
    from repro_torch.kernels.probe import ops as PK
    from repro_torch.kernels.probe import probe_lookup_kernel
    from repro_torch.kernels.probe.probe import lookup_bytes
    found, slot = PK.probe_lookup(ht, queries, strategy="robinhood")
    fp, sp = BT.find_batch(ht, queries, strategy="robinhood")
    if not (found.dtype == fp.dtype and bool((found == fp).all())
            and bool((slot == sp).all())):
        raise AssertionError("K3 != find_batch on the robinhood table")
    errs["K3"] = max(errs["K3"], float((slot - sp).abs().max()))
    try:
        PK.probe_lookup(ht, queries[:8], strategy="hopscotch")
        raise AssertionError("probe_lookup(strategy='hopscotch') ran")
    except ValueError:
        pass
    nbytes = lookup_bytes(ht.table, BT._hash(ht, queries), sp, fp)
    ms = graph_ms(lambda: probe_lookup_kernel(ht, queries), 10)
    cold = cold_ms(lambda: probe_lookup_kernel(ht, queries), 20)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {"equal": True, "hopscotch_raises": True, "m": BT.size(ht),
            "lookups": int(queries.shape[0]), "found": int(fp.sum()),
            "ms": ms, "cold_ms": cold,
            "plain_ms": cuda_ms(lambda: BT.find_batch(ht, queries), 2),
            "bytes": nbytes, "bound_ms": bound, "bound_by": "bytes",
            "bound_share": bound / ms, "cold_bound_share": bound / cold}


def phase_strategies(errs, linear_fill) -> dict:
    """For each strategy: the card-vs-CPU replay, then the 2^20-cell table
    (the probe phase's for linear) and ``CHURN_ROUNDS`` churn rounds with
    the invariants checked after each; the Gao baseline runs beside
    linear.  Returns robinhood's K3 numbers."""
    import numpy as np
    from repro_torch.core import batched as BT
    from repro_torch.device import SYNC_STATS
    rh = None
    for strategy in ("linear", "robinhood", "hopscotch"):
        replay = strategy_replay(strategy)
        rng = np.random.default_rng(SEED + 3)
        if strategy == "linear":
            ht, queries, fill_s, info = linear_fill
        else:
            ht, queries, fill_s, info = churned_table(rng, strategy)
        sample = STRAT_M // 16      # absent keys checked, never inserted
        check_invariants(ht, strategy, info["live"], info["absent"][:sample])
        gao = ht if strategy == "linear" else None
        stats0 = dict(BT.ROUND_STATS)
        syncs0 = SYNC_STATS["host_syncs"]
        t0 = time.perf_counter()
        ht, live, rounds = churn(ht, strategy, info["live"],
                                 info["absent"][sample:], rng,
                                 CHURN_ROUNDS, gao=gao)
        churn_s = time.perf_counter() - t0
        extra = {}
        if strategy == "robinhood":
            rh = robinhood_probe(ht, queries, errs)
            extra["k3"] = rh
        if strategy == "linear":
            g = [r for r in rounds if "gao_occupancy" in r]
            if not g or not g[-1]["gao_needs_rebuild"]:
                raise AssertionError("the no-reuse baseline never reached "
                                     "needs_rebuild")
            if any(r["aborts"] for r in rounds):
                raise AssertionError("linear ABORTed under churn")
            extra["gao_rounds_to_rebuild"] = len(g)
        emit("strategies", strategy=strategy, replay=replay,
             m=BT.size(ht), load=0.9, fill_s=fill_s,
             fill_batches=info["batches"],
             fill_aborts=info["aborts"],
             fill_round_stats=info["round_stats"],
             fill_rounds_per_batch=(info["round_stats"]["claim_rounds"]
                                    / info["batches"]),
             fill_syncs_per_batch=info["host_syncs"] / info["batches"],
             churn_rounds=CHURN_ROUNDS, churn_keys=CHURN_KEYS,
             churn_s=churn_s, live=int(ht.num_keys),
             churn_round_stats={k: BT.ROUND_STATS[k] - stats0[k]
                                for k in stats0},
             churn_host_syncs=SYNC_STATS["host_syncs"] - syncs0,
             rounds=rounds, invariants=True, **extra)
    return rh


# ---------------------------------------------------------------------------
# Phases 4 and 5: the main path.

def make_batcher(cfg, params, n_pages, traffic=SERVE_TRAFFIC):
    from repro_torch.launch.serve import ContinuousBatcher
    from repro_torch.serving.sched import Scheduler, synthetic_workload
    max_len = traffic["max_len"]
    sched = Scheduler(slots=BATCH, page_size=PAGE_SIZE, max_len=max_len,
                      megastep_k=MEGASTEP)
    srv = ContinuousBatcher(cfg, params, batch=BATCH, max_len=max_len,
                            page_size=PAGE_SIZE, megastep_k=MEGASTEP,
                            verify_block_table=True, scheduler=sched,
                            n_pages=n_pages, auto_refill=False,
                            seed=SEED, device=DEV)
    sched.submit_many(synthetic_workload(
        traffic["requests"], vocab_size=cfg.vocab_size, max_len=max_len,
        seed=SEED, prompt_len=traffic["prompt_len"],
        max_new=traffic["max_new"]))
    return srv


def step_args(cfg, state, tokens):
    """A serve step's arguments after the parameters: the vlm family's
    M-RoPE streams are the position on all three, as in the megastep."""
    pos = state["pos"]
    if cfg.family == "vlm":
        return (state, tokens, pos, pos[None, :, None].expand(3, -1, 1))
    return (state, tokens, pos)


def midrun_logits(cfg, params, state, tokens, max_len=MAX_LEN, run=None):
    """One fused (K1) and one plain (``attend_local``) serve step on clones
    of the same mid-run state: the model path end to end, over the live
    lanes, held to ``LOGITS_REL_TOL``."""
    import torch
    from repro_torch.serving import engine as EG
    out = []
    for fused in (True, False):
        c = dataclasses.replace(cfg, fused_kernel=fused)
        step = EG.make_serve_step(c, S_max=max_len, page_size=PAGE_SIZE)
        st = EG.clone_state(state)
        logits, _ = step(params, *step_args(cfg, st, tokens))
        out.append(logits)
    live = state["active"] & ~state["aborted"]
    a, b = out[0][live].float(), out[1][live].float()
    diff = (a - b).abs()
    rel = float((a - b).norm() / b.norm())
    top2 = b.topk(2, dim=-1).values
    argmax_eq = a.argmax(-1) == b.argmax(-1)
    res = dict(lanes=int(live.sum()),
               positions=state["pos"][live].tolist(), rel_err=rel,
               tolerance=LOGITS_REL_TOL, max_abs_diff=float(diff.max()),
               max_abs_logit=float(b.abs().max()),
               argmax_agree=int(argmax_eq.sum()),
               plain_top2_gap=(top2[:, 0] - top2[:, 1]).tolist())
    if run is None:
        emit("midrun_logits", **res)
    if not rel <= LOGITS_REL_TOL:
        raise AssertionError(f"{run or ARCH}: fused and plain serve steps' "
                             f"logits differ: relative error {rel} > "
                             f"{LOGITS_REL_TOL}")
    return res


def first_layer(state):
    """The first paged layer's pools and (int8) scales of a serve state."""
    pk, pv = state["pools"].k[0], state["pools"].v[0]
    sc = None
    if "pool_scales" in state:
        sc = (state["pool_scales"].k[0], state["pool_scales"].v[0])
    return pk, pv, sc


def live_two_dispatch_check(state, gen, G=6, q_dtype=None):
    """K1 == (slots view, then K2) bit for bit on the live serve state's
    first paged layer, with a random query of G heads a kv head."""
    import torch
    from repro_torch.kernels.fused_decode import (fused_decode_kernel,
                                                  fused_decode_ref)
    pk, pv, sc = first_layer(state)
    KH, D = pk.shape[2], pk.shape[3]
    q = torch.randn((BATCH, KH * G, D), generator=gen,
                    device=DEV).to(q_dtype or pk.dtype)
    bt, pos = state["block_table"], state["pos"]
    if not torch.equal(fused_decode_kernel(q, pk, pv, bt, pos, scales=sc),
                       fused_decode_ref(q, pk, pv, bt, pos, scales=sc)):
        raise AssertionError("live state: K1 != K2 composition")


def tables_equal(a, b) -> bool:
    import torch
    return (torch.equal(a["table"].table, b["table"].table)
            and torch.equal(a["table"].meta, b["table"].meta)
            and int(a["table"].num_keys) == int(b["table"].num_keys)
            and int(a["table"].num_tombs) == int(b["table"].num_tombs)
            and torch.equal(a["block_table"], b["block_table"]))


def phase_serve(cfg, params, checks, traffic=SERVE_TRAFFIC):
    """Serves the workload under ``cfg.probe_strategy``, the fused run in
    lockstep with the plain one (a family without a page table, the ssm
    one, has no plain twin: ``fused_kernel`` changes nothing there).
    Returns a dict: the state after round 3 (``snap``), the state with the
    most live pages (``peak``, with its next tokens and its lanes' stop
    lengths; without a table, the most tokens), the number of megasteps,
    the megastep function, the fused batcher (``srv``), the run's numbers
    (``stats``) and, for a local/global config or an ssm or hybrid one,
    the first state with a lane ``WINDOW_MARGIN`` tokens past the window
    or past ``SSM_FORWARD_POS`` (``window``: the state, its next tokens,
    the lane and the lane's tokens so far)."""
    import numpy as np
    import torch
    from repro_torch.device import SYNC_STATS
    from repro_torch.kernels.fused_decode import fused_decode_kernel
    from repro_torch.serving import engine as EG
    n_pages = pool_pages(traffic["max_len"])
    n_paged, _ = EG._n_attn_layers(cfg)
    fused = make_batcher(cfg, params, n_pages, traffic)
    plain = (make_batcher(dataclasses.replace(cfg, fused_kernel=False),
                          params, n_pages, traffic) if n_paged else None)
    G = cfg.n_q // max(cfg.n_kv, 1)
    W = cfg.local_window if cfg.pattern_local else 0
    capture_at = W + WINDOW_MARGIN if W else (
        SSM_FORWARD_POS if cfg.family in ("ssm", "hybrid") else None)
    window, max_pos = None, 0
    admissions = []           # (lane, req_id) in the order they were seated
    apply_plan = fused._apply_plan

    def logged_apply(plan):
        admissions.extend((s, r.req_id) for s, r in plan.admissions)
        apply_plan(plan)
    fused._apply_plan = logged_apply
    tokens = torch.zeros((), dtype=torch.int64, device=DEV)
    megasteps = 0
    inner = fused.mega_fn

    def counted(params, state, *args):
        nonlocal tokens, megasteps
        p0 = state["pos"]
        toks, st = inner(params, state, *args)
        tokens = tokens + (st["pos"] - p0).sum()
        megasteps += 1
        return toks, st
    fused.mega_fn = counted

    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    syncs0 = SYNC_STATS["host_syncs"]
    fused_s, rounds, snap, peak, peak_live = 0.0, 0, None, None, -1
    peak_tokens = peak_stop = None
    torch.cuda.reset_peak_memory_stats()
    while not (fused.sched.drained
               and (plain is None or plain.sched.drained)):
        if rounds >= 400:
            raise AssertionError("serve did not drain in 400 rounds")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused.step_round()
        torch.cuda.synchronize()
        fused_s += time.perf_counter() - t0
        rounds += 1
        if plain is not None:
            syncs = SYNC_STATS["host_syncs"]
            plain.step_round()
            SYNC_STATS["host_syncs"] = syncs      # count the fused run only
            if not tables_equal(fused.state, plain.state):
                raise AssertionError(f"round {rounds}: fused and plain "
                                     f"page tables differ")
            with uncounted(checks):
                live_two_dispatch_check(fused.state, gen, G,
                                        cfg.activation_dtype())
        pos = fused.state["pos"] * fused.state["active"]
        live = (int(fused.state["table"].num_keys) if n_paged
                else int(pos.sum()))
        if live > peak_live and bool(fused.state["active"].any()):
            peak, peak_live = EG.clone_state(fused.state), live
            peak_tokens = fused.tokens.clone()
            peak_stop = fused.lane_stop.copy()
        max_pos = max(max_pos, int(fused.state["pos"].max()))
        if capture_at and window is None and int(pos.max()) > capture_at:
            lane = int(pos.argmax())
            req = fused.sched.lanes[lane]
            seq = np.concatenate([req.prompt, np.asarray(
                req.sampled, np.int32)])[:int(pos[lane]) + 1]
            if (seq.size != int(pos[lane]) + 1
                    or int(seq[-1]) != int(fused.tokens[lane, 0])):
                raise AssertionError("the lane's tokens do not line up "
                                     "with its position")
            window = (EG.clone_state(fused.state), fused.tokens.clone(),
                      lane, seq)
        if rounds == 3:
            if not bool(fused.state["active"].any()):
                raise AssertionError("no live lane after round 3")
            snap = EG.clone_state(fused.state)
    n_tok = int(tokens)
    lanes_seen = set()
    reseated = []             # admissions to a lane that had held another
    for lane, rid in admissions:
        if lane in lanes_seen:
            reseated.append((lane, rid))
        lanes_seen.add(lane)
    st = fused.sched.summary()
    strategy = cfg.probe_strategy
    ps = plain.sched.summary() if plain is not None else st
    n_req = traffic["requests"]
    if st["completed"] != n_req or any(
            st[k] != ps[k] for k in ("completed", "aborts", "pool_grows",
                                     "preemptive_evictions")):
        raise AssertionError(f"{cfg.name} {strategy}: {st['completed']} of "
                             f"{n_req} requests completed, or the "
                             f"fused and plain runs' schedules differ")
    # robinhood keeps linear's exact no-ABORT bound; hopscotch's
    # displacement can fail below full (its aborts are printed)
    if strategy != "hopscotch" and st["aborts"]:
        raise AssertionError(f"{strategy}: aborts: {st['aborts']}")
    if fused_decode_kernel.launches != n_paged * MEGASTEP * megasteps:
        raise AssertionError(
            f"K1 launched {fused_decode_kernel.launches} times on the serve "
            f"path, not once per paged layer per token step "
            f"({n_paged} x {MEGASTEP} x {megasteps} megasteps)")
    same = total = 0
    if plain is not None:
        pl = {r.req_id: r for r in plain.sched.finished}
        for r in fused.sched.finished:
            a, b = np.asarray(r.sampled), np.asarray(pl[r.req_id].sampled)
            total += a.size
            same += int((a == b).sum())
    stats = dict(
        strategy=strategy, arch=cfg.name, layers=cfg.num_layers,
        paged_layers=n_paged, d_model=cfg.d_model,
        n_q=cfg.n_q, n_kv=cfg.n_kv, head_dim=cfg.hd, d_ff=cfg.d_ff,
        vocab=cfg.vocab_size, kv_cache_dtype=cfg.kv_cache_dtype,
        batch=BATCH, max_len=traffic["max_len"], page_size=PAGE_SIZE,
        megastep=MEGASTEP, requests=n_req,
        n_pages_start=n_pages if n_paged else None,
        n_pages_end=(int(fused.state["pools"].k.shape[1]) if n_paged
                     else None), rounds=rounds,
        completed=st["completed"], aborts=st["aborts"],
        pool_grows=st["pool_grows"],
        preemptive_evictions=st["preemptive_evictions"],
        megasteps=megasteps, token_steps=n_tok,
        generated=sum(len(r.sampled) for r in fused.sched.finished),
        seconds=fused_s, tokens_per_s=n_tok / fused_s,
        batch_steps_per_s=megasteps * MEGASTEP / fused_s,
        host_syncs_per_token=(SYNC_STATS["host_syncs"] - syncs0) / n_tok,
        k1_launches=fused_decode_kernel.launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        tables_equal_every_round=plain is not None,
        k1_eq_k2_every_round=plain is not None,
        token_agreement=same / total if total else None, max_pos=max_pos,
        reseated_lanes=len(reseated),
        fallback_report=EG.fallback_report(cfg))
    if W:
        stats.update(window=W)
    if cfg.family in ("ssm", "hybrid"):
        stats.update(d_inner=cfg.d_inner, ssm_heads=cfg.ssm_heads,
                     ssm_state=cfg.ssm_state,
                     shared_attn_every=cfg.shared_attn_every or None)
    return dict(snap=snap, peak=peak, peak_tokens=peak_tokens,
                peak_stop=peak_stop, megasteps=megasteps, mega=inner,
                window=window, srv=fused, reseated=reseated, stats=stats)


def phase_rebuild(snap, cfg):
    """The serve state after round 3 re-hashed into a 2x pool under
    ``cfg.probe_strategy`` with ``use_kernel=True`` and without: equal bit
    for bit.  K3 launches once for linear and robinhood and never for
    hopscotch, whose fallback ``fallback_report`` names."""
    import torch
    from repro_torch.kernels.probe import probe_lookup_kernel
    from repro_torch.serving import engine as EG
    from repro_torch.serving.engine import clone_state
    strategy = cfg.probe_strategy
    m = snap["pools"].k.shape[1]
    before = probe_lookup_kernel.launches
    a = EG.rebuild_page_table(clone_state(snap), n_pages=2 * m,
                              use_kernel=True, strategy=strategy)
    k3 = probe_lookup_kernel.launches - before
    b = EG.rebuild_page_table(clone_state(snap), n_pages=2 * m,
                              use_kernel=False, strategy=strategy)
    eq = (tables_equal(a, b) and torch.equal(a["pools"].k, b["pools"].k)
          and torch.equal(a["pools"].v, b["pools"].v))
    if not eq:
        raise AssertionError(f"{strategy}: rebuild with use_kernel != "
                             f"rebuild with find_batch")
    report = EG.fallback_report(cfg)["probe_strategy"]
    want = 0 if strategy == "hopscotch" else 1
    if k3 != want or (report == f"{strategy}: ok") != (want == 1):
        raise AssertionError(f"{strategy}: the rebuild launched K3 {k3} "
                             f"times (expected {want}); report {report!r}")
    emit("rebuild", strategy=strategy, n_pages_from=m, n_pages_to=2 * m,
         live_pages=int(a["table"].num_keys), equal=True, k3_launches=k3,
         fallback_report=report)
    return a


def phase_profile(cfg, params):
    """Where a serve round's time goes: three rounds of a fresh fused
    batcher (after two unprofiled ones) under ``torch.profiler``; the
    device's busy share is its kernel time over the rounds' wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.device import SYNC_STATS
    srv = make_batcher(cfg, params, pool_pages())
    for _ in range(2):
        srv.step_round()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if DEV == "cuda" else [])
    syncs0 = SYNC_STATS["host_syncs"]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            srv.step_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue        # a host op: its kernels are listed themselves
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    emit("profile", rounds=3, token_steps=3 * MEGASTEP, wall_s=wall,
         device_busy_s=busy if rows else None,
         device_busy_share=busy / wall if rows else None,
         host_syncs=SYNC_STATS["host_syncs"] - syncs0,
         top_kernels=[{"name": k[:80], "ms": us / 1e3, "count": n}
                      for us, k, n in rows[:8]])


# ---------------------------------------------------------------------------
# The sharded table: the simulated multi-host storm on the card.

def phase_sharded() -> None:
    """``PrefixRouter`` over a ``ShardedPageTable`` of 4 simulated host
    groups, every shard's tables on the one card, at the reference's
    shard-soak settings, for linear and hopscotch.  The harness's shadow
    page map is the oracle (checked every other round and at the end):
    every request completes, 0 proactive aborts, a lazy migration
    finishes, and the shards' live counters equal the shadow's census."""
    from repro_torch.device import SYNC_STATS
    from repro_torch.launch import shard_soak as SS
    geo = dict(pages_per_shard=48, page_size=4, max_len=32)
    for strategy in ("linear", "hopscotch"):
        wl = SS.storm_workload(hosts=SOAK["hosts"],
                               requests=SOAK["requests"],
                               overcommit=SOAK["overcommit"], seed=SEED,
                               **geo)
        cluster = SS.SimCluster(hosts=SOAK["hosts"], slots_per_shard=4,
                                megastep_k=4, strategy=strategy,
                                fail_on_abort=True, device=DEV, **geo)
        syncs0 = SYNC_STATS["host_syncs"]
        t0 = time.perf_counter()
        s = cluster.run_storm(wl, max_rounds=400,
                              grow_round=SOAK["grow_round"],
                              lose_round=SOAK["lose_round"])
        secs = time.perf_counter() - t0
        census = cluster.shadow.census()
        if not (int(s["completed"]) == int(s["submitted"]) == len(wl)
                and int(s["aborts_observed"]) == 0
                and int(s["migrations_finished"]) >= 1
                and cluster.spt.total_live_pages() == census):
            raise AssertionError(f"sharded storm ({strategy}): {s}")
        emit("sharded", strategy=strategy, **SOAK,
             device=str(cluster.spt.device), rounds=int(s["rounds"]),
             submitted=int(s["submitted"]), completed=int(s["completed"]),
             rehomed=int(s["rehomed"]), pool_grows=int(s["pool_grows"]),
             migrations_finished=int(s["migrations_finished"]),
             aborts_observed=int(s["aborts_observed"]),
             verifies=int(s["verifies"]), live_shards=int(s["live_shards"]),
             live_pages=census, counters_equal_census=True, seconds=secs,
             host_syncs=SYNC_STATS["host_syncs"] - syncs0)


# ---------------------------------------------------------------------------
# Phase 6: the kernels at the main path's shapes.

def sdpa_ms(q, pk, pv, bt, pos, PS, scales=None):
    """One ``scaled_dot_product_attention`` call over the same KV gathered
    contiguously per sequence (int8 pools dequantized to q's dtype; the
    gather is not timed)."""
    import torch
    import torch.nn.functional as F
    B, QH, D = q.shape
    KH = pk.shape[2]
    S = int(pos.max()) + 1
    MPs = -(-S // PS)
    rows = bt[:, :MPs].clamp_min(0).long()

    def gather(pool, sc):
        x = pool[rows]
        if sc is not None:
            x = (x.float() * sc[rows].float()[..., None]).to(q.dtype)
        return x.reshape(B, MPs * PS, KH, D)[:, :S]
    k = gather(pk, None if scales is None else scales[0])
    v = gather(pv, None if scales is None else scales[1])
    k = k.permute(0, 2, 1, 3).repeat_interleave(QH // KH, dim=1)
    v = v.permute(0, 2, 1, 3).repeat_interleave(QH // KH, dim=1)
    mask = (torch.arange(S, device=q.device)[None, :]
            <= pos[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    return graph_ms(lambda: F.scaled_dot_product_attention(
        q4, k, v, attn_mask=mask), 100)


def attention_bounds(q, pk, bt, pos, scales=None):
    """K1's and K2's least times in ms, each with what bounds it: the
    valid tokens' K and V read once (and their int8 scales), the table
    rows, q, the outputs (K1's f32 partials; K2's output in q's dtype);
    operations: q.k and p.v per valid token and query head, in f32."""
    import torch
    B, MP = bt.shape
    _, PS, KH, D = pk.shape
    G = q.shape[1] // KH
    live = (torch.arange(MP, device=DEV)[None, :] * PS
            <= pos[:, None]) & (bt >= 0)
    ntok = int((torch.clamp(pos[:, None] + 1 - torch.arange(
        MP, device=DEV)[None, :] * PS, 0, PS) * live).sum())
    kv_bytes = ntok * KH * D * 2 * pk.element_size()
    if scales is not None:
        kv_bytes += ntok * KH * 2 * scales[0].element_size()
    flops = 4 * ntok * KH * G * D
    k1_bytes = (kv_bytes + B * MP * 4 + B * 4 + q.numel() * q.element_size()
                + 4 * (B * KH * G * D + 2 * B * KH * G))
    k2_bytes = (kv_bytes + B * MP * 4 + B * 4
                + 2 * q.numel() * q.element_size())

    def bound(nbytes):
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"

    return bound(k1_bytes), bound(k2_bytes)


def long_context():
    """K1 and K2 at the attention phase's long-context case (B=64, PS=16,
    MP=256, bf16, up to 4096 tokens per sequence: hundreds of MB of KV,
    far past the 50 MB L2): device ms, bound, bound share, the SDPA
    yardstick over the same KV and the split count."""
    import torch
    from repro_torch.kernels.fused_decode import (block_table_slots_ref,
                                                  fused_decode_kernel)
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.paged_attention.paged_attention import \
        split_count
    B, PS, MP = 64, 16, 256
    q, pk, pv, bt, pos, _ = attention_inputs(B, PS, MP, torch.bfloat16,
                                             seed=8)
    slots = block_table_slots_ref(bt, pos, page_size=PS)
    lens = (pos + 1).to(torch.int32)
    (b1, by1), (b2, by2) = attention_bounds(q, pk, bt, pos)
    lib = sdpa_ms(q, pk, pv, bt, pos, PS)
    S = split_count(B, pk.shape[2], MP, PS, torch.cuda.get_device_properties(
        0).multi_processor_count)
    k1 = graph_ms(lambda: fused_decode_kernel(q, pk, pv, bt, pos,
                                              partials=True), 20)
    k2 = graph_ms(lambda: paged_attention_kernel(q, pk, pv, slots, lens), 20)
    shape = {"B": B, "PS": PS, "MP": MP, "kv": "bfloat16",
             "max_tokens": int(pos.max()) + 1, "splits": S,
             "library_ms": lib}
    return {"K1": {**shape, "ms": k1, "bound_ms": b1, "bound_by": by1,
                   "bound_share": b1 / k1},
            "K2": {**shape, "ms": k2, "bound_ms": b2, "bound_by": by2,
                   "bound_share": b2 / k2}}


def k1_at_state(cfg, state, run):
    """K1 at a family's serve shape: the first paged layer of its state
    with the most live pages and a random query of its head layout.
    Held to its plain version (``PARTIALS_TOL``) and bit for bit to the
    K2 composition; device ms from CUDA-graph replay beside the plain
    version's, the bound, the bound share and the SDPA yardstick."""
    import torch
    from repro_torch.kernels.fused_decode import (fused_decode_kernel,
                                                  fused_decode_plain,
                                                  fused_decode_ref)
    from repro_torch.kernels.paged_attention.paged_attention import \
        split_count
    pk, pv, sc = first_layer(state)
    bt, pos = state["block_table"], state["pos"]
    B, MP = bt.shape
    _, PS, KH, D = pk.shape
    g = torch.Generator(device=DEV).manual_seed(SEED + 17)
    q = torch.randn((B, cfg.n_q, D), generator=g, device=DEV).to(
        cfg.activation_dtype())
    part = fused_decode_kernel(q, pk, pv, bt, pos, scales=sc, partials=True)
    ref = fused_decode_plain(q, pk, pv, bt, pos, scales=sc, partials=True)
    err = max(close(a, b, PARTIALS_TOL) for a, b in zip(part, ref))
    if not torch.equal(fused_decode_kernel(q, pk, pv, bt, pos, scales=sc),
                       fused_decode_ref(q, pk, pv, bt, pos, scales=sc)):
        raise AssertionError(f"{run}: K1 != K2 composition")
    (bound, by), _ = attention_bounds(q, pk, bt, pos, sc)
    ms = graph_ms(lambda: fused_decode_kernel(q, pk, pv, bt, pos, scales=sc,
                                              partials=True), 100)
    return {"run": run, "B": B, "KH": KH, "G": cfg.n_q // KH, "D": D,
            "PS": PS, "MP": MP, "kv": str(pk.dtype).replace("torch.", ""),
            "max_tokens": int(pos.max()) + 1,
            "splits": split_count(B, KH, MP, PS,
                                  torch.cuda.get_device_properties(
                                      0).multi_processor_count),
            "max_abs_err": err, "ms": ms,
            "plain_ms": graph_ms(lambda: fused_decode_plain(
                q, pk, pv, bt, pos, scales=sc, partials=True), 10),
            "bound_ms": bound, "bound_by": by, "bound_share": bound / ms,
            "library_ms": sdpa_ms(q, pk, pv, bt, pos, PS, sc)}


def megastep_bits(mega, params, state, tokens, stop):
    """One megastep run twice from two clones of one state: the tokens and
    every state leaf equal bit for bit."""
    import torch
    from repro_torch.serving import engine as EG
    outs = []
    for _ in range(2):
        st = EG.clone_state(state)
        outs.append(mega(params, st, tokens.clone(),
                         None if stop is None
                         else torch.as_tensor(stop, device=DEV)))
    (ta, sa), (tb, sb) = outs
    leaves = [(k, x, y) for k in sa
              for x, y in (zip(sa[k], sb[k]) if isinstance(sa[k], tuple)
                           else [(sa[k], sb[k])])]
    diff = [k for k, x, y in leaves if not torch.equal(x, y)]
    if not torch.equal(ta, tb) or diff:
        raise AssertionError(f"a megastep run twice from one state gave "
                             f"other bits: tokens equal "
                             f"{torch.equal(ta, tb)}, leaves {diff}")
    return True


def forward_check(cfg, logits, params, seq, check: bool = True, **kw):
    """One lane's decode logits against the family's ``forward`` of the
    lane's tokens ``seq`` on the card (``kw``: encdec's ``src_embeds``):
    within ``FORWARD_REL_TOL`` and the same argmax, unless ``check`` is
    False."""
    import torch
    from repro_torch.models.registry import get_model
    ref, _ = get_model(cfg).forward(cfg, params, torch.as_tensor(
        seq[None], device=DEV).long(), last_only=True, **kw)
    a, b = logits.float(), ref[0, -1].float()
    rel = float((a - b).norm() / b.norm())
    res = dict(position=int(seq.size) - 1, rel_err=rel,
               tolerance=FORWARD_REL_TOL,
               argmax_agree=bool(a.argmax() == b.argmax()),
               max_abs_diff=float((a - b).abs().max()))
    if check and not (rel <= FORWARD_REL_TOL and res["argmax_agree"]):
        raise AssertionError(f"{cfg.name}: decode != forward: relative "
                             f"error {rel} (tolerance {FORWARD_REL_TOL}), "
                             f"argmax equal {res['argmax_agree']}")
    return res


def window_forward(cfg, params, window, max_len, check: bool = True):
    """One decode step (K1 where the family runs it) from the captured
    state (gemma3: a lane past the window; ssm and hybrid: a lane past
    ``SSM_FORWARD_POS``), that lane's logits against the family's
    ``forward`` of the lane's tokens (``forward_check``; with ``check``
    False the distance is only measured)."""
    from repro_torch.serving import engine as EG
    state, tokens, lane, seq = window
    step = EG.make_serve_step(cfg, S_max=max_len, page_size=PAGE_SIZE)
    st = EG.clone_state(state)
    logits, _ = step(params, st, tokens, st["pos"])
    return dict(lane=lane, **forward_check(cfg, logits[lane], params, seq,
                                           check=check))


def f32_replay_forward(cfg, params, window, max_len):
    """The captured lane's tokens replayed one decode step at a time
    through the engine in float32 (the same kernels: K1 on f32 pools for
    a hybrid), on one lane from a fresh state; the last step's logits
    against the float32 ``forward`` (``forward_check``)."""
    import torch
    from repro_torch.models import nn
    from repro_torch.serving import engine as EG
    _, _, lane, seq = window
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = nn.tree_map(lambda t: t.float(), params)
    state, _ = EG.make_decode_state(c32, 1, S_max=max_len,
                                    page_size=PAGE_SIZE, device=DEV)
    step = EG.make_serve_step(c32, S_max=max_len, page_size=PAGE_SIZE)
    toks = torch.as_tensor(seq, dtype=torch.int32, device=DEV)
    for t in range(toks.shape[0]):
        logits, state = step(p32, state, toks[t:t + 1][None],
                             torch.full((1,), t, dtype=torch.int32,
                                        device=DEV))
    return dict(lane=lane, **forward_check(c32, logits[0], p32, seq))


def reseated_alone(cfg, params, res, traffic):
    """The first request seated on a lane that had held another, served
    again alone in a fresh batcher of the same shape: its sampled tokens
    must be equal (the card's counterpart of
    ``test_readmission_resets_recurrent_state``: the reset leaves no trace
    of the lane's previous occupant)."""
    from repro_torch.launch.serve import ContinuousBatcher
    from repro_torch.serving.sched import Request, Scheduler
    if not res["reseated"]:
        raise AssertionError(f"{cfg.name}: no lane was re-seated")
    lane, rid = res["reseated"][0]
    req = next(r for r in res["srv"].sched.finished if r.req_id == rid)
    max_len = traffic["max_len"]
    sched = Scheduler(slots=BATCH, page_size=PAGE_SIZE, max_len=max_len,
                      megastep_k=MEGASTEP)
    alone = ContinuousBatcher(cfg, params, batch=BATCH, max_len=max_len,
                              page_size=PAGE_SIZE, megastep_k=MEGASTEP,
                              scheduler=sched,
                              n_pages=pool_pages(max_len),
                              auto_refill=False, seed=SEED, device=DEV)
    sched.submit(Request(req_id=rid, prompt=req.prompt,
                         max_new_tokens=req.max_new_tokens))
    if not alone.run_until_drained(max_rounds=400):
        raise AssertionError(f"{cfg.name}: the lone request did not drain")
    got = sched.finished[0].sampled
    if got != req.sampled:
        raise AssertionError(f"{cfg.name}: request {rid} on re-seated lane "
                             f"{lane} sampled other tokens than alone in a "
                             f"fresh batcher")
    return dict(req_id=rid, lane=lane, prompt_len=int(req.prompt.size),
                sampled=len(got), equal=True)


def serve_encdec(cfg, params, traffic):
    """seamless: the encoder prefill (``prepare_encdec_state``) on seeded
    ``src_embeds`` [B, max_len/8, d], then the megastep driven directly
    over the B lanes until each has taken ``traffic["tokens"]`` tokens,
    the first ``traffic["prompt"]`` forced from seeded prompts.  The pool
    starts at the serve phase's size, which these lanes outgrow: before a
    megastep that could need more pages than the pool has free (a lane
    takes at most one page in K < page-size tokens), the state is rebuilt
    into twice the pool, as the scheduler's proactive growth does; an
    abort fails the run.  Then one decode
    step from the final state, lane 0's logits against ``encdec.forward``
    of its tokens and its source.  Returns the run's numbers, the state
    after megastep 3 (``snap``) and the final state (``peak``, with its
    next tokens)."""
    import numpy as np
    import torch
    from repro_torch.device import SYNC_STATS, host_numpy
    from repro_torch.serving import engine as EG
    max_len, n_tok, n_prompt = (traffic["max_len"], traffic["tokens"],
                                traffic["prompt"])
    B, K = BATCH, MEGASTEP
    n_pages = pool_pages(max_len)
    g = torch.Generator(device=DEV).manual_seed(SEED + 21)
    src = torch.randn((B, max_len // 8, cfg.d_model), generator=g,
                      device=DEV).to(cfg.activation_dtype())
    prompts = np.random.default_rng(SEED + 21).integers(
        0, cfg.vocab_size, (B, n_prompt)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    state, _ = EG.make_decode_state(cfg, B, S_max=max_len,
                                    page_size=PAGE_SIZE, n_pages=n_pages,
                                    device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = EG.prepare_encdec_state(cfg, params, state, src)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    mega = EG.make_serve_megastep(cfg, S_max=max_len, K=K,
                                  page_size=PAGE_SIZE)
    seqs = [list(prompts[b, :1]) for b in range(B)]
    tokens = torch.as_tensor(prompts[:, :1], device=DEV)
    pos = np.zeros(B, np.int64)
    megasteps, grows, snap, secs = 0, 0, None, 0.0
    syncs0 = SYNC_STATS["host_syncs"]
    while pos.min() < n_tok:
        if megasteps >= 4 * n_tok // K:
            raise AssertionError(f"{cfg.name}: the lanes did not reach "
                                 f"{n_tok} tokens")
        if EG.decode_headroom(state).free_cells < B:
            m = state["pools"].k.shape[1]
            state = EG.rebuild_page_table(state, n_pages=2 * m)
            grows += 1
        ahead = pos[:, None] + np.arange(1, K + 1)[None, :]
        fmask = ahead < n_prompt
        forced = np.where(fmask, prompts[np.arange(B)[:, None],
                                         np.minimum(ahead, n_prompt - 1)], 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, state = mega(params, state, tokens, None,
                           torch.as_tensor(forced.astype(np.int32),
                                           device=DEV),
                           torch.as_tensor(fmask, device=DEV))
        p1 = host_numpy(state["pos"]).astype(np.int64)
        torch.cuda.synchronize()
        secs += time.perf_counter() - t0
        megasteps += 1
        t = host_numpy(toks)
        for b in range(B):
            seqs[b].extend(int(x) for x in t[b, :p1[b] - pos[b]])
        pos, tokens = p1, toks[:, -1:]
        if bool(state["aborted"].any()):
            raise AssertionError(f"{cfg.name}: a lane aborted")
        if megasteps == 3:
            snap = EG.clone_state(state)
    token_steps = int(pos.sum())
    if any(len(q) != int(p) + 1 for q, p in zip(seqs, pos)):
        raise AssertionError(f"{cfg.name}: the lanes' tokens do not line up "
                             f"with their positions")
    stats = dict(
        arch=cfg.name, layers=cfg.num_layers,
        encoder_layers=cfg.encoder_layers, d_model=cfg.d_model,
        n_q=cfg.n_q, n_kv=cfg.n_kv, head_dim=cfg.hd, d_ff=cfg.d_ff,
        vocab=cfg.vocab_size, batch=B, max_len=max_len,
        src_len=int(src.shape[1]), page_size=PAGE_SIZE, megastep=K,
        prompt=n_prompt, tokens=n_tok, n_pages_start=n_pages,
        n_pages_end=int(state["pools"].k.shape[1]), pool_grows=grows,
        aborts=0,
        megasteps=megasteps, token_steps=token_steps, encode_s=encode_s,
        seconds=secs, tokens_per_s=token_steps / secs,
        batch_steps_per_s=megasteps * K / secs,
        host_syncs_per_token=(SYNC_STATS["host_syncs"] - syncs0)
        / token_steps,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        max_pos=int(pos.max()), fallback_report=EG.fallback_report(cfg))
    step = EG.make_serve_step(cfg, S_max=max_len, page_size=PAGE_SIZE)
    logits, _ = step(params, EG.clone_state(state), tokens, state["pos"])
    stats["forward"] = dict(lane=0, **forward_check(
        cfg, logits[0], params, np.asarray(seqs[0], np.int32),
        src_embeds=src[:1]))
    return dict(snap=snap, peak=state, peak_tokens=tokens,
                peak_stop=None, megasteps=megasteps, mega=mega,
                stats=stats)


def phase_families(main_cfg, main_params, checks):
    """The other model families through the serve machinery (see the
    module docstring, phase 9).  Returns K1's launches on each run's path
    and K1's numbers at each paged run's shape."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.serving import engine as EG
    wrappers = kernel_wrappers()
    by_family, shapes = {}, []
    for run, arch, layers, over, traffic in FAMILIES:
        if arch == ARCH:
            cfg, params = dataclasses.replace(main_cfg, **over), main_params
        else:
            cfg = dataclasses.replace(get_config(arch), fused_kernel=True,
                                      **over)
            if layers:
                cfg = dataclasses.replace(cfg, num_layers=layers)
            params = get_model(cfg).init(
                cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
        t0 = time.perf_counter()
        for w in wrappers.values():
            w.launches = 0
        if cfg.family == "encdec":
            res = serve_encdec(cfg, params, traffic)
        else:
            res = phase_serve(cfg, params, checks, traffic)
        n_paged, _ = EG._n_attn_layers(cfg)
        if n_paged:
            phase_rebuild(res["snap"], cfg)
        launches = {k: w.launches for k, w in wrappers.items()}
        # K1 runs every paged layer but encdec's (the reference's plain
        # attend_local there); K3 serves the rebuild of a paged state
        k1_layers = 0 if cfg.family == "encdec" else n_paged
        expected = {"K1": k1_layers * MEGASTEP * res["megasteps"], "K2": 0,
                    "K3": 1 if n_paged else 0}
        if launches != expected:
            raise AssertionError(f"{run} path launches {launches}, "
                                 f"expected {expected}")
        report = res["stats"]["fallback_report"]["fused_kernel"]
        if report != FUSED_REPORT.get(cfg.family, "ok") or \
                res["stats"].get("aborts"):
            raise AssertionError(f"{run}: {res['stats']}")
        by_family[run] = launches
        out = dict(res["stats"])
        with uncounted(checks):
            if k1_layers:
                out["midrun_logits"] = midrun_logits(
                    cfg, params, res["peak"], res["peak_tokens"],
                    traffic["max_len"], run)
            out["megastep_bitwise_repeatable"] = megastep_bits(
                res["mega"], params, res["peak"], res["peak_tokens"],
                res["peak_stop"])
            if cfg.pattern_local:
                if res["window"] is None or out["max_pos"] <= \
                        cfg.local_window or out["reseated_lanes"] < 1:
                    raise AssertionError(
                        f"{run}: no lane passed the window or none was "
                        f"re-seated ({out['max_pos']}, "
                        f"{out.get('reseated_lanes')})")
                out["forward_past_window"] = window_forward(
                    cfg, params, res["window"], traffic["max_len"])
            if cfg.family in ("ssm", "hybrid"):
                if res["window"] is None or out["reseated_lanes"] < 1:
                    raise AssertionError(f"{run}: no lane passed position "
                                         f"{SSM_FORWARD_POS} or none was "
                                         f"re-seated")
                out["forward_bf16_measured"] = window_forward(
                    cfg, params, res["window"], traffic["max_len"],
                    check=False)
                out["forward_f32"] = f32_replay_forward(
                    cfg, params, res["window"], traffic["max_len"])
            if cfg.family == "ssm":
                out["reseated_alone"] = reseated_alone(cfg, params, res,
                                                       traffic)
            if k1_layers:
                shapes.append(k1_at_state(cfg, res["peak"], run))
        out["phase_seconds"] = time.perf_counter() - t0
        emit("families", run=run, launches=launches, **out)
        del res, params
        torch.cuda.empty_cache()
    return by_family, shapes


def kernel_entries(snap, rebuilt, errs, by_strategy, checks, probe_phase,
                   robinhood_k3):
    import torch
    from repro_torch.core import batched as BT
    from repro_torch.kernels.fused_decode import (block_table_slots_ref,
                                                  fused_decode_kernel,
                                                  fused_decode_plain)
    from repro_torch.kernels.paged_attention import (paged_attention_kernel,
                                                     paged_attention_ref)
    from repro_torch.kernels.paged_attention.paged_attention import \
        split_count
    from repro_torch.kernels.probe import probe_lookup_kernel
    from repro_torch.kernels.probe.probe import LANES, lookup_bytes
    from repro_torch.serving.page_table import page_key
    pk, pv = snap["pools"].k[0], snap["pools"].v[0]
    bt, pos = snap["block_table"], snap["pos"]
    B, MP = bt.shape
    _, PS, KH, D = pk.shape
    G = 6
    g = torch.Generator(device=DEV).manual_seed(SEED + 13)
    q = torch.randn((B, KH * G, D), generator=g, device=DEV).to(pk.dtype)

    part = fused_decode_kernel(q, pk, pv, bt, pos, partials=True)
    ref = fused_decode_plain(q, pk, pv, bt, pos, partials=True)
    errs["K1"] = max([errs["K1"]] + [close(a, b, PARTIALS_TOL)
                                     for a, b in zip(part, ref)])
    slots = block_table_slots_ref(bt, pos, page_size=PS)
    lens = (pos + 1).to(torch.int32)
    errs["K2"] = max(errs["K2"], close(
        paged_attention_kernel(q, pk, pv, slots, lens),
        paged_attention_ref(q, pk, pv, slots, lens), BF16_TOL))

    (k1_bound, k1_by), (k2_bound, k2_by) = attention_bounds(q, pk, bt, pos)
    lib = sdpa_ms(q, pk, pv, bt, pos, PS)
    S = split_count(B, KH, MP, PS, torch.cuda.get_device_properties(
        0).multi_processor_count)
    k1_ms = graph_ms(lambda: fused_decode_kernel(q, pk, pv, bt, pos,
                                                 partials=True), 100)
    k2_ms = graph_ms(lambda: paged_attention_kernel(q, pk, pv, slots, lens),
                     100)
    longc = long_context()
    table = rebuilt["table"]
    logical = torch.arange(MP, device=DEV)
    keys = page_key(rebuilt["seq_ids"][:, None].long(),
                    logical[None, :]).reshape(-1)
    fk, sk = probe_lookup_kernel(table, keys)
    fp, sp = BT.find_batch(table, keys)
    if not (torch.equal(fk, fp) and torch.equal(sk, sp)):
        raise AssertionError("K3 != find_batch at the rebuild shape")
    k3_bound = lookup_bytes(table.table, BT._hash(table, keys), sp,
                            fp) / HBM_BYTES_PER_S * 1e3
    k3_ms = graph_ms(lambda: probe_lookup_kernel(table, keys), 100)
    k3_ops, k3_op_names = device_ops(lambda: probe_lookup_kernel(table, keys))
    launches = by_strategy["linear"]

    def per_strategy(k):
        return {s: n[k] for s, n in by_strategy.items()}
    if keys.dtype != torch.int64 or k3_ops != 1:
        raise AssertionError(f"one K3 call on int64 keys launched {k3_ops} "
                             f"device ops ({k3_op_names}), not 1")
    return [
        {"name": "fused_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/fused_decode/fused.py:52",
         "launches": launches["K1"],
         "launches_by_strategy": per_strategy("K1"),
         "check_launches": checks["K1"],
         "max_abs_err": errs["K1"],
         "ms": k1_ms, "splits": S, "bound_share": k1_bound / k1_ms,
         "long_context": longc["K1"],
         "plain_ms": graph_ms(lambda: fused_decode_plain(
             q, pk, pv, bt, pos, partials=True), 10),
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": lib,
         "eager_ms": cuda_ms(lambda: fused_decode_kernel(
             q, pk, pv, bt, pos, partials=True), 200)},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_attention/paged_attention.py"
                     ":29",
         "launches": launches["K2"],
         "launches_by_strategy": per_strategy("K2"),
         "check_launches": checks["K2"],
         "max_abs_err": errs["K2"],
         "ms": k2_ms, "splits": S, "bound_share": k2_bound / k2_ms,
         "long_context": longc["K2"],
         "plain_ms": graph_ms(lambda: paged_attention_ref(q, pk, pv, slots,
                                                          lens), 10),
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": lib,
         "eager_ms": cuda_ms(lambda: paged_attention_kernel(
             q, pk, pv, slots, lens), 200)},
        {"name": "probe_lookup", "route": "cuda",
         "source": "src/repro_torch/csrc/probe.cu",
         "replaces": "src/repro/kernels/probe/probe.py:53",
         "launches": launches["K3"],
         "launches_by_strategy": per_strategy("K3"),
         "check_launches": checks["K3"],
         "max_abs_err": errs["K3"],
         "ms": k3_ms, "L": LANES, "device_ops": k3_ops,
         "device_op_names": k3_op_names, "m": BT.size(table),
         "lookups": int(keys.shape[0]),
         "cold_ms": cold_ms(lambda: probe_lookup_kernel(table, keys), 50),
         "bound_share": k3_bound / k3_ms, "probe_phase": probe_phase,
         "robinhood_probe_phase": robinhood_k3,
         "plain_ms": cuda_ms(lambda: BT.find_batch(table, keys), 20),
         "bound_ms": k3_bound, "bound_by": "bytes", "library_ms": None,
         "eager_ms": cuda_ms(lambda: probe_lookup_kernel(table, keys), 200)},
    ]


def model_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH), num_layers=LAYERS,
                               fused_kernel=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.models import lm

    t0 = time.time()
    card = nvidia_smi()
    _build.library()
    emit("build", seconds=_build.BUILD_INFO["seconds"],
         library=os.path.relpath(_build.BUILD_INFO["path"], ROOT),
         card=card, torch=torch.__version__, cuda=torch.version.cuda)

    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    phase_attention(errs)
    probe_phase, linear_fill = phase_probe(errs)
    robinhood_k3 = phase_strategies(errs, linear_fill)
    del linear_fill

    cfg = model_config()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = lm.init(cfg, gen, DEV)

    # each path — the main path (linear), then robinhood and hopscotch —
    # counts from just before its serve phase to the end of its rebuild;
    # the launches of the per-round check inside it are counted apart
    wrappers = kernel_wrappers()
    checks = {k: 0 for k in wrappers}
    by_strategy = {}
    for strategy in ("linear", "robinhood", "hopscotch"):
        c = dataclasses.replace(cfg, probe_strategy=strategy)
        for w in wrappers.values():
            w.launches = 0
        res = phase_serve(c, params, checks)
        emit("serve", **res["stats"])
        snap_s, peak_s, tokens_s = res["snap"], res["peak"], res["peak_tokens"]
        megasteps = res["megasteps"]
        del res
        rebuilt_s = phase_rebuild(snap_s, c)
        launches = {k: w.launches for k, w in wrappers.items()}
        # the engine's decode attention is K1; K2 is only what K1 is held
        # to; K3 serves the rebuild of the linear-order strategies
        expected = {"K1": LAYERS * MEGASTEP * megasteps, "K2": 0,
                    "K3": 0 if strategy == "hopscotch" else 1}
        if launches != expected:
            raise AssertionError(f"{strategy} path launches {launches}, "
                                 f"expected {expected}")
        by_strategy[strategy] = launches
        if strategy == "linear":
            peak, peak_tokens, rebuilt = peak_s, tokens_s, rebuilt_s
        del snap_s, peak_s, tokens_s, rebuilt_s
    emit("launches", by_strategy=by_strategy, checks=checks)

    midrun_logits(cfg, params, peak, peak_tokens)
    kernels = kernel_entries(peak, rebuilt, errs, by_strategy, checks,
                             probe_phase, robinhood_k3)
    del peak, peak_tokens, rebuilt
    by_family, k1_shapes = phase_families(cfg, params, checks)
    kernels[0]["launches_by_family"] = {
        run: n["K1"] for run, n in by_family.items()}
    kernels[0]["family_shapes"] = k1_shapes
    errs["K1"] = max([errs["K1"]] + [e["max_abs_err"] for e in k1_shapes])
    kernels[0]["max_abs_err"] = errs["K1"]
    phase_sharded()
    phase_profile(cfg, params)
    emit("done", seconds=time.time() - t0)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
