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
3. probe     — K3 against the plain ``find_batch`` on a 2^20-cell table
               at load 0.9, churned (tombstones, runs that wrap), 2^18
               lookups half present: (found, slot) bit for bit.
4. serve     — the main path: ``ContinuousBatcher`` serving qwen2.5-32b at
               full width with the depth cut from 64 to 8 layers (the 64
               layers' bf16 weights, about 65.5 GB, would leave too little
               of the card for anything else), random bf16 weights from a
               seed, ``fused_kernel=True``, 16 requests.  The same
               workload runs in lockstep with ``fused_kernel=False`` (plain
               ``attend_local``); table and block table must be equal bit
               for bit after every round, and after every round K1 is
               held bit for bit to the K2 composition on the live state.
5. rebuild   — the serve state after its third round, re-hashed into a 2x
               pool with the probe kernel K3 and with the plain lookup:
               table, block table and pools equal bit for bit.
6. logits    — one serve step with K1 and one with the plain attention on
               clones of the serve state with the most live pages: the
               live lanes' logits within ``LOGITS_REL_TOL``.
7. kernels   — each kernel's device time at the main path's shapes (the
               serve state with the most live pages; the rebuild's keys),
               from CUDA-graph replay, beside its plain version's, its
               bound and bound share, a library call's and its eager
               per-call time; for K1 and K2 also the split count and the
               same numbers at the attention phase's long-context case
               (B=64, PS=16, MP=256, bf16, up to 4096 tokens a sequence);
               then a profile of three serve rounds: the device's busy
               share and the kernels that take its time.

Launch counts are zeroed just before phase 4 and read after phase 5: K1
must have launched once per layer per token step, K2 never (the engine's
attention is K1) and K3 once (the rebuild).  The per-round check's
launches are counted apart (``check_launches``).  A wrapper counts one
launch per call, though K1 and K2 each make two CUDA launches (the split
kernel and the merge).  Any failure raises and the script exits
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
# pool size factor vs the worst-case plan: 0.15 gives 96 pages, which this
# workload outgrows, so the scheduler grows the pool (at 0.5, 320 pages,
# it never does)
OVERCOMMIT = 0.15


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def pool_pages() -> int:
    """The serve phase's starting pool: the worst-case plan times
    ``OVERCOMMIT``."""
    maxP = -(-MAX_LEN // PAGE_SIZE)
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
# Phase 3: the probe kernel on a large churned table.

def cells_needed(table, hv, slot, found):
    """Cells each lookup must read: up to its hit, else up to the first
    EMPTY (numpy, on the host)."""
    import numpy as np
    from repro_torch.core import encoding as E
    tab = table.cpu().numpy()
    m = tab.shape[0]
    h = hv.cpu().numpy().astype(np.int64)
    empties = np.nonzero(tab == E.EMPTY)[0]
    if empties.size:
        i = np.searchsorted(empties, h) % empties.size
        to_empty = (empties[i] - h) % m + 1
    else:
        to_empty = np.full(h.shape, m)
    to_hit = (slot.cpu().numpy().astype(np.int64) - h) % m + 1
    return np.where(found.cpu().numpy(), to_hit, to_empty)


def phase_probe(errs):
    import numpy as np
    import torch
    from repro_torch.core import batched as BT
    from repro_torch.core import encoding as E
    from repro_torch.kernels.probe import probe_lookup_kernel
    m, load, chunk = 1 << 20, 0.9, 4096
    rng = np.random.default_rng(SEED + 3)
    universe = torch.from_numpy(
        rng.choice(1 << 27, size=int(1.2 * m), replace=False)).to(DEV)
    ht = BT.create(m, seed=SEED + 7, device=DEV)
    # keys homed in the last 256 cells go in first: their run wraps past 0
    tail = BT._hash(ht, universe) >= m - 256
    universe = torch.cat([universe[tail], universe[~tail]])
    n_live = int(load * m)
    first = universe[:n_live]
    refill = universe[n_live:n_live + m // 10]
    absent = universe[n_live + m // 10:]
    gone = first[torch.from_numpy(rng.permutation(n_live)[:m // 10]).to(DEV)]
    t0 = time.perf_counter()
    for keys, op in ((first, BT.insert_batch), (gone, BT.delete_batch),
                     (refill, BT.insert_batch)):
        for i in range(0, keys.shape[0], chunk):
            ht, ret = op(ht, keys[i:i + chunk])
            if op is BT.insert_batch and bool((ret == 2).any()):
                raise AssertionError("insert ABORTed while filling")
    fill_s = time.perf_counter() - t0
    tab = ht.table
    wraps = bool(tab[0] != E.EMPTY) and bool(tab[-1] != E.EMPTY)
    if not wraps or int(ht.num_tombs) == 0:
        raise AssertionError("the churned table has no wrapping run or no "
                             "tombstone")
    n = 1 << 18
    present = first[torch.isin(first, gone, invert=True)]
    present = present[torch.from_numpy(
        rng.permutation(present.shape[0])[:n // 2]).to(DEV)]
    queries = torch.cat([present, absent[:n // 2 - 1024], gone[:1024]])
    fk, sk = probe_lookup_kernel(ht, queries)
    fp, sp = BT.find_batch(ht, queries)
    torch.cuda.synchronize()
    if not (torch.equal(fk, fp) and torch.equal(sk, sp)):
        raise AssertionError("probe kernel != find_batch")
    errs["K3"] = max(errs["K3"], float((sk - sp).abs().max()))
    cells = cells_needed(tab, BT._hash(ht, queries), sp, fp)
    ms = graph_ms(lambda: probe_lookup_kernel(ht, queries), 10)
    plain = cuda_ms(lambda: BT.find_batch(ht, queries), 2)
    bound = (4 * cells.sum() + 12 * n) / HBM_BYTES_PER_S * 1e3
    emit("probe", m=m, live=int(ht.num_keys), tombstones=int(ht.num_tombs),
         wrap_run=wraps, lookups=n, found=int(fp.sum()),
         equal=True, fill_s=fill_s, cells_mean=float(cells.mean()),
         cells_max=int(cells.max()), ms=ms, plain_ms=plain, bound_ms=bound)


# ---------------------------------------------------------------------------
# Phases 4 and 5: the main path.

def make_batcher(cfg, params, n_pages):
    from repro_torch.launch.serve import ContinuousBatcher
    from repro_torch.serving.sched import Scheduler, synthetic_workload
    sched = Scheduler(slots=BATCH, page_size=PAGE_SIZE, max_len=MAX_LEN,
                      megastep_k=MEGASTEP)
    srv = ContinuousBatcher(cfg, params, batch=BATCH, max_len=MAX_LEN,
                            page_size=PAGE_SIZE, megastep_k=MEGASTEP,
                            verify_block_table=True, scheduler=sched,
                            n_pages=n_pages, auto_refill=False,
                            seed=SEED, device=DEV)
    sched.submit_many(synthetic_workload(
        N_REQUESTS, vocab_size=cfg.vocab_size, max_len=MAX_LEN, seed=SEED,
        prompt_len=(64, 256), max_new=(64, 256)))
    return srv


def midrun_logits(cfg, params, state, tokens):
    """One fused (K1) and one plain (``attend_local``) serve step on clones
    of the same mid-run state: the model path end to end, over the live
    lanes, held to ``LOGITS_REL_TOL``."""
    import torch
    from repro_torch.serving import engine as EG
    out = []
    for fused in (True, False):
        c = dataclasses.replace(cfg, fused_kernel=fused)
        step = EG.make_serve_step(c, S_max=MAX_LEN, page_size=PAGE_SIZE)
        st = EG.clone_state(state)
        logits, _ = step(params, st, tokens, st["pos"])
        out.append(logits)
    live = state["active"] & ~state["aborted"]
    a, b = out[0][live].float(), out[1][live].float()
    diff = (a - b).abs()
    rel = float((a - b).norm() / b.norm())
    top2 = b.topk(2, dim=-1).values
    argmax_eq = a.argmax(-1) == b.argmax(-1)
    emit("midrun_logits", lanes=int(live.sum()),
         positions=state["pos"][live].tolist(), rel_err=rel,
         tolerance=LOGITS_REL_TOL, max_abs_diff=float(diff.max()),
         max_abs_logit=float(b.abs().max()),
         argmax_agree=int(argmax_eq.sum()),
         plain_top2_gap=(top2[:, 0] - top2[:, 1]).tolist())
    if not rel <= LOGITS_REL_TOL:
        raise AssertionError(f"fused and plain serve steps' logits differ: "
                             f"relative error {rel} > {LOGITS_REL_TOL}")


def live_two_dispatch_check(state, gen):
    """K1 == (slots view, then K2) bit for bit on the live serve state's
    first layer, with a random query."""
    import torch
    from repro_torch.kernels.fused_decode import (fused_decode_kernel,
                                                  fused_decode_ref)
    pk, pv = state["pools"].k[0], state["pools"].v[0]
    KH, D = pk.shape[2], pk.shape[3]
    q = torch.randn((BATCH, KH * 6, D), generator=gen,
                    device=DEV).to(pk.dtype)
    bt, pos = state["block_table"], state["pos"]
    if not torch.equal(fused_decode_kernel(q, pk, pv, bt, pos),
                       fused_decode_ref(q, pk, pv, bt, pos)):
        raise AssertionError("live state: K1 != K2 composition")


def tables_equal(a, b) -> bool:
    import torch
    return (torch.equal(a["table"].table, b["table"].table)
            and int(a["table"].num_keys) == int(b["table"].num_keys)
            and int(a["table"].num_tombs) == int(b["table"].num_tombs)
            and torch.equal(a["block_table"], b["block_table"]))


def phase_serve(cfg, params, checks):
    """Returns the state after round 3, the state (and next tokens) with
    the most live pages, and the number of megasteps dispatched."""
    import numpy as np
    import torch
    from repro_torch.device import SYNC_STATS
    from repro_torch.kernels.fused_decode import fused_decode_kernel
    from repro_torch.serving import engine as EG
    n_pages = pool_pages()
    fused = make_batcher(cfg, params, n_pages)
    plain = make_batcher(dataclasses.replace(cfg, fused_kernel=False),
                         params, n_pages)
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
    peak_tokens = None
    torch.cuda.reset_peak_memory_stats()
    while not (fused.sched.drained and plain.sched.drained):
        if rounds >= 400:
            raise AssertionError("serve did not drain in 400 rounds")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused.step_round()
        torch.cuda.synchronize()
        fused_s += time.perf_counter() - t0
        syncs = SYNC_STATS["host_syncs"]
        plain.step_round()
        SYNC_STATS["host_syncs"] = syncs      # count the fused run only
        rounds += 1
        if not tables_equal(fused.state, plain.state):
            raise AssertionError(f"round {rounds}: fused and plain page "
                                 f"tables differ")
        with uncounted(checks):
            live_two_dispatch_check(fused.state, gen)
        live = int(fused.state["table"].num_keys)
        if live > peak_live and bool(fused.state["active"].any()):
            peak, peak_live = EG.clone_state(fused.state), live
            peak_tokens = fused.tokens.clone()
        if rounds == 3:
            if not bool(fused.state["active"].any()):
                raise AssertionError("no live lane after round 3")
            snap = EG.clone_state(fused.state)
    n_tok = int(tokens)
    st = fused.sched.summary()
    if st["aborts"] or plain.sched.summary()["aborts"]:
        raise AssertionError(f"aborts: {st['aborts']}")
    if fused_decode_kernel.launches != LAYERS * MEGASTEP * megasteps:
        raise AssertionError(
            f"K1 launched {fused_decode_kernel.launches} times on the serve "
            f"path, not once per layer per token step "
            f"({LAYERS} x {MEGASTEP} x {megasteps} megasteps)")
    same = total = 0
    pl = {r.req_id: r for r in plain.sched.finished}
    for r in fused.sched.finished:
        a, b = np.asarray(r.sampled), np.asarray(pl[r.req_id].sampled)
        total += a.size
        same += int((a == b).sum())
    emit("serve", arch=ARCH, layers=LAYERS, d_model=cfg.d_model,
         n_q=cfg.n_q, n_kv=cfg.n_kv, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         batch=BATCH, max_len=MAX_LEN, page_size=PAGE_SIZE,
         megastep=MEGASTEP, n_pages_start=n_pages,
         n_pages_end=int(fused.state["pools"].k.shape[1]), rounds=rounds,
         completed=st["completed"], aborts=st["aborts"],
         pool_grows=st["pool_grows"], megasteps=megasteps,
         token_steps=n_tok,
         generated=sum(len(r.sampled) for r in fused.sched.finished),
         seconds=fused_s, tokens_per_s=n_tok / fused_s,
         host_syncs_per_token=(SYNC_STATS["host_syncs"] - syncs0) / n_tok,
         k1_launches=fused_decode_kernel.launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         tables_equal_every_round=True,
         token_agreement=same / max(total, 1))
    return snap, peak, peak_tokens, megasteps


def phase_rebuild(snap):
    import torch
    from repro_torch.kernels.probe import probe_lookup_kernel
    from repro_torch.serving import engine as EG
    from repro_torch.serving.engine import clone_state
    m = snap["pools"].k.shape[1]
    before = probe_lookup_kernel.launches
    a = EG.rebuild_page_table(clone_state(snap), n_pages=2 * m,
                              use_kernel=True)
    b = EG.rebuild_page_table(clone_state(snap), n_pages=2 * m,
                              use_kernel=False)
    eq = (tables_equal(a, b) and torch.equal(a["pools"].k, b["pools"].k)
          and torch.equal(a["pools"].v, b["pools"].v))
    if not eq:
        raise AssertionError("rebuild with K3 != rebuild with find_batch")
    if probe_lookup_kernel.launches == before:
        raise AssertionError("K3 never launched by the rebuild")
    emit("rebuild", n_pages_from=m, n_pages_to=2 * m,
         live_pages=int(a["table"].num_keys), equal=True,
         k3_launches=probe_lookup_kernel.launches - before)
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
# Phase 6: the kernels at the main path's shapes.

def sdpa_ms(q, pk, pv, bt, pos, PS):
    """One ``scaled_dot_product_attention`` call over the same KV gathered
    contiguously per sequence (the gather is not timed)."""
    import torch
    import torch.nn.functional as F
    B, QH, D = q.shape
    KH = pk.shape[2]
    S = int(pos.max()) + 1
    MPs = -(-S // PS)
    rows = bt[:, :MPs].clamp_min(0).long()
    k = pk[rows].reshape(B, MPs * PS, KH, D)[:, :S]
    v = pv[rows].reshape(B, MPs * PS, KH, D)[:, :S]
    k = k.permute(0, 2, 1, 3).repeat_interleave(QH // KH, dim=1)
    v = v.permute(0, 2, 1, 3).repeat_interleave(QH // KH, dim=1)
    mask = (torch.arange(S, device=q.device)[None, :]
            <= pos[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    return graph_ms(lambda: F.scaled_dot_product_attention(
        q4, k, v, attn_mask=mask), 100)


def attention_bounds(q, pk, bt, pos):
    """K1's and K2's least times in ms, each with what bounds it: the
    valid tokens' K and V read once, the table rows, q, the outputs
    (K1's f32 partials; K2's output in q's dtype); operations: q.k and
    p.v per valid token and query head, in f32."""
    import torch
    B, MP = bt.shape
    _, PS, KH, D = pk.shape
    G = q.shape[1] // KH
    live = (torch.arange(MP, device=DEV)[None, :] * PS
            <= pos[:, None]) & (bt >= 0)
    ntok = int((torch.clamp(pos[:, None] + 1 - torch.arange(
        MP, device=DEV)[None, :] * PS, 0, PS) * live).sum())
    kv_bytes = ntok * KH * D * 2 * pk.element_size()
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


def kernel_entries(snap, rebuilt, errs, launches, checks):
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
    cells = cells_needed(table.table, BT._hash(table, keys), sp, fp)
    k3_bytes = 4 * float(cells.sum()) + 12 * keys.shape[0]
    return [
        {"name": "fused_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/fused_decode/fused.py:52",
         "launches": launches["K1"], "check_launches": checks["K1"],
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
         "launches": launches["K2"], "check_launches": checks["K2"],
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
         "launches": launches["K3"], "check_launches": checks["K3"],
         "max_abs_err": errs["K3"],
         "ms": graph_ms(lambda: probe_lookup_kernel(table, keys), 100),
         "plain_ms": cuda_ms(lambda: BT.find_batch(table, keys), 20),
         "bound_ms": k3_bytes / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": None,
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
    phase_probe(errs)

    cfg = model_config()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = lm.init(cfg, gen, DEV)

    # the main path: counts from here to the end of the rebuild; the
    # launches of the per-round check inside it are counted apart
    wrappers = kernel_wrappers()
    checks = {k: 0 for k in wrappers}
    for w in wrappers.values():
        w.launches = 0
    snap, peak, peak_tokens, megasteps = phase_serve(cfg, params, checks)
    rebuilt = phase_rebuild(snap)
    launches = {k: w.launches for k, w in wrappers.items()}
    # the engine's decode attention is K1; K2 is only what K1 is held to
    expected = {"K1": LAYERS * MEGASTEP * megasteps, "K2": 0, "K3": 1}
    if launches != expected:
        raise AssertionError(f"main-path launches {launches}, expected "
                             f"{expected}")

    midrun_logits(cfg, params, peak, peak_tokens)
    kernels = kernel_entries(peak, rebuilt, errs, launches, checks)
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
