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
               needs m * B < 2^31), a tenth deleted and refilled, and two
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
               the mamba state kernel at one granite-4.0-h-small mamba
               layer at 256 lanes (1.07 GB of float32 ``h``), first held
               to its plain version with every other lane frozen (``h``
               bit for bit, ``y`` within 1e-6 of its sum's scale), then
               timed beside its byte bound, its plain version and a copy
               of ``h``'s size (and, after phase ``families``, the same
               check and times at zamba2's and mamba2's peak states);
9. families  — phase ``serve``'s machinery (the fused run in lockstep with
               the plain one, tables equal and K1 == the K2 composition
               every round, the rebuild with K3) for the other model
               families, random bf16 weights from the seed:
               ``moe``    granite-moe-1b-a400m at full width (32 experts
                          top-8), depth cut 24 -> 8 for time, the serve
                          traffic;
                          one megastep run twice from clones of one state
                          must give the same bits (the MoE combine has no
                          atomic add);
               ``gemma3`` gemma3-12b at full width and the published 1024
                          window, depth cut 48 -> 6 (one 5:1 superblock:
                          5 ring layers, 1 paged), 12 requests of 900-1100
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
                          state reset; the mamba state kernel once a
                          mamba layer and token step; one lane's tokens
                          near position 200 replayed through the engine
                          in float32 (the kernel on float32 activations) and
                          held to the float32 ``hybrid.forward`` (the
                          bf16 state's distance printed beside it);
               ``mamba2`` mamba2-2.7b at full width (d 2560, d_inner 5120,
                          80 heads of 64, N 128), depth cut 64 -> 16 for
                          time; no page table, so no plain twin and no
                          attention kernel; the mamba state kernel once
                          a layer and token step; the serve traffic, the
                          float32 replay against ``ssm_lm.forward``, and the first
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
11. simulator — the paper's Algorithms 1-6 (``core/simulator``) in the
               LL/SC and the CAS mode: ``tests/test_simulator.py``'s four
               concurrent schedule kinds (uniform, bursty, stalled,
               round-robin; P 3, K 5, m 16, 4000 events, invariants after
               every write) and its same-key stress (P 3, K 4, m 8), each
               run on the card and on the CPU with every ``SimState``
               field equal bit for bit, LL/SC pairing and the invariants
               holding and the history linearizable (``check_history``);
               then the Theorem-21 load shape (m 256, P 8, random distinct
               keys to load 0.75, x = 4, 400 P K uniform events) on the
               card: every op completes, pairing holds, the final table
               passes ``check_invariants``; events per second, host syncs
               per event, each active event's cost on the card and on the
               CPU, mean steps per op beside Knuth's 0.5 (1 + x^2).
12. train    — ``TrainRunner`` (``launch/train.py``) on qwen2.5-32b at full
               width (d_model 5120, 40 q-heads padded to 48, 8 KV heads of
               128, d_ff 27648, vocab 152064, untied head), depth cut 64 ->
               2, random bf16 weights from the seed, batch 4 x 512 tokens,
               remat and n-gram dedup on, 6 AdamW steps: every loss and
               grad norm finite, the lr on ``optimizer.schedule``; seconds
               per step, tokens per second, peak memory and the model-FLOPs
               share (``train_flops``) over the 989 TFLOP/s bf16 peak.  A
               batch fed twice to a ``DedupState`` on the card is kept,
               then masked.  The smoke config in float32: 2 steps on the
               card from the CPU's initial state, loss and every parameter
               within ``TRAIN_F32_TOL`` of the CPU's run; restart
               determinism through ``TrainRunner``'s checkpoint (save at
               step 3, restore on start, continue to 6: the losses of the
               uninterrupted run).
13. collectives — the mesh's collectives on the card: 4 ranks spawned
               on card 0 (``launch/mesh.run_spmd``) as a (data 2, model 2)
               mesh, each op of ``dist/collectives`` (psum in bf16 and
               f32, pmax, all_gather tiled and stacked, all_to_all,
               reduce_scatter, ppermute, gather_to_root) at 4 KiB, 1 MiB
               and 96 MiB a rank (past one 64-MiB slot of the peer
               buffers) under the peer transport (``dist/peer``: each
               rank's workspace on the card, opened by the others through
               CUDA IPC) and under gloo named explicitly (staged through
               the host): every result equal bit for bit, the same bytes
               counted, none staged but gloo's; 50 collectives in a row of
               alternating sizes and groups, equal; the ms a call for each
               transport, op and size.  With a card a rank (4 or more
               cards) the same one rank a card under NCCL; with fewer it
               prints that NCCL was not run.
14. mesh     — serving on a device mesh: 4 ranks spawned by
               ``launch/mesh.run_spmd``, placed by ``card_of`` (all on
               card 0 on a one-card host: the peer transport; one a card
               on a host with four: NCCL), as a (data 2, model 2) mesh,
               each holding only its pieces of the weights, pools and
               state; no collective of any rank staged through the host
               (``COLLECTIVE_STATS["staged"]`` 0), the placement and the
               transport printed.
               qwen2.5-32b at full width, depth 64 -> 4, seeded bf16
               weights cut by ``engine.mesh_param_specs``, served by
               ``ContinuousBatcher(rules=)`` under ``serve_rules`` (gspmd:
               heads all-gathered, pages over every axis) and
               ``serve_manual_rules`` (manual TP: pages over data, KV
               heads over model), 16 requests of 32-128 prompt and 32-128
               new tokens at max_len 512, batch 8, page size 16, K 8, 320
               pages: 0 aborts, the page table and block table equal to a
               one-device run's (same weights, same pool) every round,
               every rank's tokens and launches equal to rank 0's, K1
               launched per rank once per layer per token step; the
               one-device run's state after round 6 cut into each rank's
               pieces (``engine.shard_state``) and re-hashed into a 2x
               pool on the mesh (``rebuild_page_table``: pages moved
               between the ranks' pools, K3 once on every rank), each
               rank's piece equal bit for bit to its cut of the
               one-device re-hash; on that state, one mesh step's logits
               within ``LOGITS_REL_TOL`` of the one-device step's, and a
               K-token megastep equal to K single steps bit for bit.
               Then, manual rules only: granite-moe (2 layers, experts
               over model), zamba2 (one group of 6 mamba layers and the
               shared block, mamba head-sharded) and gemma3 (one 5:1
               superblock), each fed 40 seeded tokens: logits against
               the one-device run, the megastep against single steps;
               zamba2's mamba state kernel launched per rank once per
               mamba layer per step, and held to its plain version at
               the rank's head-sharded state (``h`` bit for bit).
               Then seamless under serve_rules at full width, depth 24 +
               24 cut to 4 + 4: the encoder's prefill over the ranks'
               weight shards (``prepare_encdec_state(rules=)``) and 40
               seeded tokens, the tables equal to the one-device run's
               every step and the logits at steps 9, 19, 29 and 39
               within ``LOGITS_REL_TOL`` of its.
               Then the DHT (``core/sharded``) over the 4 ranks: 2^20
               cells filled to live load 0.9 and two churn rounds, the
               same ops on a card table and a CPU table over the same
               ranks: equal answers and shard words, every answer the
               rank's Python set model's.  K1 at rank 0's two mesh shapes
               (its layer-0 pools and rank-local block table at the
               serve's peak state, the most live pages) against its
               plain version, timed beside its bound and SDPA.
15. mesh_train — training on a device mesh, ranks placed as in phase 14
               and nothing staged through the host.  codeqwen1.5-7b at
               full width (d_model 4096, 32 MHA heads of 128, d_ff 13440,
               vocab 92416), depth
               32 -> 1 (0.99 B parameters), seeded bf16 weights, global
               batch 8 x 256, 3 steps.  (a) The manual-pod compressed
               step (``make_train_step_manual_pod``) on (pod 2, data 2,
               model 1), or on (pod 2, data 1, model 1) with 2 ranks when
               four replicated ranks' estimated peaks would pass
               ``MT_MEM_CAP_GIB``: step 0's loss within ``MT_LOSS_TOL`` of
               the one-device loss, every rank's params the same bits
               after every step (a digest per rank), the compressed wire
               bytes equal to ``compressed_bytes``.  (b) The rules step
               (``train_rules``) on (data 2, model 2): step 0's loss
               against one device, each rank's peak and collective bytes
               per step; its f32 twin at smoke size, card against CPU
               within ``TRAIN_F32_TOL``.  (c) (b)'s state saved from the
               mesh and restored onto (data 4, model 1): every rank's
               leaves equal to their cut of the saved arrays bit for bit,
               one more step finite.  (d) GPipe on (pod 4), one
               full-width block a stage, M 4, x [8, 256, 4096] bf16:
               within ``LOGITS_REL_TOL`` of the one-device sequential
               forward; its f32 smoke twin within ``PIPE_F32_TOL``;
               bubble 3/7.  None of it reaches a TPU kernel.

Launch counts are zeroed just before each serve run and read after its
rebuild: K1 must have launched once per paged layer per token step, K2
never (the engine's attention is K1) and K3 once (the rebuild) for linear
and robinhood, never for hopscotch; the mamba state kernel once per mamba
layer per token step (none on the main path, whose model has no mamba
layer); the linear run is the main path of the
kernels line, ``launches_by_strategy`` holds all three and
``launches_by_family`` the families' (mamba2 launches no attention kernel,
seamless only K3's rebuild; the mamba state kernel runs in zamba2's and
mamba2's, and the plain twin's launches are the checks'),
``launches_by_mesh`` each kernel's per rank on each mesh
layout's serve and rebuild (counted in each rank from just before the
serve to the end of the rebuild), ``launches_by_phase``
the simulator's, the train phase's and mesh_train's (none: no such path
has a TPU kernel in the reference).  The
per-round check's launches are counted apart (``check_launches``).  A wrapper counts one launch per call, though K1 and
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
# time limit: granite-moe 24 -> 8, gemma3 48 -> 6 (one 5:1 superblock: 5
# ring layers, 1 paged), zamba2 38 -> 14 (two groups of 6 mamba layers,
# each followed by the shared block, and the 2-layer tail), mamba2 64 -> 16
FAMILIES = [
    ("moe", "granite-moe-1b-a400m", 8, {}, SERVE_TRAFFIC),
    ("gemma3", "gemma3-12b", 6, {},
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
# table; two rounds, cut from four for the script's 1200 s since phase
# mesh_train joined), and the card-vs-CPU replay at m = 2^14
STRAT_M = 1 << 20
CHURN_ROUNDS, CHURN_KEYS = 2, (1 << 20) // 64
REPLAY_M, REPLAY_BATCH, REPLAY_BATCHES = 1 << 14, 1024, 16

# the sharded phase: the reference's shard-soak settings (4 host groups,
# 48 requests at 2x overcommit, a forced lazy grow at round 3, a host
# group lost at round 6)
SOAK = dict(hosts=4, requests=48, overcommit=2.0, grow_round=3,
            lose_round=6)

# the simulator phase: ``tests/test_simulator.py``'s concurrent cases (P
# 3, K 5, m 16, 4000 events, invariants checked after every write) and its
# same-key stress (P 3, K 4, m 8, 6000 events), held card against CPU; then
# the reference's Theorem-21 load shape (``benchmarks/bench_steps.py``
# ``sweep_load``: m 256, P 8, distinct random keys to load 1 - 1/x, x = 4,
# 400 P K events of a uniform schedule)
SIM_CONCURRENT = dict(P=3, K=5, m=16, T=4000)
SIM_SAME_KEY = dict(P=3, K=4, m=8, T=6000)
SIM_LOAD = dict(m=256, P=8, x=4.0)

# the train phase: qwen2.5-32b at full width through ``TrainRunner``
# (remat, dedup), depth cut 64 -> 2: each layer is about 498 M parameters
# and the embedding and untied head 1.557 B; at 2 layers the bf16 params and
# grads and the f32 moments take about 31 GB, at 4 about 43 GB before the
# optimizer's f32 temporaries.  Then the smoke config in float32 on the
# card against the same run on the CPU (``TRAIN_F32_TOL``, relative, per
# leaf and per loss), and restart determinism at
# ``tests/test_training.py::test_restart_determinism``'s shape (losses
# within ``TRAIN_RESTART_TOL``)
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4, 512, 6
TRAIN_F32_TOL = 1e-4
TRAIN_RESTART_TOL = 1e-6
H100_BF16_FLOPS = 989e12       # H100 SXM dense bf16 peak

# the mesh phase: 4 ranks as a (data 2, model 2) mesh, sharing the one card
# (the peer transport) or one a card (NCCL).  qwen2.5-32b at full
# width, depth 64 -> 4, served under serve_rules and serve_manual_rules
# at the serve phase's batch, page size and K over a shorter traffic (the
# collectives make a mesh step several times the one-device step's);
# the pool (a multiple of the 4 ranks) never grows; the state after round
# MESH_MID_ROUND is the one the mid-run logits and the megastep check
# start from.  Then, manual rules only and at small depth, granite-moe (2
# layers: experts over model), zamba2 (one group of 6 mamba layers and
# the shared block: mamba head-sharded) and gemma3 (one 5:1 superblock),
# each fed MESH_FAMILY_STEPS seeded tokens; and the DHT over the 4 ranks
# (2^20 cells to live load 0.9, two churn rounds, card against CPU)
MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")
MESH_LAYERS = 4
MESH_TRAFFIC = dict(max_len=512, requests=N_REQUESTS, prompt_len=(32, 128),
                    max_new=(32, 128))
MESH_PAGES = 320
MESH_MID_ROUND = 6
MESH_FAMILIES = [("moe", "granite-moe-1b-a400m", 2),
                 ("zamba2", "zamba2-1.2b", 6), ("gemma3", "gemma3-12b", 6)]
MESH_FAMILY_STEPS = 40
MESH_DHT = dict(m_global=1 << 20, load=0.9, batch=4096, slack=128,
                churn_rounds=2)
# a rank waiting longer than this in a collective fails the phase
MESH_TIMEOUT_S = 180
# seamless on the mesh (phase mesh, serve_rules): full width, depth 24 + 24
# cut to 4 + 4, fed MESH_FAMILY_STEPS seeded tokens after the encoder's
# prefill of seeded frames; the logits of these steps are held to the
# one-device run's (the tables at every step)
MESH_ENCDEC = ("seamless-m4t-large-v2", 4)
MESH_ENCDEC_CHECKS = (9, 19, 29, 39)

# the collectives check: 4 ranks on the card as a (data 2, model 2) mesh,
# every op of ``dist/collectives`` at payloads of COLL_SIZES bytes a rank
# (the last one past a peer slot, ``dist/peer.SLOT_BYTES``) under the
# transport the placement gives and under gloo named explicitly (staged
# through the host), each result equal bit for bit across the two; then
# COLL_BACK_TO_BACK collectives in a row of alternating sizes and groups.
# Each op is timed over COLL_REPS back-to-back calls a size.  With a card
# a rank (4 or more cards), the same again one rank a card on NCCL
COLL_SIZES = (4 << 10, 1 << 20, 96 << 20)
COLL_REPS = (20, 10, 2)
COLL_BACK_TO_BACK = 50
COLL_TIMEOUT_S = 300

# phase mesh_train: ranks placed as in phase mesh.
# codeqwen1.5-7b at full published width (d 4096, 32 MHA heads of 128, d_ff
# 13440, vocab 92416), depth 32 -> 1 (0.99 B parameters), random bf16
# weights from the seed, global batch 8 x 256, MT_STEPS steps: (a) the
# manual-pod compressed step on (pod 2, data 2, model 1), or on (pod 2,
# data 1, model 1) with 2 ranks when four replicated ranks' estimated peaks
# (16 B a parameter: bf16 params and grads, f32 moments and error buffer,
# plus f32 temporaries of the largest leaf) pass MT_MEM_CAP_GIB or the
# card's free memory; (b) the rules step (train_rules) on (data 2, model
# 2), with its f32 twin at smoke size card against CPU; (c) (b)'s state
# saved from (data 2, model 2) and restored onto (data 4, model 1);
# (d) GPipe on (pod 4), one full-width block a stage, M microbatches.
# Step 0's loss is held to the one-device loss (the reference test's rtol)
MT_ARCH, MT_LAYERS = "codeqwen1.5-7b", 1
MT_BATCH, MT_SEQ, MT_STEPS = 8, 256, 3
MT_LOSS_TOL = 2e-3
MT_MEM_CAP_GIB = 74
MT_RULES_SHAPE, MT_ELASTIC_SHAPE = (2, 2), (4, 1)
MT_PIPE_LAYERS, MT_PIPE_M = 4, 4
PIPE_F32_TOL = 1e-5            # tests/test_mesh.py's pipeline atol = rtol
MT_TIMEOUT_S = 300


T0 = time.time()


def no_staged(where: str) -> None:
    """Fail unless no collective of this rank was staged through the host
    since the last ``reset_stats``."""
    from repro_torch.dist import collectives as C
    if C.COLLECTIVE_STATS["staged"]:
        raise AssertionError(f"{where}: {C.COLLECTIVE_STATS['staged']} "
                             f"collectives staged through the host")


def mesh_where(mesh) -> dict:
    """The placement and the transport of this rank's mesh."""
    import torch
    from repro_torch.launch.mesh import placement
    return dict(placement=placement(mesh.size, torch.cuda.device_count()),
                transport=mesh.transport, card=mesh.device.index)


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
    from repro_torch.kernels.mamba_state import mamba_state_kernel
    return {"K1": fused_decode_kernel, "K2": paged_attention_kernel,
            "K3": probe_lookup_kernel, "MS": mamba_state_kernel}


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
            with uncounted(checks):               # the mamba state kernel's
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

def sdpa_ms(q, pk, pv, bt, pos, PS, scales=None, holes=False):
    """One ``scaled_dot_product_attention`` call over the same KV gathered
    contiguously per sequence (int8 pools dequantized to q's dtype; the
    gather is not timed); with ``holes`` the mask also drops the pages of
    -1 block-table entries (a mesh rank's other ranks' pages)."""
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
    mask = torch.arange(S, device=q.device)[None, :] <= pos[:, None]
    if holes:
        mask = mask & (bt[:, :MPs] >= 0).repeat_interleave(PS, 1)[:, :S]
    mask = mask[:, None, None, :]
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


def mamba_state_inputs(h, dtype, seed, keep):
    """The mamba state kernel's arguments around the state ``h``
    [B, G, Hg, P, N]: ``dtp``, ``x``, ``B``, ``C`` and ``D`` drawn from
    ``seed``, ``dA`` as the model makes it, activations in ``dtype``."""
    import torch
    import torch.nn.functional as F
    B, G, Hg, P, N = h.shape
    g = torch.Generator(device=DEV).manual_seed(seed)
    dtp = F.softplus(torch.randn((B, G, Hg), generator=g, device=DEV))
    A = -torch.linspace(1.0, 16.0, G * Hg, device=DEV).reshape(G, Hg)
    dA = torch.exp(dtp * A[None])
    xs = torch.randn((B, G * Hg * P), generator=g, device=DEV).to(dtype)
    bc = torch.randn((B, 2 * G * N), generator=g, device=DEV).to(dtype)
    D = torch.rand(G * Hg, generator=g, device=DEV) + 0.5
    return h, dA, dtp, xs, bc, D, keep


def check_mamba_state(args) -> float:
    """The kernel on clones of ``args`` against ``mamba_state_plain`` on
    other clones: ``h`` bit for bit and the frozen lanes' rows untouched;
    ``y`` within 1e-6 of ``sum |C h'| + |x D|`` (a frozen lane's: of its
    rebuilt terms), and through bf16 within one bf16 step more: only the
    order of the ``C.h`` sum differs.  Returns max |y - plain| / scale."""
    import torch
    from repro_torch.kernels.mamba_state import (mamba_state_kernel,
                                                 mamba_state_plain)
    a = [t.clone() for t in args]
    b = [t.clone() for t in args]
    yk = mamba_state_kernel(*a)
    yp = mamba_state_plain(*b)
    frozen = ~args[6]
    bits = lambda t: t.view(torch.int32)
    if not torch.equal(bits(a[0]), bits(b[0])) or not torch.equal(
            bits(a[0][frozen]), bits(args[0][frozen])):
        raise AssertionError(f"mamba state kernel: h differs from the "
                             f"plain version's at {tuple(a[0].shape)}")
    h, dA, dtp, xs, bc, D, keep = b
    B, G, Hg, P, N = h.shape
    Bm = bc[:, :G * N].float().abs().reshape(B, G, 1, 1, N)
    Cm = bc[:, G * N:].float().abs().reshape(B, G, 1, 1, N)
    x = xs.float().reshape(B, G, Hg, P)
    ch = (Cm * h.abs()).sum(-1)
    rebuilt = dA[..., None] * ch + (Cm * Bm).sum(-1) \
        * (x * dtp[..., None]).abs()
    scale = (torch.where(keep[:, None, None, None], ch, rebuilt)
             + (x * D.reshape(G, Hg, 1)).abs()).reshape(B, -1)
    err = (yk - yp).abs()
    bound = 1e-6 * scale
    if xs.dtype == torch.bfloat16:
        bound = bound + yp.abs() * 2.0 ** -7
    rel = float((err / scale.clamp_min(1e-30)).max())
    if not bool((err <= bound).all()):
        raise AssertionError(f"mamba state kernel: y off the plain "
                             f"version's by {rel} of the sum's scale at "
                             f"{tuple(h.shape)}, {xs.dtype}")
    return rel


def mamba_state_at(state, run, dtype) -> dict:
    """The mamba state kernel at a family run's peak state: the first
    mamba layer's ``h`` with the lanes the state has live kept and every
    other lane frozen, held to its plain version in float32 and in the
    run's activation dtype (``check_mamba_state``; the float32 error
    reported), and timed beside its byte bound and the plain version,
    warm and with L2 cold: at 8 lanes ``h`` (8-21 MB) fits the 50 MB L2,
    so warm replays can beat the device-memory bound."""
    import torch
    from repro_torch.kernels.mamba_state import (mamba_state_kernel,
                                                 mamba_state_plain,
                                                 state_bytes)
    h = state["ssm"].h[0]
    keep = state["active"].clone()
    keep[1::2] = False
    err = check_mamba_state(mamba_state_inputs(h, torch.float32,
                                               SEED + 17, keep))
    check_mamba_state(mamba_state_inputs(h, dtype, SEED + 17, keep))
    work = [t.clone() for t in mamba_state_inputs(h, dtype, SEED + 17,
                                                  keep)]
    ms = graph_ms(lambda: mamba_state_kernel(*work), 20)
    cold = cold_ms(lambda: mamba_state_kernel(*work), 20)
    bound = state_bytes(h) / HBM_BYTES_PER_S * 1e3
    B, G, Hg, P, N = h.shape
    return {"run": run, "B": B, "G": G, "Hg": Hg, "P": P, "N": N,
            "dtype": str(dtype), "kept": int(keep.sum()), "ms": ms,
            "plain_ms": graph_ms(lambda: mamba_state_plain(*work), 5),
            "bound_ms": bound, "bound_by": "bytes",
            "bound_share": bound / ms, "cold_ms": cold,
            "cold_bound_share": bound / cold, "max_rel_err": err}


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
    by_family, shapes, ms_shapes = {}, [], []
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
        # attend_local there); K3 serves the rebuild of a paged state; the
        # mamba state kernel every mamba layer (the plain twin's apart)
        k1_layers = 0 if cfg.family == "encdec" else n_paged
        n_mamba = (res["peak"]["ssm"].h.shape[0] if "ssm" in res["peak"]
                   else 0)
        expected = {"K1": k1_layers * MEGASTEP * res["megasteps"], "K2": 0,
                    "K3": 1 if n_paged else 0,
                    "MS": n_mamba * MEGASTEP * res["megasteps"]}
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
            if n_mamba:
                ms_shapes.append(mamba_state_at(res["peak"], run,
                                                cfg.activation_dtype()))
        out["phase_seconds"] = time.perf_counter() - t0
        emit("families", run=run, launches=launches, **out)
        del res, params
        torch.cuda.empty_cache()
    return by_family, shapes, ms_shapes


# ---------------------------------------------------------------------------
# Phase 14: serving on a device mesh, 4 ranks placed by launch/mesh.card_of.

def mesh_config(table: str = "serve_rules", arch: str = ARCH,
                layers: int = MESH_LAYERS):
    """The mesh phase's config: full published width, depth cut to
    ``layers``, K1 on; ``tp_impl="manual"`` for the fused manual rules."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              fused_kernel=True)
    if table == "serve_manual_rules":
        cfg = dataclasses.replace(cfg, tp_impl="manual")
    return cfg


def mesh_batcher(cfg, params, rules):
    """``ContinuousBatcher`` over ``MESH_TRAFFIC`` at the serve phase's
    geometry, on one device (``rules=None``) or on this rank of the mesh;
    the pool (``MESH_PAGES``, a multiple of the 4 ranks) never grows."""
    from repro_torch.launch.serve import ContinuousBatcher
    from repro_torch.serving.sched import Scheduler, synthetic_workload
    tr = MESH_TRAFFIC
    sched = Scheduler(slots=BATCH, page_size=PAGE_SIZE,
                      max_len=tr["max_len"], megastep_k=MEGASTEP)
    srv = ContinuousBatcher(cfg, params, batch=BATCH, max_len=tr["max_len"],
                            page_size=PAGE_SIZE, megastep_k=MEGASTEP,
                            verify_block_table=True, scheduler=sched,
                            n_pages=MESH_PAGES, auto_refill=False,
                            seed=SEED, rules=rules,
                            device=DEV if rules is None else None)
    sched.submit_many(synthetic_workload(
        tr["requests"], vocab_size=cfg.vocab_size, max_len=tr["max_len"],
        seed=SEED, prompt_len=tr["prompt_len"], max_new=tr["max_new"]))
    return srv


def table_words(state):
    """A state's page table and block table on the host."""
    t = state["table"]
    return (t.table.cpu(), int(t.num_keys), int(t.num_tombs),
            state["block_table"].cpu())


def mesh_serve(srv, tables=None):
    """Serve ``srv`` to the end; with ``tables`` (the one-device run's per
    round), each round's page table and block table must equal it bit for
    bit.  Returns the per-round tables, the state after round
    ``MESH_MID_ROUND`` (with its next tokens), the stats, the sampled
    tokens and the peak: layer 0's pools, the positions and the block
    table of the state with the most live pages (the table is replicated,
    so every rank takes the same round)."""
    import torch
    from repro_torch.device import SYNC_STATS
    from repro_torch.dist import collectives as C
    from repro_torch.serving import engine as EG
    inner, megasteps, tokens = srv.mega_fn, 0, 0

    def counted(params, state, *args):
        nonlocal megasteps, tokens
        p0 = state["pos"]
        toks, st = inner(params, state, *args)
        tokens += int((st["pos"] - p0).sum())
        megasteps += 1
        return toks, st
    srv.mega_fn = counted
    syncs0, coll0 = SYNC_STATS["host_syncs"], dict(C.COLLECTIVE_STATS)
    seen, mid, rounds, secs = [], None, 0, 0.0
    peak, peak_live = None, -1
    torch.cuda.reset_peak_memory_stats()
    while not srv.sched.drained:
        if rounds >= 400:
            raise AssertionError("mesh serve did not drain in 400 rounds")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.step_round()
        torch.cuda.synchronize()
        secs += time.perf_counter() - t0
        words = table_words(srv.state)
        if tables is not None:
            ref = tables[rounds] if rounds < len(tables) else None
            if ref is None or not (torch.equal(words[0], ref[0])
                                   and words[1:3] == ref[1:3]
                                   and torch.equal(words[3], ref[3])):
                raise AssertionError(f"round {rounds}: the page table "
                                     f"differs from the one-device run's")
        seen.append(words)
        if words[1] > peak_live and bool(srv.state["active"].any()):
            pools = srv.state["pools"]
            peak_live = words[1]
            peak = dict(pk=pools.k[0].clone(), pv=pools.v[0].clone(),
                        pos=srv.state["pos"].clone(),
                        block_table=srv.state["block_table"].clone(),
                        live_pages=peak_live, round=rounds)
        rounds += 1
        if rounds == MESH_MID_ROUND:
            mid = (EG.clone_state(srv.state), srv.tokens.clone())
    if tables is not None and rounds != len(tables):
        raise AssertionError(f"{rounds} rounds, the one-device run took "
                             f"{len(tables)}")
    st = srv.sched.summary()
    if st["completed"] != MESH_TRAFFIC["requests"] or st["aborts"] or \
            st["pool_grows"]:
        raise AssertionError(f"mesh serve: {st}")
    stats = dict(rounds=rounds, megasteps=megasteps, token_steps=tokens,
                 seconds=secs, tokens_per_s=tokens / secs,
                 host_syncs_per_token=(SYNC_STATS["host_syncs"] - syncs0)
                 / tokens,
                 collectives_per_token=(C.COLLECTIVE_STATS["calls"]
                                        - coll0["calls"]) / tokens,
                 staged_per_token=(C.COLLECTIVE_STATS["staged"]
                                   - coll0["staged"]) / tokens,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 completed=st["completed"], aborts=st["aborts"],
                 pool_grows=st["pool_grows"])
    sampled = {r.req_id: list(r.sampled) for r in srv.sched.finished}
    return seen, mid, stats, sampled, peak


def state_to(state, device):
    """A decode state's tensors on ``device``."""
    return {k: (type(v)(*(t.to(device) for t in v)) if isinstance(v, tuple)
                else v.to(device)) for k, v in state.items()}


def forced_tokens(cfg, steps: int):
    import numpy as np
    return np.random.default_rng(SEED + 21).integers(
        0, cfg.vocab_size, (BATCH, steps)).astype(np.int32)


def forced_run(cfg, params, rules, steps: int):
    """``steps`` single serve steps from a fresh state, fed the seeded
    tokens at positions 0, 1, ...; returns the last step's logits and
    the state."""
    import torch
    from repro_torch.serving import engine as EG
    toks = torch.from_numpy(forced_tokens(cfg, steps)).to(DEV)
    max_len = MESH_TRAFFIC["max_len"]
    state, _ = EG.make_decode_state(cfg, BATCH, max_len, rules=rules,
                                    page_size=PAGE_SIZE,
                                    device=DEV if rules is None else None)
    step = EG.make_serve_step(cfg, S_max=max_len, rules=rules,
                              page_size=PAGE_SIZE)
    for t in range(steps):
        logits, state = step(params, *step_args(cfg, state,
                                                toks[:, t:t + 1]))
    return logits, state, toks[:, -1:]


def encdec_config():
    """seamless at full width, its encoder and decoder both cut to
    ``MESH_ENCDEC``'s depth."""
    arch, layers = MESH_ENCDEC
    return dataclasses.replace(mesh_config("serve_rules", arch, layers),
                               encoder_layers=layers)


def encdec_forced(cfg, params, rules, steps: int):
    """seamless on one device or this rank of the mesh: the encoder's
    prefill of seeded frames (``prepare_encdec_state``), then ``steps``
    single serve steps fed the seeded tokens; returns the logits at
    ``MESH_ENCDEC_CHECKS`` and every step's tables."""
    import torch
    from repro_torch.serving import engine as EG
    toks = torch.from_numpy(forced_tokens(cfg, steps)).to(DEV)
    max_len = MESH_TRAFFIC["max_len"]
    g = torch.Generator(device=DEV).manual_seed(SEED + 22)
    src = torch.randn((BATCH, max_len // 8, cfg.d_model), generator=g,
                      device=DEV).to(cfg.activation_dtype())
    state, _ = EG.make_decode_state(cfg, BATCH, max_len, rules=rules,
                                    page_size=PAGE_SIZE, n_pages=MESH_PAGES,
                                    device=DEV if rules is None else None)
    state = EG.prepare_encdec_state(cfg, params, state, src, rules=rules)
    step = EG.make_serve_step(cfg, S_max=max_len, rules=rules,
                              page_size=PAGE_SIZE)
    logits_at, tables = {}, []
    for t in range(steps):
        logits, state = step(params, *step_args(cfg, state,
                                                toks[:, t:t + 1]))
        tables.append(table_words(state))
        if t in MESH_ENCDEC_CHECKS:
            logits_at[t] = logits.cpu()
    return logits_at, tables


def rel_err_live(a, b, live) -> float:
    a, b = a[live].float(), b[live].float()
    return float((a - b).norm() / b.norm())


def mesh_reference() -> dict:
    """The one-device runs the mesh is held to, on the card: the main
    config served (``mesh_batcher``), its tables every round, the state
    after round ``MESH_MID_ROUND`` and one serve step's logits on it; and
    each of ``MESH_FAMILIES`` fed ``MESH_FAMILY_STEPS`` seeded tokens (the
    last step's logits).  Weights from the seed, freed on return."""
    import torch
    from repro_torch.models.registry import get_model
    from repro_torch.serving import engine as EG
    cfg = mesh_config()
    params = get_model(cfg).init(
        cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    srv = mesh_batcher(cfg, params, None)
    tables, (mid, mid_tok), stats, sampled, _ = mesh_serve(srv)
    step = EG.make_serve_step(cfg, S_max=MESH_TRAFFIC["max_len"],
                              page_size=PAGE_SIZE)
    logits, _ = step(params, *step_args(cfg, EG.clone_state(mid), mid_tok))
    out = {"tables": tables, "mid": state_to(mid, "cpu"),
           "mid_tokens": mid_tok.cpu(), "mid_logits": logits.cpu(),
           "stats": stats, "sampled": sampled, "families": {}}
    del srv, params, mid
    torch.cuda.empty_cache()
    for run, arch, layers in MESH_FAMILIES:
        fcfg = mesh_config("serve_rules", arch, layers)
        params = get_model(fcfg).init(
            fcfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
        logits, _, _ = forced_run(fcfg, params, None, MESH_FAMILY_STEPS)
        out["families"][run] = logits.cpu()
        del params
        torch.cuda.empty_cache()
    ecfg = encdec_config()
    params = get_model(ecfg).init(
        ecfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    logits, tables = encdec_forced(ecfg, params, None, MESH_FAMILY_STEPS)
    out["encdec"] = {"logits": logits, "tables": tables}
    del params
    torch.cuda.empty_cache()
    return out


def mesh_params(cfg, rules):
    """This rank's pieces of the seeded weights: the whole tree drawn on
    the card from the seed (the one-device run's bits), cut with
    ``engine.mesh_param_specs`` and freed."""
    import torch
    from repro_torch.dist.sharding import local_shard
    from repro_torch.models.registry import get_model
    from repro_torch.serving import engine as EG
    full = get_model(cfg).init(
        cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    params = local_shard(full, EG.mesh_param_specs(cfg, full, rules),
                         rules.mesh)
    del full
    torch.cuda.empty_cache()
    return params


def mesh_megastep_bits(cfg, params, rules, state, tokens):
    """On the mesh: one K-token megastep and K single greedy steps (with
    the abort latch) from clones of one state give the same tokens and
    every state leaf bit for bit."""
    import torch
    from repro_torch.serving import engine as EG
    max_len = MESH_TRAFFIC["max_len"]
    step = EG.make_serve_step(cfg, S_max=max_len, rules=rules,
                              page_size=PAGE_SIZE)
    st, tok, ref = EG.clone_state(state), tokens.clone(), []
    for _ in range(MEGASTEP):
        lg, st = step(params, *step_args(cfg, st, tok))
        nxt = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
        tok = torch.where(st["aborted"][:, None], tok, nxt)
        ref.append(tok[:, 0])
    mega = EG.make_serve_megastep(cfg, S_max=max_len, K=MEGASTEP,
                                  rules=rules, page_size=PAGE_SIZE)
    mt, ms = mega(params, EG.clone_state(state), tokens.clone())
    leaves = [(k, x, y) for k in ms
              for x, y in (zip(ms[k], st[k]) if isinstance(ms[k], tuple)
                           else [(ms[k], st[k])])]
    diff = [k for k, x, y in leaves if not torch.equal(x, y)]
    if not torch.equal(mt, torch.stack(ref, dim=1)) or diff:
        raise AssertionError(f"{cfg.name}: the megastep differs from "
                             f"{MEGASTEP} single steps: leaves {diff}")
    return True


def mesh_dht(rank: int) -> dict:
    """The mesh DHT over the 4 ranks (one axis), ``MESH_DHT``: a
    2^20-cell table filled to live load 0.9 in batches of 4096 requests a
    rank, then churn rounds (a batch of deletes of live keys and inserts
    of fresh ones, then one of lookups, half live, half absent), the same
    ops on a card table and on a CPU table over the same process group.
    Each rank's keys are its own, so a Python set per rank models them
    exactly: every answer must equal the model's, overflowed requests (-1)
    are retried, and the card's shard words must equal the CPU's."""
    import numpy as np
    import torch
    from repro_torch.core import sharded as SHT
    from repro_torch.core.spec import OP_DELETE, OP_INSERT, OP_LOOKUP
    from repro_torch.launch.mesh import make_mesh
    cfg = MESH_DHT
    mesh = make_mesh((4,), ("model",), DEV)
    S, B = 4, cfg["batch"]
    cap = B // S + cfg["slack"]
    m = cfg["m_global"]
    rng = np.random.default_rng(SEED + 31)
    per_rank = int(cfg["load"] * m) // S
    churn = cfg["churn_rounds"] * B // 2
    universe = rng.choice(1 << 27, size=S * (per_rank + 2 * churn + B),
                          replace=False).reshape(S, -1)[rank]
    fill = universe[:per_rank]
    fresh = universe[per_rank:per_rank + churn]
    absent = universe[per_rank + churn:]
    st_card, apply = SHT.make_sharded_table(mesh, "model", m, cap)
    st_cpu = SHT.create_sharded(1, m // S, 0, device="cpu")
    live, stats = set(), {"batches": 0, "overflowed": 0, "card_s": 0.0,
                          "cpu_s": 0.0}

    def run(ops, keys):
        """One batch on both tables; returns the applied mask."""
        nonlocal st_card, st_cpu
        t0 = time.perf_counter()
        st_card, ret, ovf = apply(st_card, torch.from_numpy(ops).to(DEV),
                                  torch.from_numpy(keys).to(DEV))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st_cpu, ret_c, ovf_c = apply(st_cpu, torch.from_numpy(ops),
                                     torch.from_numpy(keys))
        stats["card_s"] += t1 - t0
        stats["cpu_s"] += time.perf_counter() - t1
        ret, ovf = ret.cpu().numpy(), ovf.cpu().numpy()
        if not (np.array_equal(ret, ret_c.numpy())
                and np.array_equal(ovf, ovf_c.numpy())):
            raise AssertionError("mesh DHT: card and CPU answers differ")
        for o, k, r, f in zip(ops, keys, ret, ovf):
            k = int(k)
            if f:
                if r != -1:
                    raise AssertionError("overflowed request answered")
                continue
            want = {OP_INSERT: int(k not in live), OP_DELETE: int(k in live),
                    OP_LOOKUP: int(k in live)}[int(o)]
            if r != want:
                raise AssertionError(f"mesh DHT: op {o} key {k} returned "
                                     f"{r}, the set model {want}")
            if o == OP_INSERT:
                live.add(k)
            elif o == OP_DELETE:
                live.discard(k)
        stats["batches"] += 1
        stats["overflowed"] += int(ovf.sum())
        return ~ovf

    def drain(ops, keys):
        """All of (ops, keys) in batches of B, overflow retried.  Every
        rank runs the same number of batches (the collectives pair up):
        the count is agreed by an all-reduce of the pending lengths."""
        from repro_torch.dist import collectives as C
        pending_o, pending_k = ops, keys
        while True:
            n = int(C.pmax(torch.tensor([len(pending_k)]), "model"))
            if n == 0:
                return
            o = np.full(B, OP_LOOKUP, np.int32)
            k = absent[-B:].astype(np.int64).copy()
            take = min(B, len(pending_k))
            o[:take], k[:take] = pending_o[:take], pending_k[:take]
            applied = run(o, k)
            again = ~applied[:take]
            pending_o = np.concatenate([pending_o[:take][again],
                                        pending_o[take:]])
            pending_k = np.concatenate([pending_k[:take][again],
                                        pending_k[take:]])

    t0 = time.perf_counter()
    drain(np.full(per_rank, OP_INSERT, np.int32), fill.astype(np.int64))
    fill_s = time.perf_counter() - t0
    for r in range(cfg["churn_rounds"]):
        gone = np.array(sorted(live))[rng.permutation(len(live))[:B // 2]]
        new = fresh[r * (B // 2):(r + 1) * (B // 2)]
        drain(np.concatenate([np.full(B // 2, OP_DELETE, np.int32),
                              np.full(B // 2, OP_INSERT, np.int32)]),
              np.concatenate([gone, new]).astype(np.int64))
        look = np.concatenate([np.array(sorted(live))[:B // 2],
                               absent[:B // 2]]).astype(np.int64)
        drain(np.full(B, OP_LOOKUP, np.int32), look)
    if not (torch.equal(st_card.table.cpu(), st_cpu.table)
            and torch.equal(st_card.num_keys.cpu(), st_cpu.num_keys)
            and torch.equal(st_card.num_tombs.cpu(), st_cpu.num_tombs)):
        raise AssertionError("mesh DHT: the card's shard differs from the "
                             "CPU run's")
    return dict(m_global=m, shards=S, batch=B, capacity=cap,
                live_keys=len(live), shard_keys=int(st_card.num_keys[0]),
                shard_tombs=int(st_card.num_tombs[0]),
                shard_load=(int(st_card.num_keys[0])
                            + int(st_card.num_tombs[0])) / (m // S),
                fill_s=fill_s, **stats)


def mesh_rank(rank: int, ref: dict) -> dict:
    """One rank of the (data 2, model 2) mesh on the card: for each rule
    set, qwen2.5-32b served at full width over ``MESH_TRAFFIC`` with its
    tables held to the one-device run's every round; the one-device
    mid-run state cut into this rank's pieces (``engine.shard_state``)
    re-hashed into a 2x pool on the mesh through K3, equal bit for bit to
    this rank's piece of the one-device re-hash (``find_batch``); the
    launches counted over the serve and that rebuild; one step's logits
    on the mid-run state held to the one-device step's, and the megastep
    against K single steps; then the families (manual rules) and the
    DHT."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import engine as EG
    from repro_torch.dist import collectives as C
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, DEV)
    C.reset_stats()
    wrappers = kernel_wrappers()
    checks = {k: 0 for k in wrappers}
    out = {"rank": rank, **mesh_where(mesh)}
    for table in ("serve_rules", "serve_manual_rules"):
        cfg = mesh_config(table)
        rules = getattr(SH, table)(mesh)
        params = mesh_params(cfg, rules)
        srv = mesh_batcher(cfg, params, rules)
        for w in wrappers.values():
            w.launches = 0
        _, _, stats, sampled, peak = mesh_serve(srv, ref["tables"])
        _, axes = EG.make_decode_state(cfg, BATCH, MESH_TRAFFIC["max_len"],
                                       rules=rules, page_size=PAGE_SIZE,
                                       n_pages=MESH_PAGES)
        mid = EG.shard_state(cfg, ref["mid"], axes, rules)
        grown = EG.rebuild_page_table(EG.clone_state(mid),
                                      n_pages=2 * MESH_PAGES,
                                      use_kernel=True)
        launches = {k: w.launches for k, w in wrappers.items()}
        n_paged, _ = EG._n_attn_layers(cfg)
        want = {"K1": n_paged * MEGASTEP * stats["megasteps"], "K2": 0,
                "K3": 1, "MS": 0}
        if launches != want:
            raise AssertionError(f"{table}: launches {launches}, expected "
                                 f"{want}")
        one = EG.rebuild_page_table(state_to(ref["mid"], DEV),
                                    n_pages=2 * MESH_PAGES, use_kernel=False)
        piece = EG.shard_state(cfg, one, axes, rules)
        diff = [k for k in piece for a, b in (
            zip(grown[k], piece[k]) if isinstance(piece[k], tuple)
            else [(grown[k], piece[k])]) if not torch.equal(a, b)]
        if diff:
            raise AssertionError(f"{table}: the mesh rebuild differs from "
                                 f"the one-device rebuild's piece: {diff}")
        rebuild = dict(n_pages_from=MESH_PAGES, n_pages_to=2 * MESH_PAGES,
                       live_pages=int(one["table"].num_keys),
                       local_pages=int(grown["pools"].k.shape[1]),
                       k3_launches=launches["K3"], equal=True)
        del grown, one, piece
        tok = ref["mid_tokens"].to(DEV)
        with uncounted(checks):
            step = EG.make_serve_step(cfg, S_max=MESH_TRAFFIC["max_len"],
                                      rules=rules, page_size=PAGE_SIZE)
            logits, _ = step(params, *step_args(cfg, EG.clone_state(mid),
                                                tok))
            live = ref["mid"]["active"] & ~ref["mid"]["aborted"]
            rel = rel_err_live(logits.cpu(), ref["mid_logits"], live)
            if not rel <= LOGITS_REL_TOL:
                raise AssertionError(f"{table}: mid-run logits relative "
                                     f"error {rel} > {LOGITS_REL_TOL}")
            mesh_megastep_bits(cfg, params, rules, mid, tok)
        out[table] = dict(
            stats, launches=launches, midrun_rel_err=rel, rebuild=rebuild,
            report=EG.fallback_report(cfg, rules), sampled=sampled,
            k1=None if rank else dict(
                pk=peak["pk"].cpu(), pv=peak["pv"].cpu(),
                pos=peak["pos"].cpu(),
                bt=EG._local_block_table(
                    peak["block_table"], EG._chip_idx(
                        EG._ops(cfg, rules).page_axes()),
                    peak["pk"].shape[0]).cpu(),
                QH=rank_q_heads(cfg, rules), round=peak["round"],
                live_pages=peak["live_pages"]))
        del srv, params, mid, step, peak
        torch.cuda.empty_cache()
    fams = {}
    for run, arch, layers in MESH_FAMILIES:
        cfg = mesh_config("serve_manual_rules", arch, layers)
        rules = SH.serve_manual_rules(mesh)
        if EG.fallback_report(cfg, rules)["decode_tp"] != "ok":
            raise AssertionError(f"{run}: {EG.fallback_report(cfg, rules)}")
        params = mesh_params(cfg, rules)
        with uncounted(checks):
            ms0 = wrappers["MS"].launches
            logits, state, tok = forced_run(cfg, params, rules,
                                            MESH_FAMILY_STEPS)
            fam = mesh_family_state(run, state,
                                    wrappers["MS"].launches - ms0,
                                    cfg.activation_dtype())
            live = torch.ones(BATCH, dtype=torch.bool)
            rel = rel_err_live(logits.cpu(), ref["families"][run], live)
            if not rel <= LOGITS_REL_TOL:
                raise AssertionError(f"{run}: logits relative error {rel} "
                                     f"> {LOGITS_REL_TOL}")
            mesh_megastep_bits(cfg, params, rules, state, tok)
        fams[run] = dict(arch=arch, layers=layers, rel_err=rel,
                         report=EG.fallback_report(cfg, rules), **fam)
        del params, state
        torch.cuda.empty_cache()
    out["families"] = fams
    cfg = encdec_config()
    rules = SH.serve_rules(mesh)
    params = mesh_params(cfg, rules)
    with uncounted(checks):
        logits, tables = encdec_forced(cfg, params, rules,
                                       MESH_FAMILY_STEPS)
    live = torch.ones(BATCH, dtype=torch.bool)
    rels = {t: rel_err_live(logits[t], ref["encdec"]["logits"][t], live)
            for t in MESH_ENCDEC_CHECKS}
    if not max(rels.values()) <= LOGITS_REL_TOL:
        raise AssertionError(f"seamless on the mesh: logits relative errors "
                             f"{rels} > {LOGITS_REL_TOL}")
    for t, (a, b) in enumerate(zip(tables, ref["encdec"]["tables"])):
        if not (torch.equal(a[0], b[0]) and a[1:3] == b[1:3]
                and torch.equal(a[3], b[3])):
            raise AssertionError(f"seamless on the mesh: step {t}'s tables "
                                 f"differ from the one-device run's")
    out["encdec"] = dict(arch=cfg.name, layers=cfg.num_layers,
                         encoder_layers=cfg.encoder_layers,
                         steps=MESH_FAMILY_STEPS, rel_err_by_step=rels,
                         tables_equal_every_step=True,
                         report=EG.fallback_report(cfg, rules))
    del params
    torch.cuda.empty_cache()
    out["dht"] = mesh_dht(rank)
    out["checks"] = checks
    out["staged"] = C.COLLECTIVE_STATS["staged"]
    out["collectives"] = C.COLLECTIVE_STATS["calls"]
    return out


def mesh_family_state(run: str, state, ms_launches: int, dtype) -> dict:
    """A mesh family run's mamba state kernel: launched once per mamba
    layer per token step on this rank (``MESH_FAMILY_STEPS`` single
    steps), and at the rank's shape (its lanes and heads of the first
    layer's ``h`` after the run, every other lane frozen) held to its
    plain version in float32 and in the run's activation dtype
    (``check_mamba_state``; the float32 error reported)."""
    import torch
    n_mamba = state["ssm"].h.shape[0] if "ssm" in state else 0
    if ms_launches != n_mamba * MESH_FAMILY_STEPS:
        raise AssertionError(f"{run}: {ms_launches} mamba state kernel "
                             f"launches on the mesh, expected {n_mamba} "
                             f"layers x {MESH_FAMILY_STEPS} steps")
    if not n_mamba:
        return {"ms_launches": 0}
    h = state["ssm"].h[0]
    keep = torch.ones(h.shape[0], dtype=torch.bool, device=h.device)
    keep[1::2] = False
    err = check_mamba_state(mamba_state_inputs(h, torch.float32,
                                               SEED + 17, keep))
    check_mamba_state(mamba_state_inputs(h, dtype, SEED + 17, keep))
    return {"ms_launches": ms_launches, "ms_h_shape": list(h.shape),
            "ms_max_rel_err": err}


def rank_q_heads(cfg, rules) -> int:
    """The q heads a rank's K1 call takes: its head shard in the fused
    manual layout, all of them (all-gathered) on the gspmd step."""
    from repro_torch.serving import engine as EG
    return (cfg.n_q // rules.mesh.shape["model"]
            if EG._manual_decode_ok(cfg, rules) else cfg.n_q)


def k1_mesh_row(table: str, k1: dict, launches: int) -> dict:
    """K1 at a mesh rank's shape (rank 0's layer-0 pools and local block
    table at the serve's peak state, a seeded query of its q heads): held to
    the plain version and the K2 composition, timed alone on the card
    beside its bound and SDPA over the same pages."""
    import torch
    from repro_torch.kernels.fused_decode import (fused_decode_kernel,
                                                  fused_decode_plain,
                                                  fused_decode_ref)
    pk, pv = k1["pk"].to(DEV), k1["pv"].to(DEV)
    bt, pos = k1["bt"].to(DEV), k1["pos"].to(DEV)
    B, MP = bt.shape
    _, PS, KH, D = pk.shape
    g = torch.Generator(device=DEV).manual_seed(SEED + 19)
    q = torch.randn((B, k1["QH"], D), generator=g, device=DEV).to(pk.dtype)
    part = fused_decode_kernel(q, pk, pv, bt, pos, partials=True)
    ref = fused_decode_plain(q, pk, pv, bt, pos, partials=True)
    err = max(close(a, b, PARTIALS_TOL) for a, b in zip(part, ref))
    if not torch.equal(fused_decode_kernel(q, pk, pv, bt, pos),
                       fused_decode_ref(q, pk, pv, bt, pos)):
        raise AssertionError(f"{table}: K1 != K2 composition")
    (bound, by), _ = attention_bounds(q, pk, bt, pos)
    ms = graph_ms(lambda: fused_decode_kernel(q, pk, pv, bt, pos,
                                              partials=True), 100)
    return {"layout": table, "B": B, "QH": k1["QH"], "KH": KH, "D": D,
            "PS": PS, "MP": MP, "local_pages": pk.shape[0],
            "round": k1["round"], "live_pages": k1["live_pages"],
            "local_tokens": int(attention_tokens(pk, bt, pos)),
            "launches_per_rank": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": graph_ms(lambda: fused_decode_plain(
                q, pk, pv, bt, pos, partials=True), 10),
            "bound_ms": bound, "bound_by": by, "bound_share": bound / ms,
            "library_ms": sdpa_ms(q, pk, pv, bt, pos, PS, holes=True)}


def attention_tokens(pk, bt, pos) -> int:
    import torch
    B, MP = bt.shape
    PS = pk.shape[1]
    live = (torch.arange(MP, device=bt.device)[None, :] * PS
            <= pos[:, None]) & (bt >= 0)
    return int((torch.clamp(pos[:, None] + 1 - torch.arange(
        MP, device=bt.device)[None, :] * PS, 0, PS) * live).sum())


def phase_mesh() -> dict:
    """Phase 14 (module docstring): the one-device runs, then 4 ranks on
    the card.  Returns the launches per rank on the mesh's serve paths
    and K1's rows at the two mesh shapes."""
    import torch
    from repro_torch.launch.mesh import run_spmd
    t0 = time.perf_counter()
    ref = mesh_reference()
    ref_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    n = MESH_SHAPE[0] * MESH_SHAPE[1]
    outs = run_spmd(mesh_rank, n, (ref,), device=DEV,
                    timeout_s=MESH_TIMEOUT_S, threads=2)
    want = "nccl" if torch.cuda.device_count() >= n else "peer"
    for o in outs:
        if o["transport"] != want or o["staged"]:
            raise AssertionError(f"mesh: rank {o['rank']} ran on "
                                 f"{o['transport']} with {o['staged']} of "
                                 f"{o['collectives']} collectives staged; "
                                 f"expected {want}, none staged")
    where = dict(placement=outs[0]["placement"], transport=want,
                 cards_by_rank=[o["card"] for o in outs],
                 staged_by_rank=[o["staged"] for o in outs])
    rows, launches = [], {}
    for table in ("serve_rules", "serve_manual_rules"):
        r0 = outs[0][table]
        for o in outs[1:]:
            if o[table]["sampled"] != r0["sampled"] or \
                    o[table]["launches"] != r0["launches"]:
                raise AssertionError(f"{table}: rank {o['rank']}'s tokens "
                                     f"or launches differ from rank 0's")
        same = total = 0
        for rid, toks in r0["sampled"].items():
            total += len(toks)
            same += sum(int(a == b) for a, b in zip(toks,
                                                    ref["sampled"][rid]))
        stats = {k: v for k, v in r0.items() if k not in ("sampled", "k1")}
        emit("mesh", layout=table, mesh=dict(zip(MESH_AXES, MESH_SHAPE)),
             **where,
             arch=ARCH, layers=MESH_LAYERS, batch=BATCH,
             page_size=PAGE_SIZE, megastep=MEGASTEP, n_pages=MESH_PAGES,
             traffic=MESH_TRAFFIC, tables_equal_every_round=True,
             tokens_equal_across_ranks=True, megastep_bitwise=True,
             token_agreement_vs_one_device=same / total,
             peak_mem_gib_by_rank=[o[table]["peak_mem_gib"] for o in outs],
             one_device=ref["stats"], **stats)
        launches[table] = r0["launches"]
        rows.append(k1_mesh_row(table, r0["k1"], launches[table]["K1"]))
    emit("mesh_families", **outs[0]["families"])
    emit("mesh_encdec", layout="serve_rules",
         mesh=dict(zip(MESH_AXES, MESH_SHAPE)), **outs[0]["encdec"])
    dht = [o["dht"] for o in outs]
    if sum(d["shard_keys"] for d in dht) != sum(d["live_keys"] for d in dht):
        raise AssertionError("mesh DHT: the shards' key counts do not add "
                             "up to the ranks' live keys")
    emit("mesh_dht", by_rank=dht)
    emit("mesh_done", seconds=time.perf_counter() - t0,
         reference_seconds=ref_s, k1_rows=rows, **where)
    return {"launches": launches, "rows": rows}


# ---------------------------------------------------------------------------
# The collectives check: every op under two transports, bit for bit.

def coll_ops(rank: int, nbytes: int) -> dict:
    """The check's ops on the bound (data 2, model 2) mesh, on operands
    of ``nbytes`` a rank drawn on the card from the seed, the rank and the
    size."""
    import torch
    from repro_torch.dist import collectives as C
    g = torch.Generator(device=DEV).manual_seed(SEED + 1000 * rank + nbytes)
    f = torch.randn((4, nbytes // 16), generator=g, device=DEV)
    b = torch.randn((4, nbytes // 8), generator=g,
                    device=DEV).to(torch.bfloat16)
    both = ("data", "model")
    return {
        "psum_bf16": lambda: C.psum(b, both),
        "psum_f32": lambda: C.psum(f, both),
        "pmax": lambda: C.pmax(f, "data"),
        "all_gather_tiled": lambda: C.all_gather(f, "model", dim=1),
        "all_gather_stacked": lambda: C.all_gather(b, both, tiled=False),
        "all_to_all": lambda: C.all_to_all(f, both),
        "reduce_scatter": lambda: C.reduce_scatter(f, both, dim=0),
        "ppermute": lambda: C.ppermute(f, "data", [(0, 1), (1, 0)]),
        "gather_to_root": lambda: C.gather_to_root(b, 0),
    }


def coll_bytes(out):
    """A result as bytes (a list of host tensors from ``gather_to_root``
    stacked first; None stays None)."""
    import torch
    from repro_torch.dist.peer import as_bytes
    if out is None:
        return None
    if isinstance(out, list):
        out = torch.stack(out)
    return as_bytes(out.contiguous())


def coll_back_to_back(rank: int) -> list:
    """``COLL_BACK_TO_BACK`` collectives in a row: a psum over every rank
    of one slot and a quarter, then an all_gather and a psum of 4 KiB over
    the pairs along ``data`` (a writer reuses its slots while readers of
    its last one may still be reading)."""
    import torch
    from repro_torch.dist import collectives as C
    from repro_torch.dist import peer as PEER
    g = torch.Generator(device=DEV).manual_seed(SEED + 77 + rank)
    big = torch.randn((4, 5 * PEER.SLOT_BYTES // 64), generator=g,
                      device=DEV)
    small = torch.randn((4, 512), generator=g, device=DEV).to(torch.bfloat16)
    outs = []
    for i in range(COLL_BACK_TO_BACK):
        if i % 3 == 0:
            outs.append(C.psum(big * (i + 1), ("data", "model")))
        elif i % 3 == 1:
            outs.append(C.all_gather(small + i, "data"))
        else:
            outs.append(C.psum(small * i, "data"))
    return outs


def coll_rank(rank: int, transports) -> dict:
    """One rank of the check: a mesh per transport (None: the one the
    placement gives), then for each size and op, the op under each
    transport in turn, equal bit for bit to the first's result, with the
    same bytes counted and nothing staged but on gloo; the ms a call over
    back-to-back calls; then the back-to-back run under each."""
    import torch
    from repro_torch.dist import collectives as C
    from repro_torch.launch.mesh import make_mesh, placement
    meshes = [make_mesh(MESH_SHAPE, MESH_AXES, DEV, transport=t)
              for t in transports]
    names = [m.transport for m in meshes]
    ms = {t: {} for t in names}
    staged = {t: 0 for t in names}
    for nbytes, reps in zip(COLL_SIZES, COLL_REPS):
        for t in names:
            ms[t][nbytes] = {}
        for op in coll_ops(rank, nbytes):
            first = None
            for t, mesh in zip(names, meshes):
                C.set_mesh(mesh)
                fn = coll_ops(rank, nbytes)[op]
                C.reset_stats()
                got = coll_bytes(fn())
                by_op = {k: dict(v)
                         for k, v in C.COLLECTIVE_STATS["by_op"].items()}
                staged[t] += C.COLLECTIVE_STATS["staged"]
                if first is None:
                    first = (got, by_op)
                elif not ((got is None and first[0] is None) or torch.equal(
                        got.to(first[0].device), first[0])) \
                        or by_op != first[1]:
                    raise AssertionError(
                        f"collectives: {op} of {nbytes} bytes on rank "
                        f"{rank} under {t} differs from {names[0]}")
                del got
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                ms[t][nbytes][op] = (time.perf_counter() - t0) * 1e3 / reps
            del first
    runs = []
    for t, mesh in zip(names, meshes):
        C.set_mesh(mesh)
        runs.append([coll_bytes(o) for o in coll_back_to_back(rank)])
    for t, run in zip(names[1:], runs[1:]):
        if not all(torch.equal(a, b) for a, b in zip(run, runs[0])):
            raise AssertionError(f"collectives: back-to-back run under {t} "
                                 f"differs from {names[0]} on rank {rank}")
    return {"rank": rank, "transports": names, "ms": ms, "staged": staged,
            "placement": placement(meshes[0].size,
                                   torch.cuda.device_count()),
            "card": torch.cuda.current_device()}


def phase_collectives() -> dict:
    """The ``collectives`` check (constants above): 4 ranks sharing card
    0 under the peer buffers and under gloo; with 4 or more cards also
    one rank a card under NCCL and gloo.  Prints the ms a call for each
    transport, op and size beside the card."""
    import torch
    from repro_torch.dist import peer as PEER
    from repro_torch.launch.mesh import run_spmd
    t0 = time.perf_counter()
    n = MESH_SHAPE[0] * MESH_SHAPE[1]
    cards = torch.cuda.device_count()
    runs = {}
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    try:
        # the shared placement on a host with a card a rank: the ranks see
        # one card only
        if cards >= n:
            os.environ["CUDA_VISIBLE_DEVICES"] = (env or "0").split(",")[0]
        runs["shared"] = run_spmd(coll_rank, n, ((None, "gloo"),),
                                  device=DEV, timeout_s=COLL_TIMEOUT_S)
    finally:
        if env is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = env
    if cards >= n:
        runs["per card"] = run_spmd(coll_rank, n, ((None, "gloo"),),
                                    device=DEV, timeout_s=COLL_TIMEOUT_S)
    card = nvidia_smi()
    for where, outs in runs.items():
        want = ["peer" if where == "shared" else "nccl", "gloo"]
        for o in outs:
            if o["transports"] != want or o["placement"] != where:
                raise AssertionError(f"collectives: rank {o['rank']} ran "
                                     f"{o['transports']} {o['placement']}, "
                                     f"expected {want} {where}")
            if o["staged"][want[0]] != 0 or o["staged"]["gloo"] == 0:
                raise AssertionError(f"collectives: staged {o['staged']} "
                                     f"on rank {o['rank']}")
        for nbytes in COLL_SIZES:
            emit("collectives", placement=where, card=card,
                 mesh=dict(zip(MESH_AXES, MESH_SHAPE)),
                 bytes_a_rank=nbytes, slot_bytes=PEER.SLOT_BYTES,
                 cards_by_rank=[o["card"] for o in outs],
                 bitwise_equal=True, staged=outs[0]["staged"],
                 ms_a_call={t: outs[0]["ms"][t][nbytes] for t in want})
    emit("collectives_done", seconds=time.perf_counter() - t0,
         back_to_back=COLL_BACK_TO_BACK, bitwise_equal=True,
         nccl=("run one rank a card" if cards >= n else
               f"not run: {cards} card(s), NCCL needs one a rank ({n})"))


def mt_config(layers: int = MT_LAYERS, smoke: bool = False):
    """Phase mesh_train's model: codeqwen at full width, depth cut to
    ``layers`` (or its smoke config in float32)."""
    from repro_torch.configs import get_config, get_smoke_config
    if smoke:
        return dataclasses.replace(get_smoke_config(MT_ARCH),
                                   num_layers=layers, dtype="float32")
    return dataclasses.replace(get_config(MT_ARCH), num_layers=layers)


def mt_batch(cfg, step: int, device, batch=MT_BATCH, seq=MT_SEQ):
    from repro_torch.training import data as DATA
    return DATA.synth_batch(cfg, batch=batch, seq_len=seq, step=step,
                            seed=SEED, device=device)


def mt_init(cfg, device, rules=None):
    """The seeded train state (on the card's generator, the one-device
    run's bits), whole or this rank's shards."""
    import torch
    from repro_torch.training import train_step as TS
    gen = torch.Generator(device=device).manual_seed(SEED)
    return TS.init_state(cfg, gen, device, rules=rules)


def param_digest(params) -> list:
    """Per leaf, exact integer sums over its bits (the values, their
    squares and neighbour products, in chunks): equal trees give equal
    digests, and a rank whose bits drift shows it."""
    import torch
    from repro_torch.models import nn
    out = []
    for p in nn.tree_leaves(params):
        v = p.detach().reshape(-1)
        v = v.view(torch.int16 if v.element_size() == 2 else torch.int32)
        acc = [0, 0, 0]
        for lo in range(0, v.numel(), 1 << 25):
            c = v[lo:lo + (1 << 25)].long()
            acc[0] += int(c.sum())
            acc[1] += int((c * c).sum())
            acc[2] += int((c[1:] * c[:-1]).sum())
        out.append(tuple(acc))
    return out


def pipe_blocks(cfg, layers, device):
    """``layers`` blocks stacked ``[n, ...]``, block i drawn from its own
    seed (a stage draws only its own)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import nn
    return nn.stack_layer_params([
        L.block_init(cfg, cfg.activation_dtype(), torch.Generator(
            device=device).manual_seed(SEED + 100 + i), device)
        for i in layers])


def pipe_apply(cfg):
    """The pipeline's ``apply_range``: the blocks of a stacked stage in
    turn."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import nn

    def apply_range(w, x):
        pos = torch.arange(x.shape[1], device=x.device)
        for i in range(nn.tree_leaves(w)[0].shape[0]):
            x = L.block_apply(nn.layer_slice(w, i), x, pos, cfg)
        return x
    return apply_range


def pipe_input(cfg, device, batch=MT_BATCH, seq=MT_SEQ):
    import torch
    g = torch.Generator(device=device).manual_seed(SEED + 200)
    return torch.randn((batch, seq, cfg.d_model), generator=g,
                       device=device).to(cfg.activation_dtype())


def mt_reference() -> dict:
    """Phase mesh_train's one-device runs on the card: the loss of the
    seeded state on step 0's global batch, and the four seeded blocks'
    sequential forward of the pipeline's input."""
    import torch
    from repro_torch.models import nn
    from repro_torch.training import train_step as TS
    cfg = mt_config()
    st = mt_init(cfg, DEV)
    with torch.no_grad():
        loss = float(TS.make_loss_fn(cfg, remat=False)(
            st.params, mt_batch(cfg, 0, DEV)))
    sizes = [p.numel() for p in nn.tree_leaves(st.params)]
    del st
    pcfg = mt_config(MT_PIPE_LAYERS)
    w = pipe_blocks(pcfg, range(MT_PIPE_LAYERS), DEV)
    with torch.no_grad():
        y = pipe_apply(pcfg)(w, pipe_input(pcfg, DEV))
    del w
    torch.cuda.empty_cache()
    return {"loss0": loss, "n_params": sum(sizes), "biggest": max(sizes),
            "pipe_y": y.cpu()}


def mt_pod_rank(rank: int, shape, ref: dict) -> dict:
    """(a): the manual-pod compressed step on this rank of ``shape``
    (pod, data, model), replicated state from the seed."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.dist import collectives as C
    from repro_torch.dist import compression as COMP
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import train_step as TS
    mesh = make_mesh(shape, ("pod", "data", "model"), DEV)
    C.reset_stats()
    cfg = mt_config()
    st = mt_init(cfg, DEV)
    err = TS.init_pod_error_buffers(st.params, shape[0], mesh=mesh)
    step = TS.make_train_step_manual_pod(cfg, mesh,
                                         rules=SH.train_rules(mesh))
    wire_want = (shape[0] - 1) * COMP.compressed_bytes(st.params)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(MT_STEPS):
        b = mt_batch(cfg, i, DEV)
        C.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, err, m = step(st, err, b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        no_staged(f"manual pod step {i}")
        stats = {k: dict(v) for k, v in C.COLLECTIVE_STATS["by_op"].items()}
        wire = stats["all_gather"]["sent"]
        if wire != wire_want:
            raise AssertionError(f"manual pod: {wire} compressed wire bytes, "
                                 f"compressed_bytes says {wire_want}")
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        if not (np.isfinite(loss) and np.isfinite(gn)):
            raise AssertionError(f"manual pod step {i}: loss {loss}, grad "
                                 f"norm {gn}")
        steps.append(dict(loss=loss, grad_norm=gn, seconds=dt,
                          compressed_wire_bytes=wire,
                          collectives=C.COLLECTIVE_STATS["calls"],
                          by_op=stats, digest=param_digest(st.params)))
    return {"rank": rank, "steps": steps, **mesh_where(mesh),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def mt_rules_rank(rank: int, ref: dict, ckpt_dir: str) -> dict:
    """(b), (c) and (d) on this rank of the 4 (see the constants)."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.dist import collectives as C
    from repro_torch.dist import pipeline as PL
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import nn
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_step as TS
    out = {"rank": rank}
    cfg = mt_config()

    # (b) the rules step on (data 2, model 2)
    mesh = make_mesh(MT_RULES_SHAPE, ("data", "model"), DEV)
    out.update(mesh_where(mesh))
    rules = SH.train_rules(mesh)
    C.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    st = mt_init(cfg, DEV, rules)
    torch.cuda.empty_cache()
    step = TS.make_train_step(cfg, rules=rules)
    steps = []
    for i in range(MT_STEPS):
        b = mt_batch(cfg, i, DEV)
        C.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step(st, b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        no_staged(f"rules step {i}")
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        if not (np.isfinite(loss) and np.isfinite(gn)):
            raise AssertionError(f"rules step {i}: loss {loss}, grad norm "
                                 f"{gn}")
        steps.append(dict(loss=loss, grad_norm=gn, seconds=dt,
                          collectives=C.COLLECTIVE_STATS["calls"],
                          by_op={k: dict(v) for k, v in
                                 C.COLLECTIVE_STATS["by_op"].items()}))
    rel0 = abs(steps[0]["loss"] - ref["loss0"]) / abs(ref["loss0"])
    if rel0 > MT_LOSS_TOL:
        raise AssertionError(f"rules step 0 loss {steps[0]['loss']} vs one "
                             f"device {ref['loss0']}")
    out["rules"] = dict(steps=steps, loss0_rel_err=rel0,
                        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                        local_params=sum(p.numel() for p in
                                         nn.tree_leaves(st.params)))

    # its f32 twin at smoke size, card against CPU on the same ranks
    sc = mt_config(2, smoke=True)
    cpu_mesh = make_mesh(MT_RULES_SHAPE, ("data", "model"), "cpu")
    cpu_rules = SH.train_rules(cpu_mesh)
    cs = TS.init_state(sc, torch.Generator().manual_seed(SEED), "cpu",
                       rules=cpu_rules)
    to_dev = lambda t: t.detach().to(DEV, copy=True)
    gs = TS.TrainState(nn.tree_map(to_dev, cs.params), OPT.OptState(
        nn.tree_map(to_dev, cs.opt.m), nn.tree_map(to_dev, cs.opt.v),
        to_dev(cs.opt.count)), to_dev(cs.step))
    f32_loss = 0.0
    for i in range(2):
        bc = mt_batch(sc, i, "cpu", batch=4, seq=16)
        C.set_mesh(cpu_mesh)
        cs, mc = TS.make_train_step(sc, rules=cpu_rules)(cs, bc)
        C.set_mesh(mesh)
        gs, mg = TS.make_train_step(sc, rules=rules)(
            gs, {k: v.to(DEV) for k, v in bc.items()})
        f32_loss = max(f32_loss, rel_err(mg["loss"], mc["loss"]))
    f32_params = max(rel_err(a, b) for a, b in zip(
        nn.tree_leaves(gs.params), nn.tree_leaves(cs.params)))
    if max(f32_loss, f32_params) > TRAIN_F32_TOL:
        raise AssertionError(f"rules f32 twin: card vs CPU loss {f32_loss}, "
                             f"params {f32_params}")
    out["rules"]["f32_card_vs_cpu"] = dict(loss=f32_loss, params=f32_params)
    del cs, gs

    # (c) elastic restore onto (data 4, model 1)
    t0 = time.perf_counter()
    CKPT.save(ckpt_dir, MT_STEPS, st, TS.state_axes(cfg), rules=rules,
              specs=TS.state_specs(cfg, rules))
    save_s = time.perf_counter() - t0
    del st, step
    torch.cuda.empty_cache()
    mesh2 = make_mesh(MT_ELASTIC_SHAPE, ("data", "model"), DEV)
    rules2 = SH.train_rules(mesh2)
    shapes = TS.param_shapes(cfg)
    meta = torch.zeros((), dtype=torch.int32, device="meta")
    tmpl = TS.TrainState(shapes, OPT.OptState(shapes, shapes, meta), meta)
    t0 = time.perf_counter()
    st2, at = CKPT.restore(ckpt_dir, tmpl, rules=rules2)
    restore_s = time.perf_counter() - t0
    with open(os.path.join(ckpt_dir, f"step_{at:08d}", "manifest.json")) \
            as f:
        manifest = json.load(f)
    bad = []
    for key, leaf in CKPT._flatten(st2).items():
        entry = manifest["leaves"][key]
        arr = np.load(os.path.join(ckpt_dir, f"step_{at:08d}",
                                   entry["file"]), mmap_mode="r")
        spec = rules2.spec(tuple(entry["logical_axes"]), arr.shape)
        piece = CKPT._from_numpy(np.array(arr[SH.shard_slices(
            spec, arr.shape, mesh2)]), entry["dtype"])
        if leaf.device.type != torch.device(DEV).type or \
                not torch.equal(leaf.cpu(), piece):
            bad.append(key)
    if bad or at != MT_STEPS:
        raise AssertionError(f"elastic restore: step {at}, leaves {bad} "
                             f"differ from their cut of the saved arrays")
    st2, m2 = TS.make_train_step(cfg, rules=rules2)(
        st2, mt_batch(cfg, MT_STEPS, DEV))
    if not np.isfinite(float(m2["loss"])):
        raise AssertionError(f"elastic restore: loss {float(m2['loss'])}")
    out["elastic"] = dict(step=at, leaves=len(manifest["leaves"]),
                          bitwise=True, save_s=save_s, restore_s=restore_s,
                          next_loss=float(m2["loss"]))
    del st2
    torch.cuda.empty_cache()

    # (d) GPipe on (pod 4): one full-width block a stage
    mesh3 = make_mesh((MT_PIPE_LAYERS,), ("pod",), DEV)
    pcfg = mt_config(MT_PIPE_LAYERS)
    sl = PL.stage_layers(pcfg, mesh3)
    w = pipe_blocks(pcfg, range(sl.start, sl.stop), DEV)
    fwd = PL.make_pipelined_forward(pcfg, mesh3, pipe_apply(pcfg),
                                    microbatches=MT_PIPE_M)
    no_staged("the f32 twin, the save, the restore and its step")
    C.reset_stats()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fwd(w, pipe_input(pcfg, DEV))
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
    pipe_coll = {k: dict(v) for k, v in C.COLLECTIVE_STATS["by_op"].items()}
    rel = rel_err(y, ref["pipe_y"])
    if not rel <= LOGITS_REL_TOL:
        raise AssertionError(f"pipeline: {rel} from the sequential forward")
    del w, y
    scfg = mt_config(MT_PIPE_LAYERS, smoke=True)
    ws = pipe_blocks(scfg, range(MT_PIPE_LAYERS), DEV)
    xs = pipe_input(scfg, DEV, batch=8, seq=16)
    with torch.no_grad():
        seq = pipe_apply(scfg)(ws, xs)
        got = PL.make_pipelined_forward(
            scfg, mesh3, pipe_apply(scfg), microbatches=MT_PIPE_M)(
            nn.tree_map(lambda t: t[sl], ws), xs)
    f32_err = float(((got - seq).abs() - PIPE_F32_TOL * seq.abs()).max())
    if f32_err > PIPE_F32_TOL:
        raise AssertionError(f"pipeline f32 twin: {f32_err} beyond atol "
                             f"{PIPE_F32_TOL} + rtol |y|")
    no_staged("the pipeline")
    out["pipeline"] = dict(rel_err=rel, seconds=pipe_s, collectives=pipe_coll,
                           f32_excess_over_rtol=f32_err,
                           bubble=PL.bubble_fraction(MT_PIPE_M,
                                                     MT_PIPE_LAYERS))
    return out


def phase_mesh_train() -> dict:
    """Phase 15 (module docstring).  Returns the kernels' launches (none:
    training and the pipeline reach no TPU kernel in the reference)."""
    import tempfile
    import torch
    from repro_torch.launch.mesh import run_spmd
    wrappers = zero_launches()
    t_phase = time.perf_counter()
    ref = mt_reference()
    ref_s = time.perf_counter() - t_phase
    free, _ = torch.cuda.mem_get_info()
    est = 16 * ref["n_params"] + 3 * 4 * ref["biggest"] + 2 ** 30
    four = 4 * est <= min(MT_MEM_CAP_GIB * 2 ** 30, free)
    pod_shape = (2, 2, 1) if four else (2, 1, 1)
    t0 = time.perf_counter()
    pod = run_spmd(mt_pod_rank, pod_shape[0] * pod_shape[1],
                   (pod_shape, ref), device=DEV, timeout_s=MT_TIMEOUT_S)
    pod_s = time.perf_counter() - t0
    for i in range(MT_STEPS):
        digests = {str(o["steps"][i]["digest"]) for o in pod}
        if len(digests) != 1:
            raise AssertionError(f"manual pod step {i}: the ranks' params "
                                 f"differ")
    rel0 = abs(pod[0]["steps"][0]["loss"] - ref["loss0"]) / abs(ref["loss0"])
    if rel0 > MT_LOSS_TOL:
        raise AssertionError(f"manual pod step 0 loss "
                             f"{pod[0]['steps'][0]['loss']} vs one device "
                             f"{ref['loss0']}")
    emit("mesh_train_pod", card=nvidia_smi(), arch=MT_ARCH,
         placement=pod[0]["placement"], transport=pod[0]["transport"],
         cards_by_rank=[o["card"] for o in pod], staged=0,
         layers=MT_LAYERS, params=ref["n_params"],
         mesh=dict(zip(("pod", "data", "model"), pod_shape)),
         four_ranks_fit=four, est_rank_peak_gib=est / 2 ** 30,
         free_gib=free / 2 ** 30, batch=MT_BATCH, seq=MT_SEQ,
         one_device_loss0=ref["loss0"], loss0_rel_err=rel0,
         params_equal_across_ranks_every_step=True,
         steps=[{k: v for k, v in s.items() if k != "digest"}
                for s in pod[0]["steps"]],
         peak_gib_by_rank=[o["peak_gib"] for o in pod], seconds=pod_s)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        outs = run_spmd(mt_rules_rank, 4, (ref, d), device=DEV,
                        timeout_s=MT_TIMEOUT_S)
        rules_s = time.perf_counter() - t0
    r0 = outs[0]
    emit("mesh_train_rules", card=nvidia_smi(), arch=MT_ARCH,
         placement=r0["placement"], transport=r0["transport"],
         cards_by_rank=[o["card"] for o in outs], staged=0,
         layers=MT_LAYERS, mesh=dict(zip(("data", "model"), MT_RULES_SHAPE)),
         batch=MT_BATCH, seq=MT_SEQ, one_device_loss0=ref["loss0"],
         **{k: v for k, v in r0["rules"].items()},
         peak_gib_by_rank=[o["rules"]["peak_gib"] for o in outs],
         by_op_by_rank=[o["rules"]["steps"][-1]["by_op"] for o in outs])
    emit("mesh_train_elastic", mesh_from=dict(zip(("data", "model"),
                                                  MT_RULES_SHAPE)),
         mesh_to=dict(zip(("data", "model"), MT_ELASTIC_SHAPE)),
         by_rank=[o["elastic"] for o in outs])
    emit("mesh_train_pipeline", mesh={"pod": MT_PIPE_LAYERS},
         layers=MT_PIPE_LAYERS, microbatches=MT_PIPE_M,
         x=[MT_BATCH, MT_SEQ, mt_config().d_model], **r0["pipeline"])
    launches = no_launches(wrappers, "mesh_train")
    emit("mesh_train_done", seconds=time.perf_counter() - t_phase,
         reference_seconds=ref_s, pod_seconds=pod_s, rules_seconds=rules_s,
         launches=launches)
    return launches


def zero_launches() -> dict:
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def no_launches(wrappers, phase: str) -> dict:
    """The launches since ``zero_launches``; raises unless none (the phase's
    path has no TPU kernel in the reference)."""
    launches = {k: w.launches for k, w in wrappers.items()}
    if any(launches.values()):
        raise AssertionError(f"phase {phase} launched {launches}")
    return launches


def sim_states_equal(a, b) -> bool:
    import torch
    flat = lambda st: [getattr(st, f) for f in st._fields if f != "regs"] \
        + list(st.regs)
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(flat(a),
                                                              flat(b)))


def phase_simulator() -> dict:
    """The paper's simulator in both modes (see the module docstring,
    phase 11).  Returns the kernels' launches (none)."""
    import numpy as np
    import torch
    from repro_torch.core import schedulers as SCH
    from repro_torch.core import simulator as SIM
    from repro_torch.core.linearizability import check_history
    from repro_torch.core.spec import OP_NONE, RET_PENDING
    from repro_torch.device import SYNC_STATS
    wrappers = zero_launches()
    rng = np.random.default_rng(SEED + 23)

    def run(mode, wl, m, sched, dev, check_inv):
        """(state, seconds, active events, host syncs) of one run."""
        syncs = SYNC_STATS["host_syncs"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim = SIM.Simulation(mode, m, SEED, wl.op, wl.key,
                             check_inv=check_inv, device=dev)
        sim.run(sched)
        st = sim.state()
        torch.cuda.synchronize()
        return (st, time.perf_counter() - t0, sim.active_events,
                SYNC_STATS["host_syncs"] - syncs)

    for mode in (SIM.MODE_LLSC, SIM.MODE_CAS):
        c = SIM_CONCURRENT
        cases = []
        for kind in ("uniform", "bursty", "stalled", "rr"):
            wl = SCH.random_workload(rng, P=c["P"], K=c["K"], num_keys=5)
            sched = {"uniform": lambda: SCH.uniform_schedule(rng, c["P"],
                                                             c["T"]),
                     "bursty": lambda: SCH.bursty_schedule(rng, c["P"],
                                                           c["T"]),
                     "stalled": lambda: SCH.stalled_schedule(rng, c["P"],
                                                             c["T"]),
                     "rr": lambda: SCH.round_robin_schedule(c["P"],
                                                            c["T"])}[kind]()
            cases.append((kind, wl, c["m"], sched))
        c = SIM_SAME_KEY
        cases.append(("same_key", SCH.same_key_workload(
            c["P"], c["K"], key=5, pattern="insert_delete"), c["m"],
            SCH.uniform_schedule(rng, c["P"], c["T"])))
        cost = {"card": [0.0, 0], "cpu": [0.0, 0]}
        for name, wl, m, sched in cases:
            card, dt_g, act_g, _ = run(mode, wl, m, sched, DEV, True)
            cpu, dt_c, act_c, _ = run(mode, wl, m, sched, "cpu", True)
            cost["card"][0] += dt_g
            cost["card"][1] += act_g
            cost["cpu"][0] += dt_c
            cost["cpu"][1] += act_c
            if not sim_states_equal(card, cpu):
                raise AssertionError(f"simulator {mode} {name}: card and CPU "
                                     f"states differ")
            if not (bool(card.pair_ok) and bool(card.inv_ok)):
                raise AssertionError(f"simulator {mode} {name}: pair_ok "
                                     f"{bool(card.pair_ok)}, inv_ok "
                                     f"{bool(card.inv_ok)}")
            ok, bad = check_history(SIM.history_arrays(card, wl))
            if not ok:
                raise AssertionError(f"simulator {mode} {name}: keys {bad} "
                                     f"not linearizable")

        # Theorem 21's load shape (bench_steps.sweep_load at x = 4)
        m, P, x = SIM_LOAD["m"], SIM_LOAD["P"], SIM_LOAD["x"]
        n_ins = int((1 - 1 / x) * m)
        K = -(-n_ins // P)
        wl = SCH.insert_only_distinct(P, K)
        wl.key[:, :] = rng.choice(2 ** 27, size=(P, K),
                                  replace=False).astype(np.uint32)
        wl.op[np.arange(P * K).reshape(P, K) >= n_ins] = OP_NONE
        T = 400 * P * K
        sched = SCH.uniform_schedule(rng, P, T)
        st, dt, active, syncs = run(mode, wl, m, sched, DEV, False)
        cpu, dt_c, _, _ = run(mode, wl, m, sched, "cpu", False)
        res, steps = st.results.cpu().numpy(), st.steps.cpu().numpy()
        if not ((res != RET_PENDING) | (wl.op == OP_NONE)).all():
            raise AssertionError(f"simulator {mode}: ops left unfinished")
        if not (bool(st.pair_ok)
                and bool(SIM.check_invariants(st.table, m, SEED))
                and sim_states_equal(st, cpu)):
            raise AssertionError(f"simulator {mode}: the load run broke "
                                 f"pairing or the invariants, or the card "
                                 f"and the CPU disagree")
        done = (wl.op != OP_NONE) & (res != RET_PENDING)
        emit("simulator", mode=mode, bitwise_cases=[c[0] for c in cases],
             bitwise_equal=True,
             card_ms_per_active_event=cost["card"][0] / cost["card"][1] * 1e3,
             cpu_ms_per_active_event=cost["cpu"][0] / cost["cpu"][1] * 1e3,
             active_events_checked=cost["card"][1],
             load=dict(m=m, P=P, K=K, x=x, load=n_ins / m, ops=n_ins,
                       events=T, active_events=active, seconds=dt,
                       cpu_seconds=dt_c, events_per_s=T / dt,
                       active_events_per_s=active / dt,
                       card_ms_per_active_event=dt / active * 1e3,
                       cpu_ms_per_active_event=dt_c / active * 1e3,
                       host_syncs=syncs, host_syncs_per_event=syncs / T,
                       host_syncs_per_active_event=syncs / active,
                       mean_steps=float(steps[done].mean()),
                       knuth=0.5 * (1 + x * x)))
    return no_launches(wrappers, "simulator")


def train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x (matmul parameters) x tokens
    (forward 2 and backward 4 per parameter per token: the attention and
    MLP projections with the padded heads as run, and the untied head; the
    embedding lookup is no product), plus the attention products q.k and
    p.v over the full S x S square of every head, forward and backward (12
    L B S^2 n_q hd).  Remat's recomputation is not counted."""
    d, hd = cfg.d_model, cfg.hd
    per_layer = 2 * d * cfg.n_q * hd + 2 * d * cfg.n_kv * hd \
        + 3 * d * cfg.d_ff
    n = cfg.num_layers * per_layer + d * cfg.vocab_size
    attn = 12 * cfg.num_layers * batch * seq * seq * cfg.n_q * hd
    return 6.0 * n * batch * seq + attn


def rel_err(a, b) -> float:
    """||a - b|| / ||b|| in float64 on the host."""
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def phase_train() -> dict:
    """Single-device training (see the module docstring, phase 12).
    Returns the kernels' launches (none)."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.train import TrainRunner
    from repro_torch.models import nn
    from repro_torch.training import data as DATA
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_step as TS
    wrappers = zero_launches()
    t_phase = time.perf_counter()

    cfg = dataclasses.replace(get_config(ARCH), num_layers=TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runner = TrainRunner(cfg, dedup=True, device=DEV)
    state, losses = runner.run(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                               steps=TRAIN_STEPS, seed=SEED, log_every=1)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = sum(p.numel() for p in nn.tree_leaves(state.params))
    hist, step_s = runner.history, runner.step_seconds
    dedup_live = int(runner.dedup.table.num_keys)
    del state, runner
    torch.cuda.empty_cache()
    want_lr = [float(OPT.schedule(OPT.AdamWConfig(), torch.tensor(i + 1)))
               for i in range(TRAIN_STEPS)]
    if len(hist) != TRAIN_STEPS or not all(
            np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
            for h in hist):
        raise AssertionError(f"train: non-finite or missing steps {hist}")
    lr_err = max(abs(h["lr"] - w) / w for h, w in zip(hist, want_lr))
    if lr_err > 1e-6:
        raise AssertionError(f"train: lr {[h['lr'] for h in hist]} off the "
                             f"schedule {want_lr}")
    s_per_step = float(np.median(step_s[1:]))
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)

    # a batch fed twice to the dedup table on the card
    dd = DATA.DedupState(device=DEV)
    b = DATA.synth_batch(cfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, step=0,
                         seed=SEED, device=DEV)
    keep1, _ = dd.filter_batch(b["tokens"])
    keep2, frac2 = dd.filter_batch(b["tokens"])
    if not bool(keep1.all()) or bool(keep2.any()):
        raise AssertionError(f"train: dedup kept {keep1.tolist()} then "
                             f"{keep2.tolist()}")

    # the smoke config in float32: the card's 2 steps against the CPU's
    sc = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    cpu = TS.init_state(sc, torch.Generator().manual_seed(SEED), "cpu")
    to_dev = lambda t: t.detach().to(DEV, copy=True)
    card = TS.TrainState(nn.tree_map(to_dev, cpu.params), OPT.OptState(
        nn.tree_map(to_dev, cpu.opt.m), nn.tree_map(to_dev, cpu.opt.v),
        to_dev(cpu.opt.count)), to_dev(cpu.step))
    step_fn = TS.make_train_step(sc)
    f32_loss_err = 0.0
    for i in range(2):
        bc = DATA.synth_batch(sc, batch=2, seq_len=32, step=i, seed=SEED,
                              device="cpu")
        cpu, mc = step_fn(cpu, bc)
        card, mg = step_fn(card, {k: v.to(DEV) for k, v in bc.items()})
        f32_loss_err = max(f32_loss_err, rel_err(mg["loss"], mc["loss"]))
    f32_param_err = max(rel_err(a, b) for a, b in zip(
        nn.tree_leaves(card.params), nn.tree_leaves(cpu.params)))
    if max(f32_loss_err, f32_param_err) > TRAIN_F32_TOL:
        raise AssertionError(f"train: f32 card vs CPU loss {f32_loss_err}, "
                             f"params {f32_param_err}")

    # restart determinism through TrainRunner's checkpoint
    rc = get_smoke_config("codeqwen1.5-7b")
    kw = dict(batch=2, seq_len=16, seed=SEED, log_every=TRAIN_STEPS)
    _, full = TrainRunner(rc, device=DEV).run(steps=6, **kw)
    with tempfile.TemporaryDirectory() as d:
        _, first = TrainRunner(rc, ckpt_dir=d, ckpt_every=3,
                               device=DEV).run(steps=3, **kw)
        _, second = TrainRunner(rc, ckpt_dir=d, device=DEV).run(steps=6,
                                                                 **kw)
    restart_err = max(abs(a - b) / abs(b) for a, b in zip(first + second,
                                                           full))
    if len(first + second) != 6 or restart_err > TRAIN_RESTART_TOL:
        raise AssertionError(f"train: restart losses {first + second} vs "
                             f"{full}")

    launches = no_launches(wrappers, "train")
    emit("train", card=nvidia_smi(), arch=ARCH, layers=TRAIN_LAYERS,
         params=n_params,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
         losses=[h["loss"] for h in hist],
         grad_norms=[h["grad_norm"] for h in hist],
         lrs=[h["lr"] for h in hist], lr_max_rel_err=lr_err,
         step_seconds=step_s, seconds_per_step=s_per_step,
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / s_per_step,
         peak_gib=peak_gib, model_flops=flops,
         model_flops_share=flops / s_per_step / H100_BF16_FLOPS,
         flops_formula="6 * matmul params * tokens + 12 L B S^2 n_q hd, "
                       "over 989e12 FLOP/s (H100 SXM dense bf16)",
         dedup_live_keys=dedup_live, dedup_second_dup_frac=float(frac2),
         f32_card_vs_cpu=dict(loss=f32_loss_err, params=f32_param_err),
         restart_max_rel_err=restart_err, launches=launches,
         phase_seconds=time.perf_counter() - t_phase)
    return launches


def mamba_state_entry(errs, by_strategy, checks) -> dict:
    """The mamba state kernel's kernels-line entry at one
    granite-4.0-h-small mamba layer at its decode cell's 256 lanes (G 1,
    Hg 128, P 64, N 128, bf16 activations; 1.07 GB of float32 ``h``):
    held to its plain version with every other lane frozen (in float32
    activations, whose error is reported, and in bf16), then, every lane
    kept, timed beside its byte bound (``h`` read and written once,
    the bytes from ``KERNEL_STATS["ssm_state_bytes"]``), the plain
    version, a copy of ``h``'s size (the card's practical stream rate)
    and its eager per-call time."""
    import torch
    from repro_torch.kernels import stats as KS
    from repro_torch.kernels.mamba_state import (mamba_state_kernel,
                                                 mamba_state_plain)
    B, G, Hg, P, N = 256, 1, 128, 64, 128
    g = torch.Generator(device=DEV).manual_seed(SEED + 19)
    h = torch.randn((B, G, Hg, P, N), generator=g, device=DEV)
    mixed = torch.ones(B, dtype=torch.bool, device=DEV)
    mixed[1::2] = False
    errs["MS"] = max(errs["MS"], check_mamba_state(mamba_state_inputs(
        h, torch.float32, SEED + 19, mixed)))
    check_mamba_state(mamba_state_inputs(h, torch.bfloat16, SEED + 19,
                                         mixed))
    args = mamba_state_inputs(h, torch.bfloat16, SEED + 19,
                              torch.ones_like(mixed))
    with KS.kernel_stats_scope() as stats:
        mamba_state_kernel(*args)
        nbytes = stats["ssm_state_bytes"]
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    ms = graph_ms(lambda: mamba_state_kernel(*args), 20)
    other = torch.empty_like(h)
    copy_ms = graph_ms(lambda: other.copy_(h), 20)
    del other
    launches = by_strategy["linear"]
    return {"name": "mamba_state", "route": "cuda",
            "source": "src/repro_torch/csrc/mamba_state.cu",
            "replaces": None,
            "launches": launches["MS"],
            "launches_by_strategy": {s: n["MS"]
                                     for s, n in by_strategy.items()},
            "check_launches": checks["MS"],
            "B": B, "G": G, "Hg": Hg, "P": P, "N": N, "bytes": nbytes,
            "ms": ms, "bound_ms": bound, "bound_by": "bytes",
            "bound_share": bound / ms,
            "plain_ms": graph_ms(lambda: mamba_state_plain(*args), 4),
            "copy_ms": copy_ms, "copy_bound_share": bound / copy_ms,
            "library_ms": None,
            "eager_ms": cuda_ms(lambda: mamba_state_kernel(*args), 20)}


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
        mamba_state_entry(errs, by_strategy, checks),
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

    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "MS": 0.0}
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
                    "K3": 0 if strategy == "hopscotch" else 1, "MS": 0}
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
    by_family, k1_shapes, ms_shapes = phase_families(cfg, params, checks)
    kernels[0]["launches_by_family"] = {
        run: n["K1"] for run, n in by_family.items()}
    kernels[0]["family_shapes"] = k1_shapes
    errs["K1"] = max([errs["K1"]] + [e["max_abs_err"] for e in k1_shapes])
    kernels[0]["max_abs_err"] = errs["K1"]
    kernels[3]["launches_by_family"] = {
        run: n["MS"] for run, n in by_family.items()}
    kernels[3]["family_shapes"] = ms_shapes
    errs["MS"] = max([errs["MS"]] + [e["max_rel_err"] for e in ms_shapes])
    kernels[3]["max_rel_err"] = errs["MS"]
    kernels[3]["check_launches"] = checks["MS"]
    phase_sharded()
    phase_profile(cfg, params)
    del params
    torch.cuda.empty_cache()
    phase_collectives()
    mesh = phase_mesh()
    for e, key in zip(kernels, ("K1", "K2", "K3", "MS")):
        e["launches_by_mesh"] = {t: n[key]
                                 for t, n in mesh["launches"].items()}
    kernels[0]["mesh_shapes"] = mesh["rows"]
    errs["K1"] = max([errs["K1"]] + [r["max_abs_err"] for r in mesh["rows"]])
    kernels[0]["max_abs_err"] = errs["K1"]
    by_phase = {"simulator": phase_simulator(), "train": phase_train(),
                "mesh_train": phase_mesh_train()}
    for e in kernels:
        key = {"fused_decode": "K1", "paged_attention": "K2",
               "probe_lookup": "K3", "mamba_state": "MS"}[e["name"]]
        e["launches_by_phase"] = {ph: n[key] for ph, n in by_phase.items()}
    emit("done", seconds=time.time() - t0)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
