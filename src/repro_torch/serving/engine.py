"""Decode engine (PyTorch port of ``serving/engine.py``: every model
family — dense, moe and vlm with gemma3's local/global pattern, ssm,
hybrid and encdec — with bf16 or int8 KV pools, one device, no mesh).

Each decode token the engine (``_serve_step_impl``):
1. allocates pages at page-boundary crossings through the hash table and
   reads the rest from the incremental block table
   (``PageTable.alloc_step_incremental``);
2. per paged (global) layer, computes q/k/v with RoPE (M-RoPE for the vlm
   family), writes the token's K/V into its page (``paged.write_token_kv``;
   int8 pools with bf16 scales when ``cfg.kv_cache_dtype == "int8"``) and
   attends over the paged KV — with ``cfg.fused_kernel=True`` through the
   fused kernel K1 (``kernels/fused_decode``), which walks the raw block
   table, otherwise through the plain ``paged.attend_local`` over
   compacted pages;
3. per gemma3 local layer, writes the token's K/V into the lane's ring of
   ``local_window`` slots and attends over it (``_ring_attn``, plain
   PyTorch as in the reference), then advances ``ring_pos`` once after all
   layers;
4. finishes each block (SwiGLU MLP, or the MoE for the moe family) and
   returns the logits.

The other families follow the reference's branches: ``ssm`` (mamba2) has
no page table and runs its mamba layers' one-token recurrence; ``hybrid``
(zamba2) runs each group of mamba layers and then the shared attention
block, each invocation over its own pool (K1 with ``fused_kernel``);
``encdec`` (seamless) attends over its paged self-attention KV through the
plain ``attend_local`` (the reference does not wire it to the fused
kernel; ``fallback_report`` says so) and over the encoder's cross K/V
(``prepare_encdec_state``).  A refused or inactive lane's mamba state is
frozen (``_freeze_lanes``): the recurrence is not idempotent.

``make_serve_megastep`` runs K tokens with greedy sampling in one call (the
reference's ``lax.scan`` becomes a Python loop), with the same teacher
forcing (``forced``/``forced_mask``), abort latch and ``stop_len`` latch.
K1 or its plain version is chosen by the wrapper from the tensors' device.

In place: the KV pools, their int8 scales and the ring buffers in the
state are updated in place by every step (a step writes one token per
lane; a functional copy would cost the whole pool).  Table, block table,
``ring_pos``, the mamba state and the other leaves are new tensors.  A
caller that needs the state before a step keeps a ``clone_state`` of it.

Not ported here: a mesh (``rules``; ROADMAP item 22); it raises.
"""
from __future__ import annotations

import logging
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import batched as BT
from repro_torch.device import host_bool, resolve_device
from repro_torch.kernels.fused_decode.fused import fused_decode_kernel
from repro_torch.models import encdec
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import moe as MOE
from repro_torch.models import nn
from repro_torch.models import registry
from repro_torch.models import ssm
from repro_torch.obs import counters as OC
from repro_torch.serving import page_table as PT
from repro_torch.serving import paged

DEFAULT_PAGE_SIZE = 256

logger = logging.getLogger(__name__)


def _check_engine(cfg, rules) -> None:
    if rules is not None:
        raise NotImplementedError(
            "decode over a mesh (rules) is not ported: ROADMAP item 22")
    registry.check_supported(cfg)


# ---------------------------------------------------------------------------
# Fallback reasons — the same strings as the reference.

def _fused_kernel_reason(cfg, rules=None) -> Optional[str]:
    """Why decode attention does NOT run as the fused kernel K1 — None when
    it does."""
    if not cfg.fused_kernel:
        return "off (cfg.fused_kernel=False)"
    if cfg.family == "ssm":
        return "attention-free SSM stack: no paged decode attention"
    if cfg.family == "encdec":
        return "cross-attention decode state not wired to the fused kernel"
    return None


def _fused_kernel_ok(cfg, rules=None) -> bool:
    return _fused_kernel_reason(cfg, rules) is None


def _probe_strategy_reason(cfg, rules=None) -> Optional[str]:
    """Why ``cfg.probe_strategy`` runs without the probe kernel — None when
    fully served.  The strategy itself always runs; only the bulk
    block-table rebuild degrades to the strategy's ``find_batch``.  The
    string is the reference's, word for word."""
    from repro_torch.core.probe_strategies import get_strategy
    impl = get_strategy(cfg.probe_strategy)  # raises on unknown names
    if not impl.kernel_supported:
        return ("Pallas probe kernel assumes the linear probe order: bulk "
                "block-table rebuilds serve from the jnp oracle")
    return None


def _pt(cfg) -> PT.PageTable:
    return PT.for_strategy(cfg.probe_strategy)


def fallback_report(cfg, rules=None) -> Dict[str, str]:
    """Every gated fast-path fallback in one structure (``"ok"`` or the
    reason)."""
    strat_reason = _probe_strategy_reason(cfg, rules)
    return {
        "decode_tp": "ok",
        "fused_kernel": ("ok" if _fused_kernel_ok(cfg, rules)
                         else _fused_kernel_reason(cfg, rules)),
        "probe_strategy": (f"{cfg.probe_strategy}: ok"
                           if strat_reason is None
                           else f"{cfg.probe_strategy}: {strat_reason}"),
    }


# ---------------------------------------------------------------------------
# State construction.

def plan_pages(cfg, B: int, S_max: int, page_size: int, n_chips: int = 1):
    max_pages = -(-S_max // page_size)
    n_pages = paged.round_pages(int(B * max_pages * 1.25) + n_chips,
                                n_chips)
    return max_pages, n_pages


def _n_attn_layers(cfg) -> Tuple[int, int]:
    """(paged/global attention layers, ring/local attention layers)."""
    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "hybrid":
        return HY.num_shared_invocations(cfg), 0
    if cfg.pattern_local:
        g = cfg.pattern_local + 1
        return cfg.num_layers // g, cfg.num_layers - cfg.num_layers // g
    return cfg.num_layers, 0


def make_decode_state(cfg, B: int, S_max: int, *, rules=None,
                      page_size: int = DEFAULT_PAGE_SIZE,
                      n_pages: Optional[int] = None,
                      device=None) -> Tuple[Dict[str, Any], None]:
    """Decode state for B lanes on ``device`` (the card unless ``"cpu"``).
    ``n_pages`` overrides the worst-case pool plan (``plan_pages``: 1.25x
    of B·max_pages) to overcommit it.  The page table, block table and
    pools exist only when the family has paged layers (not for ``ssm``);
    the ssm and hybrid families carry their mamba state stacked
    ``[L, B, ...]`` (``ssm``), encdec its cross K/V ``[L, B, S_src, kv,
    hd]`` with ``S_src = max(S_max // 8, 1)``.  Returns (state, None): the
    second item stands where the reference returns sharding axes."""
    _check_engine(cfg, rules)
    dev = resolve_device(device)
    if n_pages is None:
        maxP, n_pages = plan_pages(cfg, B, S_max, page_size)
    else:
        maxP = -(-S_max // page_size)
        n_pages = paged.round_pages(int(n_pages), 1)
    n_paged, n_ring = _n_attn_layers(cfg)
    dtype = cfg.activation_dtype()
    int8 = cfg.kv_cache_dtype == "int8"
    i32 = dict(dtype=torch.int32, device=dev)
    state: Dict[str, Any] = {
        "pos": torch.zeros((B,), **i32),
        "seq_ids": torch.arange(B, **i32),
        "active": torch.ones((B,), dtype=torch.bool, device=dev),
        "aborted": torch.zeros((B,), dtype=torch.bool, device=dev),
    }
    if n_paged:
        state["table"] = _pt(cfg).create_table(n_pages, device=dev)
        state["block_table"] = torch.full((B, maxP), -1, **i32)
        state["pools"] = paged.make_pools(n_paged, n_pages, page_size,
                                          cfg.n_kv, cfg.hd,
                                          torch.int8 if int8 else dtype,
                                          device=dev)
        if int8:
            state["pool_scales"] = paged.make_pool_scales(
                n_paged, n_pages, page_size, cfg.n_kv, device=dev)
    if n_ring:
        shp = (n_ring, B, cfg.local_window, cfg.n_kv, cfg.hd)
        state["ring_k"] = torch.zeros(shp, dtype=dtype, device=dev)
        state["ring_v"] = torch.zeros(shp, dtype=dtype, device=dev)
        state["ring_pos"] = torch.full((B, cfg.local_window), -1, **i32)
    if cfg.family in ("ssm", "hybrid"):
        one = ssm.init_mamba_state(cfg, B, dtype, dev)
        state["ssm"] = ssm.MambaState(*(
            t[None].repeat((cfg.num_layers,) + (1,) * t.dim())
            for t in one))
    if cfg.family == "encdec":
        shp = (cfg.num_layers, B, max(S_max // 8, 1), cfg.n_kv, cfg.hd)
        state["cross_k"] = torch.zeros(shp, dtype=dtype, device=dev)
        state["cross_v"] = torch.zeros(shp, dtype=dtype, device=dev)
    if getattr(cfg, "telemetry", False):
        state["counters"] = OC.Counters.zeros(device=dev)
    return state, None


def clone_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """Deep copy of a decode state (tensors cloned)."""
    def cp(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple):
            return type(x)(*(cp(t) for t in x))
        return x
    return {k: cp(v) for k, v in state.items()}


def rebuild_page_table(state: Dict[str, Any], *,
                       n_pages: Optional[int] = None,
                       seed: Optional[int] = None,
                       use_kernel: bool = False,
                       strategy: str = "linear") -> Dict[str, Any]:
    """Section 4.3 ABORT recovery: re-hash the page table into ``n_pages``
    cells and MOVE the physical KV pages to their keys' new slots (the cell
    index IS the page), under ``strategy`` (the one the state was built
    with).  Rebuilds the block-table cache from the fresh table — through
    the probe kernel K3 when ``use_kernel`` and the strategy probes in
    linear order — and clears ``aborted``.  int8 scales move with their
    pages; the per-lane leaves (rings, mamba state, cross K/V) stay as
    they are.  Returns a new state; the given one is left as it was."""
    table = state["table"]
    pt = PT.for_strategy(strategy)
    # hopscotch carries a meta bitmap, linear and robinhood none: rebuilding
    # with the wrong strategy would corrupt the table
    if (table.meta.numel() > 0) != (
            pt.create_table(1, device=table.table.device).meta.numel() > 0):
        raise ValueError(
            f"rebuild_page_table: state's table metadata does not match "
            f"strategy {strategy!r} — pass the strategy the state was "
            f"built with (cfg.probe_strategy)")
    m = BT.size(table)
    new_m = m if n_pages is None else n_pages
    fresh, old_slots, new_slots, live = pt.rehash(table, new_m, seed)
    lost = live & (new_slots < 0)
    if host_bool(lost.any()):
        raise ValueError(
            f"rebuild_page_table: {int(lost.sum())} live pages do not fit "
            f"in n_pages={new_m}")
    idx = torch.nonzero(live).flatten()
    src = old_slots[idx].to(torch.int64)
    dst = new_slots[idx].to(torch.int64)

    def move(pool, fill):
        out = torch.full(pool.shape[:1] + (new_m,) + pool.shape[2:], fill,
                         dtype=pool.dtype, device=pool.device)
        out[:, dst] = pool[:, src]
        return out

    state = dict(state)
    state["table"] = fresh
    state["pools"] = paged.PagedPools(k=move(state["pools"].k, 0),
                                      v=move(state["pools"].v, 0))
    if "pool_scales" in state:
        state["pool_scales"] = paged.PoolScales(
            k=move(state["pool_scales"].k, 1),
            v=move(state["pool_scales"].v, 1))
    state["block_table"] = pt.rebuild_block_table(
        fresh, state["seq_ids"], state["block_table"].shape[1],
        use_kernel=use_kernel)
    state["aborted"] = torch.zeros_like(state["aborted"])
    return state


def decode_headroom(state: Dict[str, Any],
                    strategy: str = "linear") -> Optional[PT.Headroom]:
    """Occupancy/headroom of a decode state's page pool."""
    if "table" not in state:
        return None
    return PT.for_strategy(strategy).headroom(state["table"])


# ---------------------------------------------------------------------------
# The paged attention op.

def _rope_single(cfg, x, positions, mrope=None):
    """x [B,H,hd] one token per seq at ``positions`` [B]; ``mrope``
    [3,B,1] the vlm family's M-RoPE streams."""
    x4 = x[:, None]                                  # [B,1,H,hd]
    if mrope is not None and cfg.mrope_sections:
        out = L.apply_mrope(x4, mrope, cfg.mrope_sections, cfg.rope_theta)
    else:
        out = L.apply_rope(x4, positions[:, None], cfg.rope_theta)
    return out[:, 0]


def paged_attn_op(cfg, x, ap, pool_k_l, pool_v_l, lp, write_slot,
                  positions, page_size: int, *, mrope=None, scales=None,
                  bt=None, fused=False,
                  plan: Optional[paged.WritePlan] = None):
    """x [B,1,d]; one layer's pools [n_pages, PS, kv, hd] (written in
    place, and with int8 pools ``scales`` = (k_scales, v_scales)
    [n_pages, PS, kv] too); ``lp`` the compacted pages (None when
    ``fused``: K1 walks the raw block table ``bt`` instead).  Returns
    attn_out [B,1,d]."""
    B = x.shape[0]
    npr = pool_k_l.shape[0]
    q, k, v = L.attn_qkv_decode(ap, x[:, 0])
    q = _rope_single(cfg, q, positions, mrope)
    k = _rope_single(cfg, k, positions, mrope)
    paged.write_token_kv(pool_k_l, pool_v_l, k, v, write_slot, positions,
                         0, npr, page_size, scales=scales, plan=plan)
    n_kv, G = cfg.n_kv, cfg.n_q // cfg.n_kv
    if fused:
        # one device: the raw block table is already the local one
        o, m, l = fused_decode_kernel(q.contiguous(), pool_k_l, pool_v_l,
                                      bt, positions, scales=scales,
                                      partials=True)
    else:
        qg = q.reshape(B, n_kv, G, cfg.hd)
        o, m, l = paged.attend_local(qg, pool_k_l, pool_v_l, lp, positions,
                                     page_size, scales=scales)
    out = paged.merge_global(o, m, l, ())             # [B,kv,G,hd] f32
    out = out.reshape(B, cfg.n_q, cfg.hd).to(x.dtype)
    return L.attn_out_decode(ap, out)[:, None]


# ---------------------------------------------------------------------------
# Ring-buffer (sliding window) attention for gemma3 local layers.

def _ring_attn(cfg, x, ap, ring_k_l, ring_v_l, ring_pos, positions):
    """x [B,1,d]; one local layer's ring [B,W,kv,hd] (the token's K/V
    written in place at slot ``positions % W``); ring_pos [B,W] the
    absolute position each slot holds (-1 empty), as before this step.
    Attends to the slots with ``pos - W < ring_pos <= pos`` and the current
    slot.  Returns attn_out [B,1,d]."""
    B = x.shape[0]
    W = ring_k_l.shape[1]
    q, k, v = L.attn_qkv_decode(ap, x[:, 0])
    q = _rope_single(cfg, q, positions)
    k = _rope_single(cfg, k, positions)
    lanes = torch.arange(B, device=x.device)
    slot = (positions % W).to(torch.int64)
    ring_k_l[lanes, slot] = k.to(ring_k_l.dtype)
    ring_v_l[lanes, slot] = v.to(ring_v_l.dtype)

    n_kv, G = cfg.n_kv, cfg.n_q // cfg.n_kv
    qg = q.reshape(B, n_kv, G, cfg.hd)
    s = torch.einsum("bkgd,bwkd->bkgw", qg.float(),
                     ring_k_l.float()) / math.sqrt(cfg.hd)
    pos = positions[:, None]
    ok = (ring_pos >= 0) & (ring_pos <= pos) & (ring_pos > pos - W)
    ok[lanes, slot] = True
    s = torch.where(ok[:, None, None, :], s, paged.NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bwkd->bkgd", p, ring_v_l.float())
    o = o.reshape(B, cfg.n_q, cfg.hd).to(x.dtype)
    return L.attn_out_decode(ap, o)[:, None]


# ---------------------------------------------------------------------------
# serve_step factories.

def _warn_fallbacks(cfg, rules) -> None:
    if cfg.fused_kernel and not _fused_kernel_ok(cfg, rules):
        logger.warning("fused decode kernel unavailable for %s — %s; using "
                       "the two-dispatch attend path", cfg.name,
                       _fused_kernel_reason(cfg, rules))
    if _probe_strategy_reason(cfg, rules) is not None:
        logger.warning("probe strategy %s partially degraded for %s — %s",
                       cfg.probe_strategy, cfg.name,
                       _probe_strategy_reason(cfg, rules))


def make_serve_step(cfg, *, S_max: int, rules=None,
                    page_size: int = DEFAULT_PAGE_SIZE):
    """Returns serve_step(params, state, tokens [B,1], positions [B],
    [mrope_positions [3,B,1]]) -> (logits [B,V] f32, state')."""
    _check_engine(cfg, rules)
    _warn_fallbacks(cfg, rules)

    def serve_step(params, state, tokens, positions, mrope_positions=None):
        return _serve_step_impl(cfg, params, state, tokens, positions,
                                mrope_positions, S_max=S_max,
                                page_size=page_size)

    return serve_step


def make_serve_megastep(cfg, *, S_max: int, K: int, rules=None,
                        page_size: int = DEFAULT_PAGE_SIZE):
    """The decode megastep: K tokens per call with greedy sampling between
    them.  Returns ``megastep(params, state, tokens [B,1], stop_len=None,
    forced=None, forced_mask=None) -> (tokens int32[B, K], state')`` with
    the reference's semantics (see ``_mega_scan``).  The function is
    tagged ``.megastep = "loop-K{K}"``."""
    _check_engine(cfg, rules)
    _warn_fallbacks(cfg, rules)

    def megastep(params, state, tokens, stop_len=None, forced=None,
                 forced_mask=None):
        def token_step(st, tok, pos, mrope):
            return _serve_step_impl(cfg, params, st, tok, pos, mrope,
                                    S_max=S_max, page_size=page_size)
        return _mega_scan(cfg, K, token_step, state, tokens, stop_len,
                          forced, forced_mask)

    megastep.megastep = f"loop-K{K}"
    return megastep


def _mega_scan(cfg, K: int, token_step, state, tokens, stop_len,
               forced=None, forced_mask=None):
    """K tokens: token t+1 is the greedy sample of token t's logits, or
    ``forced[:, t]`` where ``forced_mask[:, t]`` (chunked prefill); a lane
    whose allocation ABORTs keeps its refused token pending (the abort
    latch wins over forcing); with ``stop_len`` a lane whose position
    reaches its stop latches ``active=False``.  The vlm family's M-RoPE
    streams are the position itself, on all three.  Returns (tokens
    int32[B, K] — entry k is the token after step k — and the final
    state)."""
    st, tok = state, tokens
    B = tokens.shape[0]
    out = []
    for k in range(K):
        pos = st["pos"]
        mrope = (pos[None, :, None].expand(3, B, 1)
                 if cfg.family == "vlm" else None)
        logits, st2 = token_step(st, tok, pos, mrope)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        if forced is not None:
            nxt = torch.where(forced_mask[:, k, None],
                              forced[:, k, None].to(torch.int32), nxt)
        tok2 = torch.where(st2["aborted"][:, None], tok, nxt)
        if stop_len is not None:
            st2 = dict(st2)
            st2["active"] = st2["active"] & (st2["pos"] < stop_len)
        st, tok = st2, tok2
        out.append(tok2[:, 0])
    return torch.stack(out, dim=1), st


def _page_ops(cfg, state, positions, active, *, S_max, page_size,
              fused=False):
    """Once-per-token page-table work: incremental allocation plus, for the
    plain path, the slots view and the page compaction (K1 walks the raw
    block table instead)."""
    maxP = -(-S_max // page_size)
    (table, write_slot, aborts), bt = _pt(cfg).alloc_step_incremental(
        state["table"], state["seq_ids"], positions, state["block_table"],
        page_size=page_size, active=active)
    if fused:
        return table, write_slot, aborts, bt, None
    slots = PT.PageTable.block_table_slots(bt, positions,
                                           page_size=page_size)
    cap = paged.capacity(positions.shape[0], maxP, 1,
                         factor=cfg.page_capacity_factor)
    lp = paged.compact_local(slots, 0, BT.size(table), cap)
    return table, write_slot, aborts, bt, lp


def _mlp_or_moe(cfg, p, x):
    if cfg.family == "moe":
        y, _ = MOE.moe_apply(p["moe"], x, cfg)
        return y
    return L.mlp_apply(p["mlp"], x)


def _freeze_lanes(new, old, act):
    """Per-lane freeze of refused or inactive lanes: the leaves are
    ``[L, B, ...]`` stacked per-layer state.  A refused token must leave no
    trace — the SSM recurrence is not idempotent under re-issue (unlike
    the KV and ring writes, which rewrite the same slot with the same
    value) — so the engine keeps such lanes' old rows."""
    def sel(n, o):
        return torch.where(act.reshape((1, -1) + (1,) * (n.dim() - 2)), n, o)
    return type(new)(*(sel(n, o) for n, o in zip(new, old)))


# ---------------------------------------------------------------------------
# Cross attention at decode (encdec): dense precomputed memory K/V.

def _cross_attn_decode(cfg, x, cp, ck, cv):
    """x [B,1,d]; one layer's cross K/V [B,S_src,kv,hd] -> [B,1,d]."""
    B = x.shape[0]
    q = L._proj(x[:, 0], cp["wq"])
    if "bq" in cp:
        q = q + cp["bq"]
    n_kv, G = cfg.n_kv, cfg.n_q // cfg.n_kv
    qg = q.reshape(B, n_kv, G, cfg.hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                     ck.float()) / math.sqrt(cfg.hd)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, cv.float())
    o = o.reshape(B, cfg.n_q, cfg.hd).to(x.dtype)
    return L.attn_out_decode(cp, o)[:, None]


def prepare_encdec_state(cfg, params, state, src_embeds, *, rules=None):
    """Run the encoder and fill the decoder's cross K/V (the encoder-decoder
    prefill).  src_embeds [B, S_src, d] (the stub audio frontend's frame
    embeddings).  Returns a new state."""
    _check_engine(cfg, rules)
    memory = encdec.encode(cfg, params, src_embeds)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        cp = nn.layer_slice(params["decoder"], i)["cross"]
        k, v = L._proj(memory, cp["wk"]), L._proj(memory, cp["wv"])
        if "bk" in cp:
            k, v = k + cp["bk"], v + cp["bv"]
        ks.append(k)
        vs.append(v)
    state = dict(state)
    state["cross_k"], state["cross_v"] = torch.stack(ks), torch.stack(vs)
    return state


def _attention_layers(cfg, params, state, x, positions, mrope, attn):
    """The dense, moe and vlm families' layers in order: gemma3's local
    layers attend over their ring, every other layer over the paged KV
    (the reference's superblock scan in _gemma_layers visits them in the
    same order).  ``attn(h, ap, j, mrope)`` is paged layer j's attention.
    Returns (x, ring_pos' or None)."""
    B = x.shape[0]
    n_paged = n_ring = 0
    for i in range(cfg.num_layers):
        lpp = nn.layer_slice(params["layers"], i)
        h = nn.rmsnorm(lpp["ln1"], x)
        if lm.layer_window(cfg, i):
            x = x + _ring_attn(cfg, h, lpp["attn"], state["ring_k"][n_ring],
                               state["ring_v"][n_ring], state["ring_pos"],
                               positions)
            n_ring += 1
        else:
            x = x + attn(h, lpp["attn"], n_paged, mrope)
            n_paged += 1
        x = x + _mlp_or_moe(cfg, lpp, nn.rmsnorm(lpp["ln2"], x))
    if not n_ring:
        return x, None
    # every lane's slot takes this step's position, after all layers
    W = state["ring_pos"].shape[1]
    ring_pos = state["ring_pos"].clone()
    ring_pos[torch.arange(B, device=positions.device),
             (positions % W).to(torch.int64)] = positions
    return x, ring_pos


def _hybrid_layers(cfg, params, state, x, attn):
    """zamba2: each group of ``shared_attn_every`` mamba layers, then the
    shared block over its own pool (invocation g writes pool g), then the
    trailing mamba layers.  Returns (x, the mamba state of every layer)."""
    every = cfg.shared_attn_every
    n_inv = HY.num_shared_invocations(cfg)
    sp = params["shared"]
    chunks = []
    for g in range(n_inv):
        x, s2 = HY.mamba_decode_chunk(cfg, params["layers"], state["ssm"],
                                      x, g * every, (g + 1) * every)
        chunks.append(s2)
        x = x + attn(nn.rmsnorm(sp["ln1"], x), sp["attn"], g, None)
        x = x + L.mlp_apply(sp["mlp"], nn.rmsnorm(sp["ln2"], x))
    if cfg.num_layers > n_inv * every:
        x, s2 = HY.mamba_decode_chunk(cfg, params["layers"], state["ssm"],
                                      x, n_inv * every, cfg.num_layers)
        chunks.append(s2)
    return x, ssm.MambaState(*(torch.cat(ts) for ts in zip(*chunks)))


def _encdec_layers(cfg, params, state, x, attn):
    """seamless's decoder: paged causal self attention, cross attention
    over the encoder's K/V, SwiGLU MLP."""
    for i in range(cfg.num_layers):
        lpp = nn.layer_slice(params["decoder"], i)
        x = x + attn(nn.rmsnorm(lpp["ln1"], x), lpp["attn"], i, None)
        x = x + _cross_attn_decode(cfg, nn.rmsnorm(lpp["ln_cross"], x),
                                   lpp["cross"], state["cross_k"][i],
                                   state["cross_v"][i])
        x = x + L.mlp_apply(lpp["mlp"], nn.rmsnorm(lpp["ln2"], x))
    return x


def _serve_step_impl(cfg, params, state, tokens, positions, mrope=None, *,
                     S_max, page_size):
    B = tokens.shape[0]
    x = nn.embed_lookup(params["embed"], tokens)      # [B,1,d]
    new_state = dict(state)
    act = state["active"] & ~state["aborted"]

    if cfg.family == "ssm":
        # attention-free: no page table, nothing refused
        aborts = torch.zeros_like(act)
        x, ssm2 = HY.mamba_decode_chunk(cfg, params["layers"], state["ssm"],
                                        x, 0, cfg.num_layers)
        new_state["ssm"] = _freeze_lanes(ssm2, state["ssm"], act)
    else:
        # encdec's self attention takes the plain attend_local, as in the
        # reference (_fused_kernel_reason)
        fused = _fused_kernel_ok(cfg)
        table, write_slot, aborts, bt, lp = _page_ops(
            cfg, state, positions, act, S_max=S_max, page_size=page_size,
            fused=fused)
        new_state["table"] = table
        new_state["block_table"] = bt
        pools, scales = state["pools"], state.get("pool_scales")
        plan = paged.write_plan(write_slot, positions, 0, pools.k.shape[1],
                                page_size)

        def attn(h, ap, j, mrope_j):
            return paged_attn_op(
                cfg, h, ap, pools.k[j], pools.v[j], lp, write_slot,
                positions, page_size, mrope=mrope_j,
                scales=None if scales is None else (scales.k[j],
                                                    scales.v[j]),
                bt=bt, fused=fused, plan=plan)

        if cfg.family == "hybrid":
            x, ssm2 = _hybrid_layers(cfg, params, state, x, attn)
            # a lane refused THIS step re-issues its token after the
            # rebuild: its recurrent state must not advance either
            new_state["ssm"] = _freeze_lanes(ssm2, state["ssm"],
                                             act & ~aborts)
        elif cfg.family == "encdec":
            x = _encdec_layers(cfg, params, state, x, attn)
        else:
            x, ring_pos = _attention_layers(cfg, params, state, x,
                                            positions, mrope, attn)
            if ring_pos is not None:
                new_state["ring_pos"] = ring_pos

    x = nn.rmsnorm(params["final_norm"], x)
    logits = lm._logits(cfg, params, x)
    # inactive lanes stay frozen; aborted lanes refuse the token (pos not
    # advanced, no KV written — the caller must evict or rebuild)
    new_state["aborted"] = state["aborted"] | aborts
    new_state["pos"] = torch.where(act & ~aborts, positions + 1, positions)
    if "counters" in state:
        # the ssm family has no table: only token and abort counts tick
        new_state["counters"] = OC.update_token_counters(
            state["counters"], act=act, aborts=aborts, positions=positions,
            page_size=page_size, table_before=state.get("table"),
            table_after=new_state.get("table"))
    return logits[:, 0], new_state
