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

On a device mesh (``rules``, ``serve_rules`` or ``serve_manual_rules``)
the program runs SPMD: one process per rank (``launch/mesh.run_spmd``),
each holding only its shards of the weights, pools and state, with the
reference's collectives made explicit (``dist/collectives``).  The page
table, block table, positions and flags are replicated: every rank runs
the identical allocation and sees the same aborts.  Two layouts:

- gspmd (``serve_rules``): activations replicated, weights TP over
  ``model`` as the rules cut them (``dist/sharding.param_axes``), the page
  pool sharded over every axis (page ``slot`` on rank ``slot // npr``),
  rings and mamba state per sequence over ``data``.  A paged layer
  all-gathers its q/k/v heads over ``model``, writes and attends its own
  pages (K1 in partials mode on the rank-local block table), merges the
  ranks' partials (``paged.merge_global`` over every axis) and applies
  the row-parallel out projection with a psum; the MLP, embedding and
  read-out take the Megatron column/row collectives XLA inserts there;
- manual (``tp_impl="manual"``, ``serve_manual_rules``): the whole token
  step runs on this rank's head shard — pools page-sharded over (pod,
  data) and head-sharded over ``model`` (KV heads tiled by ``kv_rep``
  when the model axis is wider than ``n_kv``), one psum after attention
  and one after the MLP/MoE, gemma3's rings and zamba2's head-sharded
  mamba inside the same step.

A rank's wrapper launches K1 on its own pools, which are their own
contiguous tensors.  The encdec family decodes on the gspmd layout under
either rule set (the fused manual region refuses it, as the reference's
``_manual_decode_ok`` does): ``prepare_encdec_state(rules=)`` runs the
encoder through the Megatron forward on the rank's weight shards
(``dist/tp.block_apply_sharded``) and fills the rank's piece of the cross
K/V (lanes over ``data``, KV heads over ``model``); the step's cross
attention runs on those pieces, psum'd over ``model`` and all-gathered
over the lanes, and its self attention stays on the plain
``attend_local``.
"""
from __future__ import annotations

import logging
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import batched as BT
from repro_torch.device import (host_bool, host_nonzero, resolve_device,
                                to_card)
from repro_torch.dist import collectives as C
from repro_torch.dist import ctx
from repro_torch.dist import tp as TP
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
from repro_torch.obs.trace import span
from repro_torch.serving import page_table as PT
from repro_torch.serving import paged

DEFAULT_PAGE_SIZE = 256

logger = logging.getLogger(__name__)


def _check_engine(cfg, rules) -> None:
    registry.check_supported(cfg)
    if rules is None:
        return
    if C.current_mesh() is not rules.mesh:
        raise ValueError("the rules' mesh is not this process's bound mesh "
                         "(launch.mesh.make_mesh)")


# ---------------------------------------------------------------------------
# Mesh helpers.

def _mesh_axes(rules):
    if rules is None:
        return ()
    return tuple(a for a in ("pod", "data", "model") if a in rules.mesh.shape)


def _n_chips(rules) -> int:
    if rules is None:
        return 1
    n = 1
    for a in _mesh_axes(rules):
        n *= rules.mesh.shape[a]
    return n


def _chip_idx(axes) -> int:
    """This rank's row-major index over ``axes`` (0 for none)."""
    return C.axis_index(axes) if axes else 0


def _pd_axes(rules):
    """Mesh axes the page dim shards over in the fused manual layout
    (everything but ``model``, which shards KV heads instead)."""
    return tuple(a for a in ("pod", "data") if a in rules.mesh.shape)


# The two unsupported families of the fused manual region — everything else
# (dense incl. gemma3's local-window pattern, moe, vlm, hybrid) takes it.
_MANUAL_UNSUPPORTED_FAMILY = {
    "ssm": "attention-free SSM stack: no model-axis work in the region",
    "encdec": "cross-attention decode state not yet inside the fused region",
}


def _manual_decode_reason(cfg, rules) -> Optional[str]:
    """Why ``tp_impl="manual"`` decode falls back to gspmd — None when the
    fused manual region applies."""
    fam = _MANUAL_UNSUPPORTED_FAMILY.get(cfg.family)
    if fam is not None:
        return fam
    return TP.decode_manual_unsupported(cfg, rules)


def _manual_decode_ok(cfg, rules) -> bool:
    return _manual_decode_reason(cfg, rules) is None


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
    if rules is not None and _manual_decode_ok(cfg, rules):
        if TP.decode_kv_rep(cfg, rules.mesh.shape["model"]) != 1:
            return ("kv_rep>1: replicated-KV manual layout keeps the "
                    "two-dispatch per-chip attend path")
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
    manual = _manual_decode_reason(cfg, rules) if rules is not None else None
    strat_reason = _probe_strategy_reason(cfg, rules)
    return {
        "decode_tp": "ok" if manual is None else manual,
        "fused_kernel": ("ok" if _fused_kernel_ok(cfg, rules)
                         else _fused_kernel_reason(cfg, rules)),
        "probe_strategy": (f"{cfg.probe_strategy}: ok"
                           if strat_reason is None
                           else f"{cfg.probe_strategy}: {strat_reason}"),
    }


def _local_block_table(bt, chip_idx: int, npr: int):
    """Rank-local view of the RAW incremental block table for K1: entries
    this rank owns (``slot // npr == chip``, as ``paged.compact_local`` and
    ``write_token_kv``) become local pool rows, everything else -1.
    Liveness comes from ``positions`` in the kernel."""
    mine = (bt >= 0) & (torch.div(bt, npr, rounding_mode="floor")
                        == chip_idx)
    return torch.where(mine, bt % npr, -1).to(torch.int32)


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


def _ssm_tp(cfg, rules) -> bool:
    """The mamba state and weights are head-sharded over ``model``."""
    return (rules is not None and cfg.family in ("ssm", "hybrid")
            and TP.decode_ssm_tp(cfg, rules.mesh.shape.get("model", 1)))


def make_decode_state(cfg, B: int, S_max: int, *, rules=None,
                      page_size: int = DEFAULT_PAGE_SIZE,
                      n_pages: Optional[int] = None,
                      device=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Decode state for B lanes on ``device`` (the card unless ``"cpu"``)
    and its logical axes.  ``n_pages`` overrides the worst-case pool plan
    (``plan_pages``: 1.25x of B·max_pages) to overcommit it; it is rounded
    up to the mesh's rank count.  The page table, block table and pools
    exist only when the family has paged layers (not for ``ssm``); the ssm
    and hybrid families carry their mamba state stacked ``[L, B, ...]``
    (``ssm``), encdec its cross K/V ``[L, B, S_src, kv, hd]`` with
    ``S_src = max(S_max // 8, 1)``.

    With ``rules`` this rank's pieces are built (the rules' specs of the
    reference's state axes, on the mesh's device): pools sharded over the
    page dim (every axis, or (pod, data) and KV heads over ``model`` in
    the fused manual layout, whose head dim is tiled to ``n_kv·kv_rep``),
    rings and mamba state per the layout, the rest replicated."""
    _check_engine(cfg, rules)
    dev = resolve_device(device) if rules is None else rules.mesh.device
    n_chips = _n_chips(rules)
    if n_pages is None:
        maxP, n_pages = plan_pages(cfg, B, S_max, page_size, n_chips)
    else:
        maxP = -(-S_max // page_size)
        n_pages = paged.round_pages(int(n_pages), n_chips)
    n_paged, n_ring = _n_attn_layers(cfg)
    manual = rules is not None and _manual_decode_ok(cfg, rules)
    kv_rep = (TP.decode_kv_rep(cfg, rules.mesh.shape["model"])
              if manual else 1)
    n_kv_st = cfg.n_kv * kv_rep
    dtype = cfg.activation_dtype()
    int8 = cfg.kv_cache_dtype == "int8"
    axes: Dict[str, Any] = {}

    def mk(name, shape, ax, fill, dt):
        if name:
            axes[name] = ax
        if rules is not None:
            shape = rules.local_shape(rules.spec(ax, shape), shape)
        return torch.full(shape, fill, dtype=dt, device=dev)

    i32 = torch.int32
    state: Dict[str, Any] = {
        "pos": mk("pos", (B,), (None,), 0, i32),
        "seq_ids": torch.arange(B, dtype=i32, device=dev),
        "active": mk("active", (B,), (None,), True, torch.bool),
        "aborted": mk("aborted", (B,), (None,), False, torch.bool),
    }
    axes["seq_ids"] = (None,)
    if n_paged:
        state["table"] = _pt(cfg).create_table(n_pages, device=dev)
        axes["table"] = None
        state["block_table"] = mk("block_table", (B, maxP), (None, None),
                                  -1, i32)
        shp = (n_paged, n_pages, page_size, n_kv_st, cfg.hd)
        pool_ax = paged.POOL_AXES_TP if manual else paged.POOL_AXES
        state["pools"] = paged.PagedPools(
            k=mk(None, shp, pool_ax, 0, torch.int8 if int8 else dtype),
            v=mk(None, shp, pool_ax, 0, torch.int8 if int8 else dtype))
        axes["pools"] = paged.PagedPools(k=pool_ax, v=pool_ax)
        if int8:
            sc_ax = (paged.POOL_SCALE_AXES_TP if manual
                     else paged.POOL_SCALE_AXES)
            state["pool_scales"] = paged.PoolScales(
                k=mk(None, shp[:4], sc_ax, 1, torch.bfloat16),
                v=mk(None, shp[:4], sc_ax, 1, torch.bfloat16))
            axes["pool_scales"] = paged.PoolScales(k=sc_ax, v=sc_ax)
    if n_ring:
        W = cfg.local_window
        # manual: ring heads over model (lanes replicated, as the region's
        # activations); gspmd: per sequence over data
        ring_ax = (("layer", None, None, "kv", None) if manual
                   else ("layer", "batch", None, "kv", None))
        shp = (n_ring, B, W, n_kv_st, cfg.hd)
        state["ring_k"] = mk("ring_k", shp, ring_ax, 0, dtype)
        state["ring_v"] = mk("ring_v", shp, ring_ax, 0, dtype)
        state["ring_pos"] = mk("ring_pos", (B, W), (None, None) if manual
                               else ("batch", None), -1, i32)
    if cfg.family in ("ssm", "hybrid"):
        # mamba state head-sharded over model when decode_ssm_tp passes,
        # per sequence over data on the gspmd step, else replicated
        keep_heads = _ssm_tp(cfg, rules)
        G, Hg = cfg.ssm_groups, cfg.ssm_heads // cfg.ssm_groups
        W1 = cfg.conv_width - 1
        shapes = ssm.MambaState(
            h=(cfg.num_layers, B, G, Hg, cfg.ssm_head_dim, cfg.ssm_state),
            conv_x=(cfg.num_layers, B, W1, cfg.d_inner),
            conv_bc=(cfg.num_layers, B, W1, 2 * G * cfg.ssm_state))
        dts = ssm.MambaState(torch.float32, dtype, dtype)
        ssm_ax = ssm.MambaState(*(
            ("layer",) + tuple(None if (a == "batch" and manual)
                               or (a not in (None, "batch")
                                   and not keep_heads) else a
                               for a in ax)
            for ax in ssm.MAMBA_STATE_AXES))
        state["ssm"] = ssm.MambaState(*(
            mk(None, shp, ax, 0, dt) for shp, ax, dt in
            zip(shapes, ssm_ax, dts)))
        axes["ssm"] = ssm_ax
    if cfg.family == "encdec":
        shp = (cfg.num_layers, B, max(S_max // 8, 1), cfg.n_kv, cfg.hd)
        state["cross_k"] = mk("cross_k", shp,
                              ("layer", "batch", None, "kv", None), 0, dtype)
        state["cross_v"] = mk("cross_v", shp,
                              ("layer", "batch", None, "kv", None), 0, dtype)
    if getattr(cfg, "telemetry", False):
        state["counters"] = OC.Counters.zeros(device=dev)
        axes["counters"] = None
    return state, axes


def clone_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """Deep copy of a decode state (tensors cloned)."""
    def cp(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple):
            return type(x)(*(cp(t) for t in x))
        return x
    return {k: cp(v) for k, v in state.items()}


def shard_state(cfg, state: Dict[str, Any], axes: Dict[str, Any],
                rules) -> Dict[str, Any]:
    """This rank's pieces of a one-device decode state, under the layout
    whose logical ``axes`` ``make_decode_state(rules=)`` returned: each
    leaf cut by the rules' spec of its axes (the fused manual layout's
    KV heads first tiled ``kv_rep`` times, each head repeated in place),
    on the mesh's device; the replicated leaves are copied."""
    from repro_torch.dist.sharding import local_shard
    mesh = rules.mesh
    rep = (TP.decode_kv_rep(cfg, rules.mesh.shape["model"])
           if _manual_decode_ok(cfg, rules) else 1)

    def cut(ax, leaf):
        if ax is None:
            return leaf.to(mesh.device, copy=True)
        if rep > 1 and "kv" in ax:
            leaf = leaf.repeat_interleave(rep, dim=ax.index("kv"))
        return local_shard(leaf, rules.spec(ax, tuple(leaf.shape)), mesh,
                           device=mesh.device)

    out = {}
    for k, v in state.items():
        ax = axes.get(k)
        if isinstance(v, tuple):
            out[k] = type(v)(*map(cut, ax or (None,) * len(v), v))
        else:
            out[k] = cut(ax, v)
    return out


def _page_axes_of(state) -> Tuple[str, ...]:
    """The mesh axes a state's pools are page-sharded over (``()`` when a
    rank holds the whole pool): every axis (gspmd) or (pod, data) (the
    fused manual layout), told apart by the local page count."""
    m = BT.size(state["table"])
    npr = state["pools"].k.shape[1]
    if npr == m:
        return ()
    mesh = C.current_mesh()
    for axes in (tuple(a for a in ("pod", "data", "model")
                       if a in mesh.shape),
                 tuple(a for a in ("pod", "data") if a in mesh.shape)):
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        if n * npr == m:
            return axes
    raise ValueError(f"pool of {npr} local pages does not shard {m} pages "
                     f"over the mesh {mesh.shape}")


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
    they are.  Returns a new state; the given one is left as it was.

    On a mesh the table is replicated and every rank re-hashes it the
    same way; the pools are page-sharded, so each rank all-gathers its
    pages over the page axes, moves them, and keeps its share of the new
    pool (``n_pages`` must stay divisible by the page shard count)."""
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
    page_axes = _page_axes_of(state)
    n_shards = m // state["pools"].k.shape[1]
    if new_m % n_shards:
        raise ValueError(f"rebuild_page_table: n_pages={new_m} is not "
                         f"divisible by the {n_shards} page shards")
    fresh, old_slots, new_slots, live = pt.rehash(table, new_m, seed)
    lost = live & (new_slots < 0)
    if host_bool(lost.any()):
        raise ValueError(
            f"rebuild_page_table: {int(lost.sum())} live pages do not fit "
            f"in n_pages={new_m}")
    idx = host_nonzero(live)
    src = old_slots[idx].to(torch.int64)
    dst = new_slots[idx].to(torch.int64)
    new_npr = new_m // n_shards
    lo = _chip_idx(page_axes) * new_npr

    def move(pool, fill):
        if page_axes:
            pool = C.all_gather(pool, page_axes, dim=1, tiled=True)
        out = torch.full(pool.shape[:1] + (new_m,) + pool.shape[2:], fill,
                         dtype=pool.dtype, device=pool.device)
        out[:, dst] = pool[:, src]
        return out[:, lo:lo + new_npr].contiguous() if page_axes else out

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


def lane_slice(leaf: torch.Tensor, dim: int, B: int) -> slice:
    """The global lanes a per-lane state leaf holds on this rank: all of
    them, or its ``data`` shard when the leaf is split over lanes (the
    gspmd layout's rings and mamba state)."""
    n = leaf.shape[dim]
    if n == B:
        return slice(0, B)
    lo = C.axis_index("data") * n
    return slice(lo, lo + n)


def reset_lanes(state: Dict[str, Any], slots) -> Dict[str, Any]:
    """Reset the given lanes' per-lane state (mamba ``h`` and conv tails,
    gemma3's ring K/V to 0 and ``ring_pos`` to -1) to what a fresh
    ``make_decode_state`` holds, on whichever lanes this rank holds."""
    B = state["pos"].shape[0]
    state = dict(state)

    def local(leaf, dim):
        sl = lane_slice(leaf, dim, B)
        idx = [s - sl.start for s in slots if sl.start <= s < sl.stop]
        return to_card(idx, leaf.device, torch.int64)

    if "ssm" in state:
        st = state["ssm"]
        state["ssm"] = type(st)(*(t.index_fill(1, local(t, 1), 0)
                                  for t in st))
    if "ring_k" in state:
        idx = local(state["ring_k"], 1)
        # a Python number assigned to card memory is copied there first
        for name in ("ring_k", "ring_v"):
            state[name][:, idx] = to_card(0, idx.device, state[name].dtype)
        ring_pos = state["ring_pos"].clone()
        ring_pos[local(ring_pos, 0)] = to_card(-1, idx.device,
                                               ring_pos.dtype)
        state["ring_pos"] = ring_pos
    return state


# ---------------------------------------------------------------------------
# Attention pieces.

def _rope_single(cfg, x, positions, mrope=None):
    """x [B,H,hd] one token per seq at ``positions`` [B]; ``mrope``
    [3,B,1] the vlm family's M-RoPE streams."""
    with span("model.rope"):
        x4 = x[:, None]                              # [B,1,H,hd]
        if mrope is not None and cfg.mrope_sections:
            out = L.apply_mrope(x4, mrope, cfg.mrope_sections,
                                cfg.rope_theta)
        else:
            out = L.apply_rope(x4, positions[:, None], cfg.rope_theta)
        return out[:, 0]


def _attend_pages(cfg, q, pk, pv, scales, pg, positions, fused):
    """The (o, m, l) partials of q [B, QH, hd] over this rank's pages:
    K1 on the rank-local raw block table, or the plain ``attend_local``
    over the compacted pages."""
    B, QH, hd = q.shape
    if fused:
        return fused_decode_kernel(q.contiguous(), pk, pv, pg.bt, positions,
                                   scales=scales, partials=True)
    kv = pk.shape[2]
    return paged.attend_local(q.reshape(B, kv, QH // kv, hd), pk, pv, pg.lp,
                              positions, pg.page_size, scales=scales)


class _Pages:
    """This step's page view on one rank: the compacted pages ``lp`` or
    the local block table ``bt``, the rank's index over the page axes
    ``axes`` and its ``npr`` pool rows, and the token's write plan."""

    def __init__(self, *, lp, bt, page_size, chip, npr, plan, axes):
        self.lp, self.bt, self.page_size = lp, bt, page_size
        self.chip, self.npr, self.plan, self.axes = chip, npr, plan, axes


def _paged_attn(cfg, x, ap, pk, pv, scales, pg, write_slot, positions,
                mrope, fused, *, gather_heads=False):
    """A paged layer: q/k/v (all-gathered over ``model`` when
    ``gather_heads`` and the weights are head-sharded: the gspmd step),
    RoPE, the token's K/V written into this rank's pages, the partials
    over them, merged across the page axes, then the out projection —
    row-parallel with a psum over ``model`` when the q heads are
    sharded."""
    B = x.shape[0]
    q, k, v = L.attn_qkv_decode(ap, x[:, 0])
    q_sharded = gather_heads and q.shape[1] < cfg.n_q
    if q_sharded:
        q = C.all_gather(q, "model", dim=1)
    if gather_heads and k.shape[1] < cfg.n_kv:
        k = C.all_gather(k, "model", dim=1)
        v = C.all_gather(v, "model", dim=1)
    q = _rope_single(cfg, q, positions, mrope)
    k = _rope_single(cfg, k, positions, mrope)
    paged.write_token_kv(pk, pv, k, v, write_slot, positions, pg.chip,
                         pg.npr, pg.page_size, scales=scales, plan=pg.plan)
    o, m, l = _attend_pages(cfg, q, pk, pv, scales, pg, positions, fused)
    out = paged.merge_global(o, m, l, pg.axes)        # [B,kv,G,hd] f32
    out = out.reshape(B, q.shape[1], cfg.hd).to(x.dtype)
    return _out_proj(cfg, ap, out, q_sharded)[:, None]


def _out_proj(cfg, ap, out, q_sharded):
    """attn out projection of full-head ``out`` [B, n_q, hd]: this rank's
    head rows of a row-parallel wo, psummed over ``model``, when the
    heads are sharded."""
    with span("model.out_proj"):
        if not q_sharded:
            return L.attn_out_decode(ap, out)
        hl = ap["wo"].shape[0]
        lo = C.axis_index("model") * hl
        return C.psum(L.attn_out_decode(ap, out[:, lo:lo + hl]), "model")


def _paged_attn_shard(cfg, x, ap, pk, pv, scales, pg, write_slot, positions,
                      mrope, fused, *, kv_rep=1):
    """A paged layer inside the fused manual step, local head shard end to
    end: column-parallel QKV (with ``kv_rep > 1`` the replicated K/V
    projection keeps this rank's one head), the K/V write into this rank's
    (page, head) slice, the partials over local pages and heads, merged
    across the page axes only, then row-parallel out + one psum over
    ``model``."""
    B = x.shape[0]
    q, k, v = L.attn_qkv_decode(ap, x[:, 0])
    k, v = L.kv_head_slice(k, v, C.axis_index("model"), kv_rep)
    q = _rope_single(cfg, q, positions, mrope)
    k = _rope_single(cfg, k, positions, mrope)
    paged.write_token_kv(pk, pv, k, v, write_slot, positions, pg.chip,
                         pg.npr, pg.page_size, scales=scales, plan=pg.plan)
    o, m, l = _attend_pages(cfg, q, pk, pv, scales, pg, positions, fused)
    out = paged.merge_global(o, m, l, pg.axes)        # heads stay local
    out = out.reshape(B, q.shape[1], cfg.hd).to(x.dtype)
    return C.psum(L.attn_out_decode(ap, out), "model")[:, None]


# ---------------------------------------------------------------------------
# Ring-buffer (sliding window) attention for gemma3 local layers.

def _ring_core(cfg, q, k, v, ring_k_l, ring_v_l, ring_pos, positions):
    """q [B,H,hd] and the token's k/v [B,kv,hd] (roped) of B lanes; one
    local layer's ring [B,W,kv,hd] (k/v written in place at slot
    ``positions % W``); ring_pos [B,W] the absolute position each slot
    holds (-1 empty), as before this step.  Attends to the slots with
    ``pos - W < ring_pos <= pos`` and the current slot.  Returns o
    [B,H,hd] in q's dtype."""
    B, H, hd = q.shape
    W = ring_k_l.shape[1]
    lanes = torch.arange(B, device=q.device)
    slot = (positions % W).to(torch.int64)
    ring_k_l[lanes, slot] = k.to(ring_k_l.dtype)
    ring_v_l[lanes, slot] = v.to(ring_v_l.dtype)
    kv = k.shape[1]
    qg = q.reshape(B, kv, H // kv, hd)
    s = torch.einsum("bkgd,bwkd->bkgw", qg.float(),
                     ring_k_l.float()) / math.sqrt(hd)
    pos = positions[:, None]
    ok = (ring_pos >= 0) & (ring_pos <= pos) & (ring_pos > pos - W)
    ok[lanes, slot] = True
    s = torch.where(ok[:, None, None, :], s, paged.NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bwkd->bkgd", p, ring_v_l.float())
    return o.reshape(B, H, hd).to(q.dtype)


def _ring_attn(cfg, x, ap, ring_k_l, ring_v_l, ring_pos, positions):
    """One device: x [B,1,d]; one local layer's ring [B,W,kv,hd].
    Returns attn_out [B,1,d]."""
    q, k, v = L.attn_qkv_decode(ap, x[:, 0])
    q = _rope_single(cfg, q, positions)
    k = _rope_single(cfg, k, positions)
    o = _ring_core(cfg, q, k, v, ring_k_l, ring_v_l, ring_pos, positions)
    return L.attn_out_decode(ap, o)[:, None]


def _ring_attn_shard(cfg, x, ap, ring_k_l, ring_v_l, ring_pos, positions,
                     kv_rep=1):
    """gemma3 local layer inside the fused manual step: the ring is
    head-sharded over ``model`` (the pools' tiled-head layout), this rank
    attends its q-head slice against its resident KV heads' full window —
    the softmax needs no cross-rank merge — then row-parallel out + one
    psum."""
    q, k, v = L.attn_qkv_decode(ap, x[:, 0])
    k, v = L.kv_head_slice(k, v, C.axis_index("model"), kv_rep)
    q = _rope_single(cfg, q, positions)
    k = _rope_single(cfg, k, positions)
    o = _ring_core(cfg, q, k, v, ring_k_l, ring_v_l, ring_pos, positions)
    return C.psum(L.attn_out_decode(ap, o), "model")[:, None]


def _ring_attn_gspmd(cfg, x, ap, ring_k_l, ring_v_l, ring_pos, positions):
    """gemma3 local layer on the gspmd step: the heads all-gathered as in
    the paged layers, this rank's lanes (``data``) and KV heads
    (``model``) of the ring attended, the outputs all-gathered back, then
    the out projection."""
    B = x.shape[0]
    q, k, v = L.attn_qkv_decode(ap, x[:, 0])
    q_sharded = q.shape[1] < cfg.n_q
    if q_sharded:
        q = C.all_gather(q, "model", dim=1)
    if k.shape[1] < cfg.n_kv:
        k = C.all_gather(k, "model", dim=1)
        v = C.all_gather(v, "model", dim=1)
    q = _rope_single(cfg, q, positions)
    k = _rope_single(cfg, k, positions)
    lanes = lane_slice(ring_k_l, 0, B)
    kv_l = ring_k_l.shape[2]
    G = cfg.n_q // cfg.n_kv
    k0 = C.axis_index("model") * kv_l if kv_l < cfg.n_kv else 0
    o = _ring_core(cfg, q[lanes, k0 * G:(k0 + kv_l) * G],
                   k[lanes, k0:k0 + kv_l], v[lanes, k0:k0 + kv_l],
                   ring_k_l, ring_v_l, ring_pos, positions[lanes])
    if kv_l < cfg.n_kv:
        o = C.all_gather(o, "model", dim=1)
    if o.shape[0] < B:
        o = C.all_gather(o, "data", dim=0)
    return _out_proj(cfg, ap, o, q_sharded)[:, None]


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


def _cross_attn_gspmd(cfg, x, cp, ck, cv):
    """Cross attention on a mesh rank's pieces: ``x`` [B,1,d] replicated,
    ``cp`` the rules' cut of the weights (heads over ``model``), ``ck``/
    ``cv`` this rank's lanes (over ``data``) and KV heads (over
    ``model``).  The rank's heads are psum'd over ``model`` after the
    row-parallel out projection, and the lanes all-gathered over
    ``data``."""
    B = x.shape[0]
    lanes = lane_slice(ck, 0, B)
    q = L._proj(x[lanes, 0], cp["wq"])
    if "bq" in cp:
        q = q + cp["bq"]
    Bl, hq = q.shape[:2]
    hkv = ck.shape[2]
    G = cfg.n_q // cfg.n_kv
    if hq == cfg.n_q and hkv < cfg.n_kv:
        # KV heads sharded where q heads are not: take them all
        ck = C.all_gather(ck, "model", dim=2)
        cv = C.all_gather(cv, "model", dim=2)
        hkv = cfg.n_kv
    elif hq < cfg.n_q and hkv == cfg.n_kv:
        # q heads sharded where KV heads are not: their KV heads
        lo = C.axis_index("model") * hq // G
        hkv = max(hq // G, 1)
        ck, cv = ck[:, :, lo:lo + hkv], cv[:, :, lo:lo + hkv]
    if hkv * G != hq:
        raise ValueError(f"cross attention: {hq} local q heads do not "
                         f"group over {hkv} KV heads")
    qg = q.reshape(Bl, hkv, G, cfg.hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                     ck.float()) / math.sqrt(cfg.hd)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, cv.float())
    o = L.attn_out_decode(cp, o.reshape(Bl, hq, cfg.hd).to(x.dtype))
    if hq < cfg.n_q:
        o = C.psum(o, "model")
    if Bl < B:
        o = C.all_gather(o, "data", dim=0)
    return o[:, None]


def prepare_encdec_state(cfg, params, state, src_embeds, *, rules=None):
    """Run the encoder and fill the decoder's cross K/V (the encoder-decoder
    prefill).  src_embeds [B, S_src, d] (the stub audio frontend's frame
    embeddings).  Returns a new state.  With ``rules`` ``params`` and
    ``state`` are this rank's pieces (``mesh_param_specs``,
    ``make_decode_state(rules=)``) and ``src_embeds`` the whole batch: the
    encoder runs replicated through the Megatron forward on the weight
    shards, and the rank keeps its lanes and KV heads of the cross K/V."""
    _check_engine(cfg, rules)
    if rules is None:
        memory = encdec.encode(cfg, params, src_embeds)
        lanes = slice(None)
    else:
        x = src_embeds
        positions = torch.arange(x.shape[1], device=x.device)
        for i in range(cfg.encoder_layers):
            x = TP.block_apply_sharded(
                cfg, nn.layer_slice(params["encoder"], i), x, positions,
                causal=False)
        memory = nn.rmsnorm(params["enc_norm"], x)
        lanes = lane_slice(state["cross_k"], 1, src_embeds.shape[0])
    ks, vs = [], []
    for i in range(cfg.num_layers):
        cp = nn.layer_slice(params["decoder"], i)["cross"]
        k = L._proj(memory[lanes], cp["wk"])
        v = L._proj(memory[lanes], cp["wv"])
        if "bk" in cp:
            k, v = k + cp["bk"], v + cp["bv"]
        ks.append(k)
        vs.append(v)
    state = dict(state)
    state["cross_k"], state["cross_v"] = torch.stack(ks), torch.stack(vs)
    return state


# ---------------------------------------------------------------------------
# How a rank computes each piece of a step: one device, the gspmd layout
# or the fused manual layout.

class _Ops:
    """One device: the reference's single-chip step."""
    fused = False

    def __init__(self, cfg, rules=None):
        self.cfg = cfg
        self.fused = _fused_kernel_ok(cfg, rules)

    def embed(self, params, tokens):
        return nn.embed_lookup(params["embed"], tokens)

    def page_axes(self):
        return ()

    def attn(self, x, ap, pk, pv, scales, pg, write_slot, positions, mrope):
        return _paged_attn(self.cfg, x, ap, pk, pv, scales, pg, write_slot,
                           positions, mrope, self.fused)

    def ring(self, x, ap, rk, rv, ring_pos, positions):
        return _ring_attn(self.cfg, x, ap, rk, rv, ring_pos, positions)

    def ffn(self, lpp, x):
        if self.cfg.family == "moe":
            return MOE.moe_apply(lpp["moe"], x, self.cfg)[0]
        return L.mlp_apply(lpp["mlp"], x)

    def mlp(self, mp, x):
        return L.mlp_apply(mp, x)

    def cross(self, cp, x, ck, cv):
        return _cross_attn_decode(self.cfg, x, cp, ck, cv)

    def mamba(self, layers, states, x, lo, hi):
        return HY.mamba_decode_chunk(self.cfg, layers, states, x, lo, hi)

    def logits(self, params, x):
        return lm._logits(self.cfg, params, x)


class _GspmdOps(_Ops):
    """The gspmd layout (``serve_rules``): replicated activations, weights
    as the rules cut them, pages over every axis."""

    def __init__(self, cfg, rules):
        super().__init__(cfg, rules)
        self.rules = rules
        self.ssm_tp = _ssm_tp(cfg, rules)

    def page_axes(self):
        """The axes the rules' ``pages`` entry names (every axis under
        ``serve_rules``; (pod, data) when the manual rules fall back to
        this layout, as for encdec)."""
        want = self.rules.rules.get("pages", ())
        return tuple(a for a in _mesh_axes(self.rules) if a in want)

    def cross(self, cp, x, ck, cv):
        return _cross_attn_gspmd(self.cfg, x, cp, ck, cv)

    def embed(self, params, tokens):
        """A vocab-sharded table: each rank looks up the tokens in its
        rows, the others give 0, and a psum over ``model`` (one nonzero
        term) completes the lookup exactly."""
        emb = params["embed"]["embedding"]
        Vl = emb.shape[0]
        if Vl == self.cfg.vocab_size:
            return emb[tokens]
        idx = tokens.long() - C.axis_index("model") * Vl
        ok = (idx >= 0) & (idx < Vl)
        x = torch.where(ok[..., None], emb[idx.clamp(0, Vl - 1)], 0)
        return C.psum(x, "model")

    def attn(self, x, ap, pk, pv, scales, pg, write_slot, positions, mrope):
        return _paged_attn(self.cfg, x, ap, pk, pv, scales, pg, write_slot,
                           positions, mrope, self.fused, gather_heads=True)

    def ring(self, x, ap, rk, rv, ring_pos, positions):
        return _ring_attn_gspmd(self.cfg, x, ap, rk, rv, ring_pos, positions)

    def ffn(self, lpp, x):
        if self.cfg.family == "moe":
            return MOE.moe_apply(lpp["moe"], x, self.cfg, rules=self.rules)[0]
        return self.mlp(lpp["mlp"], x)

    def mlp(self, mp, x):
        """Column-parallel gate/up, row-parallel wo + psum when d_ff is
        sharded over ``model``."""
        y = L.mlp_apply(mp, x)
        return C.psum(y, "model") if mp["wo"].shape[0] < self.cfg.d_ff \
            else y

    def mamba(self, layers, states, x, lo, hi):
        """Mamba layers [lo, hi) on this rank's lanes (``data``) and, when
        head-sharded, its heads (psums over ``model`` inside); the layers'
        outputs are all-gathered over the lanes so x stays replicated."""
        B = x.shape[0]
        lanes = lane_slice(states.h, 1, B)
        tp_axis = "model" if self.ssm_tp else None
        outs = []
        for i in range(lo, hi):
            lp = nn.layer_slice(layers, i)
            st = ssm.MambaState(*(t[i] for t in states))
            h, st2 = ssm.mamba_decode_step(
                lp["mamba"], nn.rmsnorm(lp["ln"], x[lanes]), self.cfg, st,
                tp_axis=tp_axis)
            if h.shape[0] < B:
                h = C.all_gather(h, "data", dim=0)
            x = x + h
            outs.append(st2)
        return x, ssm.MambaState(*(torch.stack(ts) for ts in zip(*outs)))

    def logits(self, params, x):
        if self.cfg.tie_embeddings:
            y = nn.embed_logits(params["embed"], x)
        else:
            y = nn.dense(params["lm_head"], x)
        if y.shape[-1] < self.cfg.vocab_size:
            y = C.all_gather(y, "model", dim=-1)
        return y.float()


class _ManualOps(_Ops):
    """The fused manual layout (``serve_manual_rules``): the whole token
    step on this rank's head shard."""

    def __init__(self, cfg, rules):
        super().__init__(cfg, rules)
        self.rules = rules
        tp = rules.mesh.shape["model"]
        self.kv_rep = TP.decode_kv_rep(cfg, tp)
        self.ssm_axis = "model" if _ssm_tp(cfg, rules) else None
        self.vocab_sharded = (not cfg.tie_embeddings
                              and cfg.vocab_size % tp == 0)

    def page_axes(self):
        return _pd_axes(self.rules)

    def attn(self, x, ap, pk, pv, scales, pg, write_slot, positions, mrope):
        return _paged_attn_shard(self.cfg, x, ap, pk, pv, scales, pg,
                                 write_slot, positions, mrope, self.fused,
                                 kv_rep=self.kv_rep)

    def ring(self, x, ap, rk, rv, ring_pos, positions):
        return _ring_attn_shard(self.cfg, x, ap, rk, rv, ring_pos,
                                positions, self.kv_rep)

    def ffn(self, lpp, x):
        if self.cfg.family == "moe":
            return MOE.moe_decode_local(lpp["moe"], x, self.cfg)
        return TP.mlp_decode_manual(lpp["mlp"], x)

    def mlp(self, mp, x):
        return TP.mlp_decode_manual(mp, x)

    def mamba(self, layers, states, x, lo, hi):
        return HY.mamba_decode_chunk(self.cfg, layers, states, x, lo, hi,
                                     tp_axis=self.ssm_axis)

    def logits(self, params, x):
        return TP.logits_decode_manual(self.cfg, params, x,
                                       vocab_sharded=self.vocab_sharded
                                       ).float()


def _ops(cfg, rules) -> _Ops:
    if rules is None:
        return _Ops(cfg)
    if _manual_decode_ok(cfg, rules):
        return _ManualOps(cfg, rules)
    return _GspmdOps(cfg, rules)


def mesh_param_specs(cfg, params, rules):
    """The specs a rank cuts the full parameters with for ``rules``'s
    decode step (``dist/sharding.local_shard``): the fused manual layout's
    ``decode_param_specs``, or the rules' specs of the parameters' logical
    axes on the gspmd step (the mamba weights head-sharded only when the
    mamba state is, ``decode_ssm_tp``)."""
    from repro_torch.dist.sharding import P, param_axes
    if _manual_decode_ok(cfg, rules):
        tp = rules.mesh.shape["model"]
        return TP.decode_param_specs(
            cfg, params,
            vocab_sharded=(not cfg.tie_embeddings
                           and cfg.vocab_size % tp == 0),
            kv_rep=TP.decode_kv_rep(cfg, tp),
            ssm_tp=cfg.family == "hybrid" and _ssm_tp(cfg, rules))
    specs = rules.tree_specs(param_axes(params), params)
    if cfg.family in ("ssm", "hybrid") and not _ssm_tp(cfg, rules):
        specs["layers"]["mamba"] = P()
    return specs


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
    if rules is not None and cfg.tp_impl == "manual" and \
            not _manual_decode_ok(cfg, rules):
        # never a silent fallback: the caller asked for the fused region
        logger.warning("fused manual-TP decode unavailable for %s — %s; "
                       "falling back to the gspmd serve step", cfg.name,
                       _manual_decode_reason(cfg, rules))


def make_serve_step(cfg, *, S_max: int, rules=None,
                    page_size: int = DEFAULT_PAGE_SIZE):
    """Returns serve_step(params, state, tokens [B,1], positions [B],
    [mrope_positions [3,B,1]]) -> (logits [B,V] f32, state').  On a mesh
    every rank calls it on its own pieces (``mesh_param_specs``,
    ``make_decode_state(rules=)``) with the same replicated tokens and
    positions, and gets the same full logits."""
    _check_engine(cfg, rules)
    _warn_fallbacks(cfg, rules)

    def serve_step(params, state, tokens, positions, mrope_positions=None):
        with ctx.use_rules(rules):
            return _serve_step_impl(cfg, params, state, tokens, positions,
                                    mrope_positions, S_max=S_max,
                                    page_size=page_size, rules=rules)

    return serve_step


def make_serve_megastep(cfg, *, S_max: int, K: int, rules=None,
                        page_size: int = DEFAULT_PAGE_SIZE):
    """The decode megastep: K tokens per call with greedy sampling between
    them.  Returns ``megastep(params, state, tokens [B,1], stop_len=None,
    forced=None, forced_mask=None) -> (tokens int32[B, K], state')`` with
    the reference's semantics (see ``_mega_scan``), on one device or, with
    ``rules``, on every rank of the mesh.  The function is tagged
    ``.megastep = "loop-K{K}"``."""
    _check_engine(cfg, rules)
    _warn_fallbacks(cfg, rules)

    def megastep(params, state, tokens, stop_len=None, forced=None,
                 forced_mask=None):
        def token_step(st, tok, pos, mrope):
            with ctx.use_rules(rules):
                return _serve_step_impl(cfg, params, st, tok, pos, mrope,
                                        S_max=S_max, page_size=page_size,
                                        rules=rules)
        with span("model.megastep"):
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
        with span("model.token_step"):
            pos = st["pos"]
            mrope = (pos[None, :, None].expand(3, B, 1)
                     if cfg.family == "vlm" else None)
            logits, st2 = token_step(st, tok, pos, mrope)
            with span("model.sample"):
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


def _page_ops(cfg, state, positions, active, ops, *, S_max, page_size):
    """Once-per-token page-table work, identical on every rank:
    incremental allocation, then this rank's page view — the rank-local
    raw block table for K1, or the slots view compacted to this rank's
    pages — and the token's write plan."""
    maxP = -(-S_max // page_size)
    (table, write_slot, aborts), bt = _pt(cfg).alloc_step_incremental(
        state["table"], state["seq_ids"], positions, state["block_table"],
        page_size=page_size, active=active)
    axes = ops.page_axes()
    chip = _chip_idx(axes)
    npr = state["pools"].k.shape[1]
    lp = local_bt = None
    if ops.fused:
        local_bt = _local_block_table(bt, chip, npr) if axes else bt
    else:
        slots = PT.PageTable.block_table_slots(bt, positions,
                                               page_size=page_size)
        cap = paged.capacity(positions.shape[0], maxP,
                             BT.size(table) // npr,
                             factor=cfg.page_capacity_factor)
        lp = paged.compact_local(slots, chip, npr, cap)
    plan = paged.write_plan(write_slot, positions, chip, npr, page_size)
    pg = _Pages(lp=lp, bt=local_bt, page_size=page_size, chip=chip,
                npr=npr, plan=plan, axes=axes)
    return table, write_slot, aborts, bt, pg


def _freeze_lanes(new, old, act):
    """Per-lane freeze of refused or inactive lanes: the leaves are
    ``[L, B, ...]`` stacked per-layer state (``act`` for the lanes they
    hold).  A refused token must leave no trace — the SSM recurrence is
    not idempotent under re-issue (unlike the KV and ring writes, which
    rewrite the same slot with the same value) — so the engine keeps such
    lanes' old rows."""
    def sel(n, o):
        return torch.where(act.reshape((1, -1) + (1,) * (n.dim() - 2)), n, o)
    return type(new)(*(sel(n, o) for n, o in zip(new, old)))


def _freeze_ssm(new, old, act):
    """``_freeze_lanes`` on the lanes this rank's mamba state holds."""
    return _freeze_lanes(new, old, act[lane_slice(old.h, 1, act.shape[0])])


def _attention_layers(cfg, params, state, x, positions, mrope, attn, ops):
    """The dense, moe and vlm families' layers in order: gemma3's local
    layers attend over their ring, every other layer over the paged KV
    (the reference's superblock scan in _gemma_layers visits them in the
    same order).  ``attn(h, ap, j, mrope)`` is paged layer j's attention.
    Returns (x, ring_pos' or None)."""
    B = x.shape[0]
    n_ring = 0
    n_paged = 0
    for i in range(cfg.num_layers):
        with span("model.layer"):
            lpp = nn.layer_slice(params["layers"], i)
            h = nn.rmsnorm(lpp["ln1"], x)
            if lm.layer_window(cfg, i):
                x = x + ops.ring(h, lpp["attn"], state["ring_k"][n_ring],
                                 state["ring_v"][n_ring], state["ring_pos"],
                                 positions)
                n_ring += 1
            else:
                x = x + attn(h, lpp["attn"], n_paged, mrope)
                n_paged += 1
            x = x + ops.ffn(lpp, nn.rmsnorm(lpp["ln2"], x))
    if not n_ring:
        return x, None
    # every lane's slot takes this step's position, after all layers
    ring_pos = state["ring_pos"].clone()
    lanes = lane_slice(ring_pos, 0, B)
    W = ring_pos.shape[1]
    p = positions[lanes]
    ring_pos[torch.arange(p.shape[0], device=p.device),
             (p % W).to(torch.int64)] = p
    return x, ring_pos


def _hybrid_layers(cfg, params, state, x, attn, ops):
    """zamba2: each group of ``shared_attn_every`` mamba layers, then the
    shared block over its own pool (invocation g writes pool g), then the
    trailing mamba layers.  Returns (x, the mamba state of every layer)."""
    every = cfg.shared_attn_every
    n_inv = HY.num_shared_invocations(cfg)
    sp = params["shared"]
    chunks = []
    for g in range(n_inv):
        x, s2 = ops.mamba(params["layers"], state["ssm"], x, g * every,
                          (g + 1) * every)
        chunks.append(s2)
        x = x + attn(nn.rmsnorm(sp["ln1"], x), sp["attn"], g, None)
        x = x + ops.mlp(sp["mlp"], nn.rmsnorm(sp["ln2"], x))
    if cfg.num_layers > n_inv * every:
        x, s2 = ops.mamba(params["layers"], state["ssm"], x, n_inv * every,
                          cfg.num_layers)
        chunks.append(s2)
    return x, ssm.MambaState(*(torch.cat(ts) for ts in zip(*chunks)))


def _encdec_layers(cfg, params, state, x, attn, ops):
    """seamless's decoder: paged causal self attention, cross attention
    over the encoder's K/V, SwiGLU MLP."""
    for i in range(cfg.num_layers):
        with span("model.layer"):
            lpp = nn.layer_slice(params["decoder"], i)
            x = x + attn(nn.rmsnorm(lpp["ln1"], x), lpp["attn"], i, None)
            x = x + ops.cross(lpp["cross"], nn.rmsnorm(lpp["ln_cross"], x),
                              state["cross_k"][i], state["cross_v"][i])
            x = x + ops.mlp(lpp["mlp"], nn.rmsnorm(lpp["ln2"], x))
    return x


def _serve_step_impl(cfg, params, state, tokens, positions, mrope=None, *,
                     S_max, page_size, rules=None):
    ops = _ops(cfg, rules)
    x = ops.embed(params, tokens)                     # [B,1,d]
    new_state = dict(state)
    act = state["active"] & ~state["aborted"]

    if cfg.family == "ssm":
        # attention-free: no page table, nothing refused
        aborts = torch.zeros_like(act)
        x, ssm2 = ops.mamba(params["layers"], state["ssm"], x, 0,
                            cfg.num_layers)
        new_state["ssm"] = _freeze_ssm(ssm2, state["ssm"], act)
    else:
        # encdec's self attention takes the plain attend_local, as in the
        # reference (_fused_kernel_reason)
        table, write_slot, aborts, bt, pg = _page_ops(
            cfg, state, positions, act, ops, S_max=S_max,
            page_size=page_size)
        new_state["table"] = table
        new_state["block_table"] = bt
        pools, scales = state["pools"], state.get("pool_scales")

        def attn(h, ap, j, mrope_j):
            return ops.attn(h, ap, pools.k[j], pools.v[j],
                            None if scales is None else (scales.k[j],
                                                         scales.v[j]),
                            pg, write_slot, positions, mrope_j)

        if cfg.family == "hybrid":
            x, ssm2 = _hybrid_layers(cfg, params, state, x, attn, ops)
            # a lane refused THIS step re-issues its token after the
            # rebuild: its recurrent state must not advance either
            new_state["ssm"] = _freeze_ssm(ssm2, state["ssm"],
                                           act & ~aborts)
        elif cfg.family == "encdec":
            x = _encdec_layers(cfg, params, state, x, attn, ops)
        else:
            x, ring_pos = _attention_layers(cfg, params, state, x,
                                            positions, mrope, attn, ops)
            if ring_pos is not None:
                new_state["ring_pos"] = ring_pos

    x = nn.rmsnorm(params["final_norm"], x)
    logits = ops.logits(params, x)
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
