"""Paged flash-decoding attention over the hash-table page pool (PyTorch
port of ``serving/paged.py``).

Layout: the physical page pool is [n_pages, page_size, n_kv, hd] per layer
(stacked [L, ...] in the engine state).  The pages of all sequences are
compacted into one [CAP] list, attended against their owning sequence's
query, then merged per sequence by log-sum-exp.  On a mesh each rank holds
``npr`` pages of the pool (page ``slot`` lives on rank ``slot // npr``, row
``slot % npr``), runs these functions on its own pages with its
``chip_idx``, and ``merge_global`` merges the ranks' partials; on one
device ``chip_idx`` is 0 and ``npr`` is the whole pool.

``write_token_kv`` updates the pools IN PLACE (``index_put_``) instead of
returning new arrays: a decode step writes one token per lane, and copying
the pool for that would cost its whole size.  ``attend_local`` is the plain
PyTorch path of the engine's ``fused_kernel=False``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.device import host_nonzero
from repro_torch.dist import collectives as C
from repro_torch.obs.trace import span

NEG_INF = -1e30


class PagedPools(NamedTuple):
    k: torch.Tensor   # [L, n_pages, page_size, n_kv, hd]
    v: torch.Tensor


class PoolScales(NamedTuple):
    """Per-(page, token, head) dequant scales for int8 KV pools."""
    k: torch.Tensor   # bf16 [L, n_pages, page_size, n_kv]
    v: torch.Tensor


def round_pages(n: int, n_chips: int) -> int:
    return max(1, -(-n // n_chips)) * n_chips


def quantize_kv(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, n_kv, hd] -> (int8 values, bf16 scales [B, n_kv])."""
    xf = x.float()
    s = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s.to(torch.bfloat16)


# The pools' logical axes: the gspmd layout shards the page dim over every
# mesh axis; the fused manual layout (serve_manual_rules) shards pages over
# (pod, data) and KV heads over model, each rank attending its own heads
# end to end (the head dim tiled to n_kv·rep when the model axis is wider
# than n_kv, dist/tp.decode_kv_rep).
POOL_AXES = ("layer", "pages", None, None, None)
POOL_SCALE_AXES = ("layer", "pages", None, None)
POOL_AXES_TP = ("layer", "pages", None, "kv", None)
POOL_SCALE_AXES_TP = ("layer", "pages", None, "kv")


class LocalPages(NamedTuple):
    """Compacted page list (computed once per serve step)."""
    rows: torch.Tensor    # int32[CAP] pool row (clamped)
    seq: torch.Tensor     # int32[CAP] owning sequence (B = trash)
    page: torch.Tensor    # int32[CAP] logical page id
    valid: torch.Tensor   # bool[CAP]


def compact_local(slots: torch.Tensor, chip_idx: int, npr: int,
                  cap: int) -> LocalPages:
    """slots int32[B, maxP] physical slots (-1 absent).  Select the pages
    chip ``chip_idx`` owns and compact them into [cap] entries (the rest
    goes to a trash entry at index ``cap``)."""
    B, maxP = slots.shape
    dev = slots.device
    flat = slots.reshape(-1).to(torch.int64)
    mine = (flat >= 0) & (torch.div(flat, npr, rounding_mode="floor")
                          == chip_idx)
    pos = torch.cumsum(mine.to(torch.int64), 0) - 1
    keep = mine & (pos < cap)
    dst = torch.where(keep, pos, cap)
    idx = torch.arange(B * maxP, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    rows = torch.zeros((cap + 1,), **i32)
    rows[dst] = torch.where(keep, flat % npr, 0).to(torch.int32)
    seq = torch.full((cap + 1,), B, **i32)
    seq[dst] = torch.where(keep, idx // maxP, B).to(torch.int32)
    page = torch.zeros((cap + 1,), **i32)
    page[dst] = torch.where(keep, idx % maxP, 0).to(torch.int32)
    valid = torch.zeros((cap + 1,), dtype=torch.bool, device=dev)
    valid[dst] = keep
    return LocalPages(rows=rows[:cap],
                      seq=torch.where(valid[:cap], seq[:cap], B),
                      page=page[:cap], valid=valid[:cap])


class WritePlan(NamedTuple):
    """Where one token's K/V goes: the lanes that write, and their pool
    row and in-page offset."""
    lanes: torch.Tensor   # int64[n] writing lanes
    rows: torch.Tensor    # int64[n]
    offs: torch.Tensor    # int64[n]


def write_plan(write_slot, positions, chip_idx: int, npr: int,
               page_size: int) -> WritePlan:
    """The lanes with ``write_slot >= 0`` on this chip.  Selecting them
    sizes a tensor from device data: one host sync, so the engine builds
    the plan once per token and every layer reuses it."""
    with span("model.kv_write_plan"):
        ws = write_slot.to(torch.int64)
        mine = (ws >= 0) & (torch.div(ws, npr, rounding_mode="floor")
                            == chip_idx)
        lanes = host_nonzero(mine)
        return WritePlan(lanes=lanes, rows=ws[lanes] % npr,
                         offs=positions.to(torch.int64)[lanes] % page_size)


def write_token_kv(pool_k_l, pool_v_l, k_new, v_new, write_slot, positions,
                   chip_idx: int, npr: int, page_size: int, scales=None,
                   plan: WritePlan = None):
    """Write one token's K/V [B, n_kv, hd] IN PLACE into the page each
    sequence's current position maps to.  With int8 pools, ``scales`` is
    (k_scale_l, v_scale_l) [npr, psize, kv], also written in place.

    ``write_slot = -1`` is the allocator's refusal: such lanes do not
    write — they are left out of the write plan, so a -1 can never wrap
    into the last page.  ``plan`` is ``write_plan(write_slot, ...)``
    when the caller has it.  Returns the pools (and scales) for symmetry
    with the reference."""
    with span("model.kv_write"):
        if plan is None:
            plan = write_plan(write_slot, positions, chip_idx, npr, page_size)
        lanes, rows, offs = plan
        if pool_k_l.dtype == torch.int8:
            k_q, k_s = quantize_kv(k_new)
            v_q, v_s = quantize_kv(v_new)
            k_scale_l, v_scale_l = scales
            pool_k_l[rows, offs] = k_q[lanes]
            pool_v_l[rows, offs] = v_q[lanes]
            k_scale_l[rows, offs] = k_s[lanes]
            v_scale_l[rows, offs] = v_s[lanes]
            return pool_k_l, pool_v_l, (k_scale_l, v_scale_l)
        pool_k_l[rows, offs] = k_new[lanes].to(pool_k_l.dtype)
        pool_v_l[rows, offs] = v_new[lanes].to(pool_v_l.dtype)
        return pool_k_l, pool_v_l, None


def attend_local(q_all, pool_k_l, pool_v_l, lp: LocalPages, positions,
                 page_size: int, scales=None, scale=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial attention over the compacted pages.

    q_all [B, n_kv, G, hd]; pools [npr, psize, n_kv, hd]; positions [B];
    ``scale`` the softmax scale (None: 1/sqrt(hd)).
    Returns per-sequence partials (o [B,kv,G,hd] f32, m [B,kv,G],
    l [B,kv,G])."""
    B = q_all.shape[0]
    _, psize, n_kv, hd = pool_k_l.shape
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    rows = lp.rows.to(torch.int64)

    k_loc = pool_k_l[rows]                            # [CAP, psize, kv, hd]
    v_loc = pool_v_l[rows]
    if pool_k_l.dtype == torch.int8:
        k_scale_l, v_scale_l = scales
        k_loc = k_loc.float() * k_scale_l[rows].float()[..., None]
        v_loc = v_loc.float() * v_scale_l[rows].float()[..., None]
    seq_c = lp.seq.clamp(max=B - 1).to(torch.int64)
    q_pages = q_all[seq_c]                            # [CAP, kv, G, hd]
    s = torch.einsum("ckgd,cskd->ckgs", q_pages.float(),
                     k_loc.float()) * scale
    tpos = (lp.page[:, None].to(torch.int64) * page_size
            + torch.arange(psize, device=q_all.device)[None, :])
    ok = lp.valid[:, None] & (tpos <= positions[seq_c][:, None])
    okm = ok[:, None, None, :]
    s = torch.where(okm, s, torch.full_like(s, NEG_INF))
    m_p = s.amax(dim=-1)                              # [CAP,kv,G]
    p = torch.where(okm, torch.exp(s - m_p[..., None]), torch.zeros_like(s))
    l_p = p.sum(dim=-1)
    o_p = torch.einsum("ckgs,cskd->ckgd", p, v_loc.float())

    # per-sequence lse merge (scatter-max then weighted sums), row B =
    # trash.  compact_local lists the pages sequence by sequence (the trash
    # entries last), so each sequence's pages are one segment and
    # segment_reduce sums them in index order, as index_add_ does on the
    # CPU, with no atomics: index_add_ on CUDA floats adds in the order its
    # atomics land, and a decode step would give other bits from run to run
    seq_i = lp.seq.to(torch.int64)
    m_seq = torch.full((B + 1,) + m_p.shape[1:], NEG_INF,
                       dtype=torch.float32, device=q_all.device)
    m_seq.scatter_reduce_(0, seq_i[:, None, None].expand_as(m_p), m_p,
                          reduce="amax")
    w = torch.where(lp.valid[:, None, None], torch.exp(m_p - m_seq[seq_c]),
                    torch.zeros_like(m_p))
    lengths = (seq_i[None, :] == torch.arange(
        B + 1, device=q_all.device)[:, None]).sum(dim=1)
    l_seq = torch.segment_reduce(l_p * w, "sum", lengths=lengths, axis=0,
                                 unsafe=True)
    o_seq = torch.segment_reduce(o_p * w[..., None], "sum", lengths=lengths,
                                 axis=0, unsafe=True)
    return o_seq[:B], m_seq[:B], l_seq[:B]


def merge_global(o, m, l, axis_names=()) -> torch.Tensor:
    """lse-weighted merge of the (o, m, l) partials across the ranks of
    ``axis_names`` (``()``: one device, normalize only), as the reference:
    pmax of m, weights ``exp(m - m_g)``, the o partial summed in bf16
    (half the wire of f32; m and l stay f32, hd times smaller).  A rank
    that owns no page of a sequence holds m = -1e30, l = 0, so its weight
    is 0 and ``exp`` stays finite."""
    if axis_names:
        m_g = C.pmax(m, axis_names)
        w = torch.exp(m - m_g)
        o = C.psum((o * w[..., None]).to(torch.bfloat16),
                   axis_names).float()
        l = C.psum(l * w, axis_names)
    return o / l.clamp_min(1e-20)[..., None]


def capacity(B: int, maxP: int, n_chips: int,
             factor: float = 2.0) -> int:
    """Compacted-page capacity: ``factor``x the uniform share (+8 slack),
    rounded to 8, at most B*maxP."""
    mean = B * maxP / n_chips
    cap = int(mean * factor) + 8
    return min(B * maxP, -(-cap // 8) * 8)
