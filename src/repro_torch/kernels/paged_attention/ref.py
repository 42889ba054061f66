"""Plain PyTorch version of the paged-attention decode kernel (K2)."""
from __future__ import annotations

import math

import torch


def paged_attention_ref(q, k_pages, v_pages, page_ids, lens, *, scales=None):
    """Decode attention over paged KV, one softmax over all pages.

    q:        [B, QH, D]      single query token per sequence
    k_pages:  [NP, PS, KH, D] physical key pool
    v_pages:  [NP, PS, KH, D] physical value pool
    page_ids: int32[B, MP]    physical page per (seq, logical page); -1 unused
    lens:     int32[B]        KV length per sequence
    scales:   optional (k_scales, v_scales) [NP, PS, KH] for int8 pools
    returns:  [B, QH, D]
    """
    B, QH, D = q.shape
    NP, PS, KH, _ = k_pages.shape
    MP = page_ids.shape[1]
    G = QH // KH

    safe_ids = page_ids.clamp(0, NP - 1).long()
    k = k_pages[safe_ids].reshape(B, MP * PS, KH, D).float()
    v = v_pages[safe_ids].reshape(B, MP * PS, KH, D).float()
    if scales is not None:
        k = k * scales[0][safe_ids].reshape(B, MP * PS, KH).float()[..., None]
        v = v * scales[1][safe_ids].reshape(B, MP * PS, KH).float()[..., None]
    pos = torch.arange(MP * PS, device=q.device)[None, :]
    valid = ((pos < lens[:, None])
             & torch.repeat_interleave(page_ids >= 0, PS, dim=1))

    qg = q.reshape(B, KH, G, D).float()
    scores = torch.einsum("bhgd,blhd->bhgl", qg, k) / math.sqrt(D)
    scores = scores.masked_fill(~valid[:, None, None, :], -math.inf)
    w = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgl,blhd->bhgd", w, v)
    return out.reshape(B, QH, D).to(q.dtype)
