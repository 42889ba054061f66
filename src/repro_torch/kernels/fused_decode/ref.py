"""Plain PyTorch versions for the fused decode kernel (K1).

``fused_decode_plain`` computes K1's function directly: one softmax over
every live token, normalized or as the unnormalized ``(o, m, l)``
partials.  ``fused_decode_ref`` is the two-dispatch composition K1 is held
to bit for bit on the card: dispatch 1 materializes the masked slot view of
the block table (the same elementwise read as
``serving/page_table.block_table_slots``, duplicated so the kernel layer
does not import the serving layer), dispatch 2 runs K2 over it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.paged_attention import \
    paged_attention_kernel

NEG_INF = -1e30


def block_table_slots_ref(block_table, positions, *, page_size: int):
    """Masked slot view: -1 where the logical page is absent or past the
    live horizon."""
    max_pages = block_table.shape[1]
    logical = torch.arange(max_pages, dtype=torch.int32,
                           device=block_table.device)
    live = logical[None, :] <= (positions[:, None] // page_size)
    return torch.where(live & (block_table >= 0), block_table,
                       -1).to(torch.int32)


def fused_decode_plain(q, k_pages, v_pages, block_table, positions, *,
                       scales=None, partials: bool = False, scale=None):
    """K1's function in plain PyTorch: attention of q over every token
    ``tok <= positions[b]`` of the live pages of ``block_table[b]``.
    ``scale`` is the softmax scale (None: D ** -0.5).
    Returns [B,QH,D] in q's dtype, or with ``partials=True`` the f32
    (o [B,KH,G,D], m [B,KH,G], l [B,KH,G]) with ``m = -1e30, l = 0, o = 0``
    for a sequence with no live token."""
    B, QH, D = q.shape
    NP, PS, KH, _ = k_pages.shape
    MP = block_table.shape[1]
    G = QH // KH
    slots = block_table_slots_ref(block_table, positions, page_size=PS)
    safe = slots.clamp(0, NP - 1).long()
    k = k_pages[safe].reshape(B, MP * PS, KH, D).float()
    v = v_pages[safe].reshape(B, MP * PS, KH, D).float()
    if scales is not None:
        k = k * scales[0][safe].reshape(B, MP * PS, KH).float()[..., None]
        v = v * scales[1][safe].reshape(B, MP * PS, KH).float()[..., None]
    tok = torch.arange(MP * PS, device=q.device)[None, :]
    valid = ((tok <= positions[:, None])
             & torch.repeat_interleave(slots >= 0, PS, dim=1))
    vmask = valid[:, None, None, :]
    qg = q.reshape(B, KH, G, D).float()
    s = torch.einsum("bhgd,blhd->bhgl", qg, k) * (
        D ** -0.5 if scale is None else scale)
    s = torch.where(vmask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(vmask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    o = torch.einsum("bhgl,blhd->bhgd", p, v)
    if partials:
        return o, m, l
    norm = torch.where(l > 0, 1.0 / l.clamp_min(1e-30), torch.zeros_like(l))
    return (o * norm[..., None]).reshape(B, QH, D).to(q.dtype)


def merge_split_partials(o_s, m_s, l_s):
    """The merge of the CUDA kernel's split partials, in plain PyTorch:
    o_s [S,B,KH,G,D], m_s and l_s [S,B,KH,G] (split s over its own range
    of live pages, ``m = -1e30, l = 0, o = 0`` where it has none) ->
    the f32 (o, m, l) of all splits, summed in the order s = 0..S-1:
    ``m = max m_s``, ``w_s = exp(m_s - m)``, ``l = sum w_s l_s``,
    ``o = sum w_s o_s``."""
    m = m_s.amax(dim=0)
    o = torch.zeros_like(o_s[0])
    l = torch.zeros_like(l_s[0])
    for s in range(o_s.shape[0]):
        w = torch.exp(m_s[s] - m)
        o = o + w[..., None] * o_s[s]
        l = l + w * l_s[s]
    return o, m, l


def fused_decode_ref(q, k_pages, v_pages, block_table, positions, *,
                     scales=None):
    """Separate slot-view and attention dispatches over the same raw inputs
    as ``fused_decode_kernel`` (K2 on the card, its plain version on the
    CPU)."""
    PS = k_pages.shape[1]
    slots = block_table_slots_ref(block_table, positions, page_size=PS)
    lens = (positions + 1).to(torch.int32)
    return paged_attention_kernel(q, k_pages, v_pages, slots, lens,
                                  scales=scales)
