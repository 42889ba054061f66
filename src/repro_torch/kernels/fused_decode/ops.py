"""Wrapper for the fused block-table-walk + paged-attention kernel, with
structural byte accounting (``kernels.stats``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import stats as KS
from repro_torch.kernels.fused_decode.fused import fused_decode_kernel
from repro_torch.kernels.fused_decode.ref import fused_decode_ref


def _note_fused_bytes(q, k_pages, v_pages, block_table, positions, scales):
    """Structural accounting for ONE fused call: the raw block-table rows
    are read once, and only live pages — ``p·PS <= pos`` with a present
    entry — are read, per kv head."""
    B, MP = block_table.shape
    _, PS, KH, D = k_pages.shape
    page_bytes = PS * D * (k_pages.element_size() + v_pages.element_size())
    if scales is not None:
        page_bytes += PS * (scales[0].element_size()
                            + scales[1].element_size())
    logical = torch.arange(MP, device=block_table.device)
    live = logical[None, :] * PS <= positions[:, None]
    fetched = int((live & (block_table >= 0)).sum())
    KS.note_bytes("probe_bytes", B * MP * 4)
    KS.note_bytes("attn_bytes", fetched * KH * page_bytes)


def fused_paged_attention(q, k_pages, v_pages, block_table, positions, *,
                          scales=None, partials: bool = False,
                          use_kernel: bool = True):
    """One-dispatch decode attention over the RAW incremental block table.
    ``use_kernel=False`` routes to the two-dispatch composition
    (``fused_decode_ref``: slots view, then K2) — the fused kernel's
    normalized output is bitwise identical to it on the card.

    Returns [B,QH,D], or the unnormalized (o, m, l) triple for
    ``serving/paged.merge_global`` when ``partials=True``."""
    _note_fused_bytes(q, k_pages, v_pages, block_table, positions, scales)
    if use_kernel:
        return fused_decode_kernel(q, k_pages, v_pages, block_table,
                                   positions, scales=scales,
                                   partials=partials)
    if partials:
        raise ValueError("the two-dispatch composition has no partials mode")
    return fused_decode_ref(q, k_pages, v_pages, block_table, positions,
                            scales=scales)


def merge_fused_partials(o, m, l):
    """Finish of the partials triple — ``serving/paged.merge_global`` with
    no mesh axes (normalize only)."""
    return o / l.clamp_min(1e-20)[..., None]
