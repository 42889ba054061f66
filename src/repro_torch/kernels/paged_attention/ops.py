"""Wrapper for paged attention with structural byte accounting."""
from __future__ import annotations

from repro_torch.kernels import stats as KS
from repro_torch.kernels.paged_attention.paged_attention import \
    paged_attention_kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(q, k_pages, v_pages, page_ids, lens, *, scales=None,
                    use_kernel: bool = True):
    """Two-dispatch decode attention (the slot view in ``page_ids`` was
    materialized by a separate block-table pass).  The bytes noted
    (``kernels.stats``) are the TPU kernel's structural count, kept for
    comparison with the JAX package: every (seq, kv head) lane pays all MP
    page fetches and the slot indices make one round trip.  The CUDA kernel
    skips pages with no valid token."""
    B, MP = page_ids.shape
    NP, PS, KH, D = k_pages.shape
    page_bytes = PS * D * (k_pages.element_size() + v_pages.element_size())
    if scales is not None:
        page_bytes += PS * (scales[0].element_size()
                            + scales[1].element_size())
    KS.note_bytes("probe_bytes", 2 * B * MP * 4)
    KS.note_bytes("attn_bytes", B * KH * MP * page_bytes)
    if use_kernel:
        return paged_attention_kernel(q, k_pages, v_pages, page_ids, lens,
                                      scales=scales)
    return paged_attention_ref(q, k_pages, v_pages, page_ids, lens,
                               scales=scales)


def shard_heads(q, k_pages, v_pages, shard: int, n_shards: int,
                kv_rep: int = 1):
    """Slice (q, k_pages, v_pages) to head shard ``shard`` of ``n_shards``.

    GQA grouping is contiguous (q head h reads kv head h // G), so slicing
    both head dims by equal contiguous blocks keeps every query's kv head
    in its shard.  Requires QH and KH divisible by ``n_shards`` — or, when
    the shard count exceeds the KV head count, ``kv_rep = n_shards / KH``:
    shard s keeps original head s // kv_rep."""
    QH = q.shape[1]
    KH = k_pages.shape[2]
    if kv_rep == 1:
        if QH % n_shards or KH % n_shards:
            raise ValueError(f"heads not divisible: QH={QH} KH={KH} "
                             f"n_shards={n_shards}")
        kh, k0 = KH // n_shards, shard * (KH // n_shards)
    else:
        if QH % n_shards or KH * kv_rep != n_shards:
            raise ValueError(f"invalid replication: QH={QH} KH={KH} "
                             f"n_shards={n_shards} kv_rep={kv_rep}")
        kh, k0 = 1, shard // kv_rep
    qh = QH // n_shards
    return (q[:, shard * qh:(shard + 1) * qh],
            k_pages[:, :, k0:k0 + kh],
            v_pages[:, :, k0:k0 + kh])
