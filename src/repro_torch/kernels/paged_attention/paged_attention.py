"""Paged-attention decode kernel K2: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention/
paged_attention.py`` ``_pa_kernel``.  The kernel is
``repro_torch/csrc/paged_decode.cu`` ``paged_attention_kernel``; its
source note gives the bound (bytes: every fetched page's K/V over the
card's memory rate) and the design (one CTA per (sequence, kv head), the
page loop inside the block, 32-token chunks, one page-step function shared
with K1).

For CPU tensors the wrapper runs the plain version
(``ref.paged_attention_ref``).  For CUDA tensors it launches the kernel or
raises; nothing falls back.  ``paged_attention_kernel.launches`` counts
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

Q_DTYPES = (torch.float32, torch.bfloat16)
KV_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def check_decode_inputs(name, q, k_pages, v_pages, rows, lens, scales):
    """Device, dtype, shape and contiguity checks shared by K1 and K2."""
    tensors = [q, k_pages, v_pages, rows, lens]
    if scales is not None:
        tensors += list(scales)
    dev = q.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input {tuple(t.shape)}")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: q [B,QH,D], pools [NP,PS,KH,D] expected, "
                         f"got {tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    B, QH, D = q.shape
    NP, PS, KH, Dk = k_pages.shape
    if Dk != D or QH % KH or rows.shape != (B, rows.shape[1]) \
            or lens.shape != (B,):
        raise ValueError(f"{name}: inconsistent shapes q {tuple(q.shape)} "
                         f"pools {tuple(k_pages.shape)} rows "
                         f"{tuple(rows.shape)} lens {tuple(lens.shape)}")
    if q.dtype not in Q_DTYPES:
        raise ValueError(f"{name}: q dtype {q.dtype} not in {Q_DTYPES}")
    if k_pages.dtype not in KV_DTYPES or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"{name}: pool dtype {k_pages.dtype}")
    if rows.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError(f"{name}: page table and lengths must be int32")
    if (k_pages.dtype == torch.int8) != (scales is not None):
        raise ValueError(f"{name}: int8 pools need scales, and only they")
    if scales is not None:
        for s in scales:
            if s.dtype != torch.bfloat16 or s.shape != (NP, PS, KH):
                raise ValueError(f"{name}: scales must be bf16 [NP,PS,KH]")


def paged_attention_kernel(q, k_pages, v_pages, page_ids, lens, *,
                           scales=None):
    """q [B,QH,D]; pools [NP,PS,KH,D]; page_ids int32[B,MP]; lens int32[B];
    ``scales``: optional (k_scales, v_scales) [NP,PS,KH] bf16 for int8
    pools.  Returns [B,QH,D] in q's dtype."""
    check_decode_inputs("paged_attention_kernel", q, k_pages, v_pages,
                        page_ids, lens, scales)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_ids, lens,
                                   scales=scales)
    B, QH, D = q.shape
    NP, PS, KH, _ = k_pages.shape
    out = torch.empty_like(q)
    ks, vs = scales if scales is not None else (None, None)
    lib = _build.library()
    rc = lib.paged_attention_launch(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(ks), _build.ptr(vs), _build.ptr(page_ids),
        _build.ptr(lens), B, KH, QH // KH, D, page_ids.shape[1], NP, PS,
        float(D ** -0.5), _build.DTYPE_CODE[q.dtype],
        _build.DTYPE_CODE[k_pages.dtype], _build.ptr(out),
        _build.stream(q.device))
    _build.check(rc, "paged_attention_kernel")
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0
