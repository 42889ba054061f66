"""Fused block-table-walk + paged-attention decode kernel K1: the CUDA
kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/fused_decode/fused.py``
``_fused_kernel``.  One launch per decode token and layer walks the RAW
incremental block table, derives page liveness in the kernel
(``p·PS <= pos`` and ``bt[b,p] >= 0``) and reads only live pages.  The
kernel is ``repro_torch/csrc/paged_decode.cu`` ``fused_decode_kernel``; its
source note gives the bound (bytes: live K/V pages plus the block-table
rows, over the card's memory rate) and the design: one CTA per (sequence,
kv head) with the page loop inside the block, each page walked in 32-token
chunks so shared memory stays at 32 KB for any page size (two whole
256-token pages, as the TPU kernel held them, would not fit in a Hopper
block), and one page-step function shared with K2 so that K1 equals the
slots-view-then-K2 composition bit for bit.

For CPU tensors the wrapper runs the plain version
(``ref.fused_decode_plain``); for CUDA tensors it launches the kernel or
raises.  ``fused_decode_kernel.launches`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_decode.ref import fused_decode_plain
from repro_torch.kernels.paged_attention.paged_attention import \
    check_decode_inputs


def fused_decode_kernel(q, k_pages, v_pages, block_table, positions, *,
                        scales=None, partials: bool = False):
    """q [B,QH,D]; pools [NP,PS,KH,D] (contiguous, e.g. one layer of the
    engine's [L,...] pool); block_table int32[B,MP] RAW cache rows (-1
    absent; liveness comes from ``positions``); positions int32[B] (attends
    tokens <= positions[b]); ``scales``: optional (k_scales, v_scales)
    [NP,PS,KH] bf16 for int8 pools.

    Returns [B,QH,D] (q's dtype), or with ``partials=True`` the f32 triple
    (o [B,KH,G,D], m [B,KH,G], l [B,KH,G])."""
    check_decode_inputs("fused_decode_kernel", q, k_pages, v_pages,
                        block_table, positions, scales)
    if q.device.type == "cpu":
        return fused_decode_plain(q, k_pages, v_pages, block_table,
                                  positions, scales=scales,
                                  partials=partials)
    B, QH, D = q.shape
    NP, PS, KH, _ = k_pages.shape
    G = QH // KH
    if partials:
        f32 = dict(dtype=torch.float32, device=q.device)
        out = None
        o = torch.empty((B, KH, G, D), **f32)
        m = torch.empty((B, KH, G), **f32)
        l = torch.empty((B, KH, G), **f32)
    else:
        out = torch.empty_like(q)
        o = m = l = None
    ks, vs = scales if scales is not None else (None, None)
    lib = _build.library()
    rc = lib.fused_decode_launch(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(ks), _build.ptr(vs), _build.ptr(block_table),
        _build.ptr(positions), B, KH, G, D, block_table.shape[1], NP, PS,
        float(D ** -0.5), _build.DTYPE_CODE[q.dtype],
        _build.DTYPE_CODE[k_pages.dtype], int(partials), _build.ptr(out),
        _build.ptr(o), _build.ptr(m), _build.ptr(l), _build.stream(q.device))
    _build.check(rc, "fused_decode_kernel")
    fused_decode_kernel.launches += 1
    return (o, m, l) if partials else out


fused_decode_kernel.launches = 0
