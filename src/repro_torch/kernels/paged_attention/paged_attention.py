"""Paged-attention decode kernel K2: the CUDA kernel's wrapper, and the
launch shared with K1.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention/
paged_attention.py`` ``_pa_kernel``.  The kernel is
``repro_torch/csrc/paged_decode.cu`` (``decode_attention_launch``); its
source note gives the bound (bytes: the valid tokens' K/V over the card's
memory rate) and the design: flash decoding, with the live pages of each
(sequence, kv head) split across ``S`` CTAs (``split_count``), each walking
its range in token tiles through a ``cp.async`` ring, then a second kernel
merging the ``S`` partials in a fixed order.  K1 runs the same kernel body;
only the per-sequence control value differs (positions for K1, lengths
here), so K1 equals the slots-view-then-K2 composition bit for bit.

For CPU tensors the wrapper runs the plain version
(``ref.paged_attention_ref``).  For CUDA tensors it launches the kernel or
raises; nothing falls back.  ``paged_attention_kernel.launches`` counts
wrapper calls that launched: one per call, though each call makes two CUDA
launches (split and merge).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

Q_DTYPES = (torch.float32, torch.bfloat16)
KV_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
# the kernel keeps ceil(D/32) dims of q and of the output per lane in
# registers, for up to 8 query heads at once
MAX_HEAD_DIM = 256
# split layout: token slots a split covers at most, and the most splits
SPLIT_TOKENS = 512
MAX_SPLITS = 16


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
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} > {MAX_HEAD_DIM}")
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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_count(B: int, KH: int, MP: int, PS: int, sms: int) -> int:
    """Splits per (sequence, kv head), from static shapes only: enough CTAs
    for two per SM, and at most ``SPLIT_TOKENS`` token slots of the
    block-table row per split (so one long sequence does not hold the
    card alone), within [1, min(MP, MAX_SPLITS)]."""
    want = max(-(-2 * sms // max(B * KH, 1)), -(-MP * PS // SPLIT_TOKENS))
    return max(1, min(want, MP, MAX_SPLITS))


def launch_decode(name, q, k_pages, v_pages, rows, ctl, scales, *,
                  from_positions: bool, partials: bool, scale=None):
    """Launch the split decode kernel and its merge on q's stream.  ``rows``
    int32[B,MP] page rows; ``ctl`` int32[B], the positions (K1,
    ``from_positions=True``: attends ``ctl+1`` tokens) or the lengths (K2);
    ``scale`` the softmax scale (None: D ** -0.5).
    Returns [B,QH,D] in q's dtype, or the f32 (o, m, l) partials."""
    lib = _build.library()
    B, QH, D = q.shape
    NP, PS, KH, _ = k_pages.shape
    G, MP = QH // KH, rows.shape[1]
    S = split_count(B, KH, MP, PS, _sm_count(q.device.index))
    f32 = dict(dtype=torch.float32, device=q.device)
    scratch = torch.empty((S * B * KH * G * (D + 2),), **f32)
    if partials:
        out = None
        o = torch.empty((B, KH, G, D), **f32)
        m = torch.empty((B, KH, G), **f32)
        l = torch.empty((B, KH, G), **f32)
    else:
        out = torch.empty_like(q)
        o = m = l = None
    ks, vs = scales if scales is not None else (None, None)
    rc = lib.decode_attention_launch(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(ks), _build.ptr(vs), _build.ptr(rows), _build.ptr(ctl),
        int(from_positions), B, KH, G, D, MP, NP, PS, S,
        float(D ** -0.5 if scale is None else scale),
        _build.DTYPE_CODE[q.dtype], _build.DTYPE_CODE[k_pages.dtype],
        int(partials), _build.ptr(scratch), _build.ptr(out), _build.ptr(o),
        _build.ptr(m), _build.ptr(l), _build.stream(q.device))
    _build.check(rc, name)
    return (o, m, l) if partials else out


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
    out = launch_decode("paged_attention_kernel", q, k_pages, v_pages,
                        page_ids, lens, scales, from_positions=False,
                        partials=False)
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0
