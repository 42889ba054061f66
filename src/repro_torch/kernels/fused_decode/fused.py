"""Fused block-table-walk + paged-attention decode kernel K1: the CUDA
kernel's wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/fused_decode/fused.py``
``_fused_kernel``.  One wrapper call per decode token and layer walks the
RAW incremental block table, derives page liveness in the kernel
(``p·PS <= pos`` and ``bt[b,p] >= 0``) and reads only the valid tokens of
live pages.  The kernel is ``repro_torch/csrc/paged_decode.cu``
(``decode_attention_launch``, shared with K2); its source note gives the
bound (bytes: the valid tokens' K/V over the card's memory rate) and the
design: the live pages of each (sequence, kv head) are split across ``S``
CTAs (``paged_attention.split_count``, from static shapes; each CTA finds
its page range from ``pos`` in the kernel, so there is no host sync), each
walks its range in 32-token tiles through a ``cp.async`` ring with
warp-level online softmax, and a second kernel merges the ``S``
partials in a fixed order.  K2 runs the same kernel body with ``lens =
pos + 1``, so K1 equals the slots-view-then-K2 composition bit for bit.

For CPU tensors the wrapper runs the plain version
(``ref.fused_decode_plain``); for CUDA tensors it launches the kernels or
raises.  ``fused_decode_kernel.launches`` counts wrapper calls that
launched: one per call, though each call makes two CUDA launches (split
and merge).
"""
from __future__ import annotations

from repro_torch.kernels.fused_decode.ref import fused_decode_plain
from repro_torch.kernels.paged_attention.paged_attention import (
    check_decode_inputs, launch_decode)
from repro_torch.obs.trace import span


def fused_decode_kernel(q, k_pages, v_pages, block_table, positions, *,
                        scales=None, partials: bool = False):
    """q [B,QH,D]; pools [NP,PS,KH,D] (contiguous, e.g. one layer of the
    engine's [L,...] pool); block_table int32[B,MP] RAW cache rows (-1
    absent; liveness comes from ``positions``); positions int32[B] (attends
    tokens <= positions[b]); ``scales``: optional (k_scales, v_scales)
    [NP,PS,KH] bf16 for int8 pools.

    Returns [B,QH,D] (q's dtype), or with ``partials=True`` the f32 triple
    (o [B,KH,G,D], m [B,KH,G], l [B,KH,G])."""
    with span("kernels.k1"):
        check_decode_inputs("fused_decode_kernel", q, k_pages, v_pages,
                            block_table, positions, scales)
        if q.device.type == "cpu":
            return fused_decode_plain(q, k_pages, v_pages, block_table,
                                      positions, scales=scales,
                                      partials=partials)
        out = launch_decode("fused_decode_kernel", q, k_pages, v_pages,
                            block_table, positions, scales,
                            from_positions=True, partials=partials)
        fused_decode_kernel.launches += 1
        return out


fused_decode_kernel.launches = 0
