"""Wrapper for the mamba state-update kernel (``csrc/mamba_state.cu``),
with structural byte accounting (``kernels.stats``).

One launch a mamba layer and decode token reads each row of the layer's
float32 state ``h`` once, writes it back in place for the lanes that
move, and reduces ``C.h`` into the layer's output on the way; the source
note gives the bound and the design.  ``models/ssm.mamba_decode_step_``
launches it whenever the state is on the card, and runs
``ref.mamba_state_plain`` off it.  The wrapper launches the kernel or
raises, before it loads the library, on tensors the kernel does not take
(CPU tensors, the dtypes, contiguity, N not a multiple of 4 up to 256).
``mamba_state_kernel.launches`` counts launches.  No call waits for the
card: the bytes are counted from shapes alone."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import stats as KS
from repro_torch.obs.trace import span

MAX_STATE = 256             # N: one or two float4s a lane
ACT_DTYPES = (torch.float32, torch.bfloat16)


def state_bytes(h) -> int:
    """The least device traffic of one call: ``h`` read once and written
    once in float32."""
    return 2 * h.numel() * 4


def _refusal(h, dA, dtp, xs, bc, D, keep) -> Optional[str]:
    """Why the kernel does not take these tensors, or None."""
    if h.dim() != 5:
        return f"h [B,G,Hg,P,N] expected, got {tuple(h.shape)}"
    Bsz, G, Hg, P, N = h.shape
    if N % 4 or not 4 <= N <= MAX_STATE or P < 1:
        return f"N must be a multiple of 4 up to {MAX_STATE} and P >= 1, " \
               f"got N {N}, P {P}"
    want = {"h": (h, torch.float32, (Bsz, G, Hg, P, N)),
            "dA": (dA, torch.float32, (Bsz, G, Hg)),
            "dtp": (dtp, torch.float32, (Bsz, G, Hg)),
            "xs": (xs, xs.dtype, (Bsz, G * Hg * P)),
            "bc": (bc, xs.dtype, (Bsz, 2 * G * N)),
            "D": (D, torch.float32, (G * Hg,)),
            "keep": (keep, torch.bool, (Bsz,))}
    if xs.dtype not in ACT_DTYPES:
        return f"activation dtype {xs.dtype} not in {ACT_DTYPES}"
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            return f"{name}: {dtype} {shape} expected, got {t.dtype} " \
                   f"{tuple(t.shape)}"
        if t.device != h.device:
            return f"{name} on {t.device}, h on {h.device}"
        if not t.is_contiguous():
            return f"{name} is not contiguous"
    if h.data_ptr() % 16:
        return "h is not 16-byte aligned"
    if not h.is_cuda:
        return f"h on {h.device}, not on a CUDA card"
    return None


def mamba_state_kernel(h, dA, dtp, xs, bc, D, keep):
    """``ref.mamba_state_plain``'s function (same arguments, same result)
    through the kernel: ``h`` the same bits, ``y`` within the order of the
    ``C.h`` sum.  Raises on tensors the kernel does not take."""
    with span("kernels.mamba_state"):
        why = _refusal(h, dA, dtp, xs, bc, D, keep)
        if why is not None:
            raise ValueError(f"mamba_state_kernel: {why}")
        Bsz, G, Hg, P, N = h.shape
        y = torch.empty((Bsz, G * Hg * P), dtype=torch.float32,
                        device=h.device)
        lib = _build.library()
        rc = lib.mamba_state_launch(
            _build.ptr(h), _build.ptr(dA), _build.ptr(dtp), _build.ptr(xs),
            _build.ptr(bc), _build.ptr(D), _build.ptr(keep), _build.ptr(y),
            Bsz, G, Hg, P, N, _build.DTYPE_CODE[xs.dtype],
            _build.stream(h.device))
        _build.check(rc, "mamba_state_kernel")
        KS.note_bytes("ssm_state_bytes", state_bytes(h))
        mamba_state_kernel.launches += 1
        return y


mamba_state_kernel.launches = 0
