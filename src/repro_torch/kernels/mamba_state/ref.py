"""Plain PyTorch version of the mamba state-update kernel: the recurrence
of one decode token written into ``h`` in place, and its read-out.

This is the arithmetic ``models/ssm.mamba_decode_step_`` runs off the
card: the kernel is held to it bit for bit in ``h`` and within summation
order in ``y``."""
from __future__ import annotations

import torch


def mamba_state_plain(h, dA, dtp, xs, bc, D, keep):
    """h f32[B,G,Hg,P,N], updated in place; dA, dtp f32[B,G,Hg]; xs
    [B, G*Hg*P] and bc [B, 2*G*N] (B's streams, then C's) in the
    activation dtype; D f32[G*Hg]; keep bool[B].  Returns y f32[B, G*Hg*P]:
    ``C.h'`` plus the skip ``x.D``, rounded through the activation dtype.

    A lane whose ``keep`` is False keeps its ``h`` bit for bit: its
    recurrence runs with ``dA = 1`` and an increment of ``-0.0`` (the exact
    identity of IEEE addition, signed zeros included); its output is still
    the advanced state's, rebuilt from the small tensors."""
    Bsz, G, Hg, P, N = h.shape
    x_ssm = xs.reshape(Bsz, G, Hg, P)
    Bm = bc[:, :G * N].reshape(Bsz, G, N)
    Cm = bc[:, G * N:].reshape(Bsz, G, N)
    k3 = keep[:, None, None]
    k4 = keep[:, None, None, None]
    xdt = x_ssm.float() * dtp[..., None]
    h.mul_(torch.where(k3, dA, 1.0)[..., None, None]).add_(
        torch.einsum("bgn,bghp->bghpn", torch.where(k3, Bm.float(), 1.0),
                     torch.where(k4, xdt, -0.0)))
    y = torch.einsum("bgn,bghpn->bghp", Cm.float(), h)
    # a frozen lane's output as if its state had advanced, C.h' =
    # dA (C.h) + (C.B) xdt, from the small tensors alone
    cb = torch.einsum("bgn,bgn->bg", Cm.float(), Bm.float())
    y = torch.where(k4, y, y * dA[..., None] + cb[:, :, None, None] * xdt)
    y = y + x_ssm.float() * D.reshape(G, Hg)[None, ..., None]
    # the prefill path's round trip through the activation dtype
    # (ssd_chunked casts y), so decode tracks forward closely
    return y.to(xs.dtype).float().reshape(Bsz, G * Hg * P)
