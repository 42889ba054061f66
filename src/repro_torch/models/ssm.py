"""Mamba2 (SSD — state-space duality) block (PyTorch port of
``models/ssm.py``), single device.

Prefill runs the SSD chunked algorithm (arXiv:2405.21060): within a chunk
of length Q everything is dense products; across chunks a small recurrent
state h [B,G,Hg,P,N] is carried by a Python loop over the chunks (the
reference's ``lax.scan``).  Decode is the O(1)-per-token recurrence.  The
in-projection is split into z / x / BC / dt matrices, as in the reference.

The reference's decode can run on a head shard of the inner dimension
inside a manual shard_map region (``tp_axis``); that is the mesh slice,
ROADMAP item 22, and any ``tp_axis`` but ``None`` raises here.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import nn


class MambaState(NamedTuple):
    """Decode-time recurrent state for one layer (stackable over layers)."""
    h: torch.Tensor          # f32[B, G, Hg, P, N] SSD state
    conv_x: torch.Tensor     # [B, W-1, di]        conv tail, x stream
    conv_bc: torch.Tensor    # [B, W-1, 2*G*N]     conv tail, B/C streams


def mamba_init(cfg, dtype, generator: torch.Generator, device):
    """One layer's parameters in the reference's layout.  ``A_log``,
    ``dt_bias`` and ``D`` are float32 whatever ``dtype``, as the
    reference draws them."""
    d, di, N, G = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    H, W = cfg.ssm_heads, cfg.conv_width
    s = 1.0 / math.sqrt(d)
    tn = lambda shape, sc: nn.truncnorm(shape, sc, dtype, generator, device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_z": tn((d, di), s),
        "w_x": tn((d, di), s),
        "w_bc": tn((d, 2 * G * N), s),
        "w_dt": tn((d, H), s),
        "conv_x_w": tn((W, di), 0.5),
        "conv_x_b": torch.zeros((di,), dtype=dtype, device=device),
        "conv_bc_w": tn((W, 2 * G * N), 0.5),
        "conv_bc_b": torch.zeros((2 * G * N,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "dt_bias": torch.full((H,), math.log(math.e - 1), **f32),
        "D": torch.ones((H,), **f32),
        "norm": torch.ones((di,), dtype=dtype, device=device),
        "w_out": tn((di, d), 1.0 / math.sqrt(di)),
    }


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w, b, tail):
    """x [B,S,C]; w [W,C] depthwise causal conv; tail [B,W-1,C] history.
    Returns (y, new_tail).  The W shifted terms are summed in the
    reference's order, from the Python ``sum``'s 0."""
    S = x.shape[1]
    W = w.shape[0]
    xp = torch.cat([tail, x], dim=1)                   # [B, S+W-1, C]
    y = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    y = F.silu(y + b[None, None, :])
    return y, xp[:, S:, :]


def ssd_chunked(x, dt, A, Bm, Cm, D, *, chunk: int, h0=None):
    """SSD scan.  x [B,S,G,Hg,P]; dt [B,S,G,Hg] (softplus'd); A [G,Hg] (<0);
    Bm/Cm [B,S,G,N]; D [G,Hg].  Returns (y [B,S,G,Hg,P], h_fin
    [B,G,Hg,P,N])."""
    Bsz, S, G, Hg, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    h = h0 if h0 is not None else torch.zeros(
        (Bsz, G, Hg, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xc, dtc, Bc, Cc = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        dA = dtc * A[None, None]                        # [B,Q,G,Hg]
        A_cum = torch.cumsum(dA, dim=1)
        A_last = A_cum[:, -1]                           # [B,G,Hg]
        xdt = (xc * dtc[..., None]).float()
        # inter-chunk: the carried state's contribution
        y_inter = torch.einsum("bqgn,bghpn->bqghp", Cc.float(), h) \
            * torch.exp(A_cum)[..., None]
        # intra-chunk: causal decay-weighted C B^T, masked BEFORE exp as
        # the reference does (the masked exponents are positive)
        scores = torch.einsum("bign,bjgn->bijg", Cc.float(), Bc.float())
        Ldec = A_cum[:, :, None] - A_cum[:, None, :]    # [B,i,j,G,Hg]
        Ldec = torch.where(causal[None, :, :, None, None], Ldec, -1e30)
        M = torch.exp(Ldec) * scores[..., None]
        y_intra = torch.einsum("bijgh,bjghp->bighp", M, xdt)
        decay_states = torch.exp(A_last[:, None] - A_cum)   # [B,Q,G,Hg]
        S_chunk = torch.einsum("bqgn,bqghp->bghpn", Bc.float(),
                               xdt * decay_states[..., None])
        h = h * torch.exp(A_last)[..., None, None] + S_chunk
        y = y_inter + y_intra + xc.float() * D[None, None, ..., None]
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1), h


def _gate_norm_out(p, y, z, x_dtype):
    """Mamba2 gated RMSNorm + out projection.  y, z [B,S,di]."""
    y = y * F.silu(z.float())
    var = (y * y).mean(dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + 1e-6)).to(x_dtype) * p["norm"]
    return y @ p["w_out"]


def _in_proj(p, x):
    return x @ p["w_z"], x @ p["w_x"], x @ p["w_bc"], x @ p["w_dt"]


def mamba_forward(p, x, cfg, *, state: Optional[MambaState] = None,
                  return_state: bool = False):
    """Full-sequence forward.  x [B,S,d] -> [B,S,d] (+ final
    MambaState)."""
    Bsz, S, _ = x.shape
    di, N, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    Hg, P = cfg.ssm_heads // G, cfg.ssm_head_dim
    z, xs, bc, dt = _in_proj(p, x)
    W = cfg.conv_width
    tail_x = state.conv_x if state is not None else torch.zeros(
        (Bsz, W - 1, di), dtype=x.dtype, device=x.device)
    tail_bc = state.conv_bc if state is not None else torch.zeros(
        (Bsz, W - 1, 2 * G * N), dtype=x.dtype, device=x.device)
    xs, new_tail_x = _causal_conv(xs, p["conv_x_w"], p["conv_x_b"], tail_x)
    bc, new_tail_bc = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"],
                                   tail_bc)
    x_ssm = xs.reshape(Bsz, S, G, Hg, P)
    Bm = bc[..., :G * N].reshape(Bsz, S, G, N)
    Cm = bc[..., G * N:].reshape(Bsz, S, G, N)
    dtp = _softplus(dt.float() + p["dt_bias"][None, None]).reshape(
        Bsz, S, G, Hg)
    A = -torch.exp(p["A_log"]).reshape(G, Hg)
    y, h_fin = ssd_chunked(x_ssm, dtp, A, Bm, Cm, p["D"].reshape(G, Hg),
                           chunk=cfg.ssm_chunk,
                           h0=state.h if state is not None else None)
    out = _gate_norm_out(p, y.reshape(Bsz, S, di).float(), z, x.dtype)
    if return_state:
        return out, MambaState(h=h_fin, conv_x=new_tail_x,
                               conv_bc=new_tail_bc)
    return out


def mamba_decode_step(p, x, cfg, state: MambaState, *,
                      tp_axis: Optional[str] = None
                      ) -> Tuple[torch.Tensor, MambaState]:
    """One-token decode.  x [B,1,d] -> ([B,1,d], state')."""
    if tp_axis is not None:
        raise NotImplementedError(
            "the head-sharded mamba decode (tp_axis) runs over a mesh: "
            "ROADMAP item 22")
    Bsz = x.shape[0]
    N, G, P = cfg.ssm_state, cfg.ssm_groups, cfg.ssm_head_dim
    di = p["w_x"].shape[1]
    Hg = p["w_dt"].shape[1] // G
    z, xs, bc, dt = _in_proj(p, x)
    xs, new_tail_x = _causal_conv(xs, p["conv_x_w"], p["conv_x_b"],
                                  state.conv_x)
    bc, new_tail_bc = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"],
                                   state.conv_bc)
    x_ssm = xs[:, 0].reshape(Bsz, G, Hg, P)
    Bm = bc[:, 0, :G * N].reshape(Bsz, G, N)
    Cm = bc[:, 0, G * N:].reshape(Bsz, G, N)
    dtp = _softplus(dt[:, 0].float() + p["dt_bias"][None]).reshape(
        Bsz, G, Hg)
    A = -torch.exp(p["A_log"]).reshape(G, Hg)

    dA = torch.exp(dtp * A[None])                       # [B,G,Hg]
    xdt = x_ssm.float() * dtp[..., None]
    h_new = state.h * dA[..., None, None] + \
        torch.einsum("bgn,bghp->bghpn", Bm.float(), xdt)
    y = torch.einsum("bgn,bghpn->bghp", Cm.float(), h_new)
    y = y + x_ssm.float() * p["D"].reshape(G, Hg)[None, ..., None]
    # the prefill path's round trip through the activation dtype
    # (ssd_chunked casts y), so decode tracks forward closely
    y = y.to(x.dtype).float()
    out = _gate_norm_out(p, y.reshape(Bsz, 1, di), z, x.dtype)
    return out, MambaState(h=h_new, conv_x=new_tail_x, conv_bc=new_tail_bc)


def init_mamba_state(cfg, batch: int, dtype, device) -> MambaState:
    G, Hg = cfg.ssm_groups, cfg.ssm_heads // cfg.ssm_groups
    W = cfg.conv_width
    return MambaState(
        h=torch.zeros((batch, G, Hg, cfg.ssm_head_dim, cfg.ssm_state),
                      dtype=torch.float32, device=device),
        conv_x=torch.zeros((batch, W - 1, cfg.d_inner), dtype=dtype,
                           device=device),
        conv_bc=torch.zeros((batch, W - 1, 2 * G * cfg.ssm_state),
                            dtype=dtype, device=device),
    )
