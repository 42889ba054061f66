"""Mamba2 (SSD — state-space duality) block (PyTorch port of
``models/ssm.py``).

Prefill runs the SSD chunked algorithm (arXiv:2405.21060): within a chunk
of length Q everything is dense products; across chunks a small recurrent
state h [B,G,Hg,P,N] is carried by a Python loop over the chunks (the
reference's ``lax.scan``).  Decode is the O(1)-per-token recurrence:
``mamba_decode_step_`` writes the new state into the state it is given,
in place (on the card through one hand-written kernel,
``kernels/mamba_state``), leaving the lanes it is told to keep as they
were; ``mamba_decode_step``, the reference's function, runs it on a copy
and returns the copy.  The in-projection is split into z / x / BC / dt
matrices, as in the reference.

On a mesh the decode can run on a head shard of the inner dimension
(``tp_axis``), completing the gated norm and the out projection with
psums over that axis.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as C
from repro_torch.kernels import mamba_state as MS
from repro_torch.models import nn
from repro_torch.obs.trace import span


class MambaState(NamedTuple):
    """Decode-time recurrent state for one layer (stackable over layers)."""
    h: torch.Tensor          # f32[B, G, Hg, P, N] SSD state
    conv_x: torch.Tensor     # [B, W-1, di]        conv tail, x stream
    conv_bc: torch.Tensor    # [B, W-1, 2*G*N]     conv tail, B/C streams


MAMBA_STATE_AXES = MambaState(
    h=("batch", None, "ssm_heads", None, None),
    conv_x=("batch", None, "ssm_inner"),
    conv_bc=("batch", None, None),
)


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
    [B,G,Hg,P,N]).  A length that is no multiple of the chunk ends in a
    shorter chunk."""
    Bsz, S, G, Hg, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    h = h0 if h0 is not None else torch.zeros(
        (Bsz, G, Hg, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(-(-S // Q)):
        sl = slice(c * Q, min((c + 1) * Q, S))
        if sl.stop - sl.start < Q:        # a shorter last chunk
            causal = causal[:sl.stop - sl.start, :sl.stop - sl.start]
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


def _gate_norm_out(p, y, z, x_dtype, *, tp_axis=None, di_full=None,
                   eps: float = 1e-6):
    """Mamba2 gated RMSNorm + out projection.  y, z [B,S,di].

    With ``tp_axis``, y/z/norm/w_out carry this rank's ``di`` shard: the
    RMS statistic is completed by a psum over the full width ``di_full``
    and the row-parallel out projection psums its partial products in
    f32, rounded once after the sum (as the reference: per-shard rounding
    would drift from the replicated path, and the recurrence amplifies
    it)."""
    y = y * F.silu(z.float())
    if tp_axis is None:
        var = (y * y).mean(dim=-1, keepdim=True)
    else:
        var = C.psum((y * y).sum(dim=-1, keepdim=True), tp_axis) / di_full
    y = (y * torch.rsqrt(var + eps)).to(x_dtype) * p["norm"]
    if tp_axis is None:
        return y @ p["w_out"]
    out = y.float() @ p["w_out"].float()
    return C.psum(out, tp_axis).to(y.dtype)


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
    out = _gate_norm_out(p, y.reshape(Bsz, S, di).float(), z, x.dtype,
                         eps=cfg.rms_norm_eps)
    if return_state:
        return out, MambaState(h=h_fin, conv_x=new_tail_x,
                               conv_bc=new_tail_bc)
    return out


def mamba_decode_step(p, x, cfg, state: MambaState, *,
                      tp_axis: Optional[str] = None
                      ) -> Tuple[torch.Tensor, MambaState]:
    """One-token decode.  x [B,1,d] -> ([B,1,d], state'): the reference's
    function, ``mamba_decode_step_`` on a copy of ``state`` with every
    lane kept; ``state`` is left as it was."""
    new = MambaState(*(t.clone(memory_format=torch.contiguous_format)
                       for t in state))
    keep = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    return mamba_decode_step_(p, x, cfg, new, keep, tp_axis=tp_axis), new


def mamba_decode_step_(p, x, cfg, state: MambaState, keep, *,
                       tp_axis: Optional[str] = None) -> torch.Tensor:
    """One-token decode that writes the layer's new state into ``state``
    (views of one layer of the stacked state) in place.  x [B,1,d] ->
    [B,1,d].  A lane whose ``keep`` [B] is False keeps its state bit for
    bit: its conv tails are written back unchanged, and its recurrence
    runs with ``dA = 1`` and an increment of ``-0.0`` (the exact identity
    of IEEE addition, signed zeros included); its output is still the
    advanced state's, rebuilt from the small tensors.

    ``tp_axis``: run on this rank's per-head SHARD of the inner dim (the
    mesh layouts of ``serving/engine``): the per-head params
    (w_z/w_x/w_dt/conv_x/A/D/norm) and the state arrive column-sharded,
    the shared B/C streams replicated (G == 1, which
    ``dist/tp.decode_ssm_tp`` requires), and ``w_out`` is row-parallel with
    the psums in ``_gate_norm_out``.  The local dims come from the param
    shapes, so the same code runs replicated (``tp_axis=None``).

    The recurrence and its read-out are one launch of the mamba state
    kernel (``kernels/mamba_state``) on the card, which raises on shapes it
    does not take, and its plain version, the same arithmetic in PyTorch
    ops, off the card: ``h`` takes the same bits either way."""
    Bsz = x.shape[0]
    G = cfg.ssm_groups
    di = p["w_x"].shape[1]
    Hg = p["w_dt"].shape[1] // G
    with span("model.mamba.in_proj"):
        z, xs, bc, dt = _in_proj(p, x)
    with span("model.mamba.conv"):
        xs, tail_x = _causal_conv(xs, p["conv_x_w"], p["conv_x_b"],
                                  state.conv_x)
        bc, tail_bc = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"],
                                   state.conv_bc)
        k3 = keep[:, None, None]
        state.conv_x.copy_(torch.where(k3, tail_x, state.conv_x))
        state.conv_bc.copy_(torch.where(k3, tail_bc, state.conv_bc))
    with span("model.mamba.state"):
        dtp = _softplus(dt[:, 0].float() + p["dt_bias"][None]).reshape(
            Bsz, G, Hg)
        A = -torch.exp(p["A_log"]).reshape(G, Hg)
        dA = torch.exp(dtp * A[None])                       # [B,G,Hg]
        args = (state.h, dA, dtp, xs[:, 0], bc[:, 0], p["D"], keep)
        y = (MS.mamba_state_kernel(*args) if state.h.is_cuda
             else MS.mamba_state_plain(*args))
    with span("model.mamba.out"):
        return _gate_norm_out(p, y.reshape(Bsz, 1, di), z, x.dtype,
                              tp_axis=tp_axis, di_full=cfg.d_inner,
                              eps=cfg.rms_norm_eps)


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
