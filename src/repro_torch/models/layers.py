"""Shared model layers (PyTorch port of ``models/layers.py``): RoPE and
M-RoPE, GQA attention, encoder-decoder cross attention, SwiGLU MLP and
the pre-norm block.

``flash_attention`` keeps the reference's signature and semantics (causal
mask, sliding window, ``q_offset``, GQA in grouped form) and computes its
forward in plain PyTorch, one query chunk at a time with one f32 softmax
over the keys the chunk may attend to.  Its backward is autograd through
that forward: it keeps each query chunk's probabilities, O(Sq·Sk) per
call, where the reference's custom VJP recomputes them chunk by chunk;
under ``remat`` (``nn.remat``, per layer) only the layer being
differentiated holds them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import to_card
from repro_torch.models import nn
from repro_torch.obs.trace import span

DEFAULT_Q_CHUNK = 512
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE.

def _rope_freq(half: int, theta: float, device):
    """theta ** (-i / half) for i < half, in f32.  Copying theta to the
    card waits for it (a counted host sync)."""
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(to_card(theta, device, torch.float32), exps)


def _rope_angles(positions, dims: int, theta: float):
    """positions [...] -> (sin, cos) [..., dims//2]."""
    freq = _rope_freq(dims // 2, theta, positions.device)
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def _rotate(x, sin, cos):
    """x [B,S,H,hd] rotated by sin/cos [B,S,1,hd/2], in f32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x [B,S,H,hd], positions [B,S] (or [S]) -> rotated x."""
    B, S, H, hd = x.shape
    if positions.dim() == 1:
        positions = positions[None].expand(B, S)
    sin, cos = _rope_angles(positions, hd, theta)       # [B,S,hd/2]
    return _rotate(x, sin[:, :, None, :], cos[:, :, None, :])


def apply_mrope(x, positions3, sections: Tuple[int, ...], theta: float):
    """Qwen2-VL M-RoPE: positions3 [3,B,S] (t,h,w); rotary dims split into
    ``sections`` (sum == hd//2); section s rotates with positions3[s]."""
    B, S, H, hd = x.shape
    half = hd // 2
    assert sum(sections) == half, (sections, half)
    dev = x.device
    freq = _rope_freq(half, theta, dev)
    # per-dim section id -> choose position stream
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=dev),
        to_card(sections, dev))
    pos_per_dim = positions3.float()[sec_id]             # [half,B,S]
    ang = torch.einsum("dbs,d->bsd", pos_per_dim, freq)  # [B,S,half]
    return _rotate(x, torch.sin(ang)[:, :, None, :],
                   torch.cos(ang)[:, :, None, :])


# ---------------------------------------------------------------------------
# Attention.

def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_chunk: int = DEFAULT_Q_CHUNK, q_offset: int = 0,
                    scale: Optional[float] = None):
    """q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] -> [B,Sq,Hq,hd].

    ``q_offset`` is the absolute position of q[0]; kv positions are
    0..Sk-1; ``scale`` the softmax scale (None: 1/sqrt(hd)).
    Differentiable (autograd)."""
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    kf = k.float().permute(0, 2, 1, 3)                  # [B,kv,Sk,hd]
    vf = v.float().permute(0, 2, 1, 3)
    kpos = torch.arange(Sk, device=q.device)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qc = q[:, q0:q0 + q_chunk].float()
        Cq = qc.shape[1]
        qg = qc.reshape(B, Cq, Hkv, G, hd).permute(0, 2, 3, 1, 4)
        s = torch.einsum("bkgqd,bkcd->bkgqc", qg, kf) * scale
        qpos = q_offset + q0 + torch.arange(Cq, device=q.device)
        mask = torch.ones((Cq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = s.masked_fill(~mask, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m).masked_fill(~mask, 0.0)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bkgqc,bkcd->bkgqd", p, vf) / l.clamp_min(1e-20)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, Cq, Hq, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def attn_init(cfg, dtype, generator, device):
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_q, cfg.n_kv
    scale = 1.0 / math.sqrt(d)
    tn = lambda shape: nn.truncnorm(shape, scale, dtype, generator, device)
    p = {"wq": tn((d, nq, hd)), "wk": tn((d, nkv, hd)),
         "wv": tn((d, nkv, hd)), "wo": tn((nq, hd, d))}
    if cfg.qkv_bias:
        z = dict(dtype=dtype, device=device)
        p["bq"] = torch.zeros((nq, hd), **z)
        p["bk"] = torch.zeros((nkv, hd), **z)
        p["bv"] = torch.zeros((nkv, hd), **z)
    return p


def _proj(x, w):
    """x [..., d] @ w [d, H, hd] -> [..., H, hd]."""
    d, H, hd = w.shape
    return (x @ w.reshape(d, H * hd)).reshape(*x.shape[:-1], H, hd)


def attn_qkv(p, x):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def attn_out(p, o):
    """o [..., H, hd] @ wo [H, hd, d] -> [..., d]."""
    H, hd, d = p["wo"].shape
    return o.reshape(*o.shape[:-2], H * hd) @ p["wo"].reshape(H * hd, d)


def attn_qkv_decode(p, x):
    """Single-token QKV: x [B, d] -> q/k/v [B, H, hd]."""
    with span("model.qkv"):
        return attn_qkv(p, x)


def attn_out_decode(p, o):
    """Single-token out projection: o [B, H, hd] -> [B, d]."""
    return attn_out(p, o)


def kv_head_slice(k, v, shard: int, kv_rep: int):
    """This rank's KV head when KV heads are REPLICATED across a model
    axis wider than ``n_kv`` (kv_rep = tp / n_kv > 1): k/v [B, n_kv, hd]
    from replicated weights; model rank ``shard`` keeps original head
    ``shard // kv_rep`` (one head per rank; the ranks holding the same
    head serve disjoint q-head groups, so nothing is counted twice).
    The identity when kv_rep == 1 (the weights were already
    head-sharded)."""
    if kv_rep <= 1:
        return k, v
    head = shard // kv_rep
    return k[:, head:head + 1], v[:, head:head + 1]


def position_qk(cfg, q, k, positions, mrope_positions=None):
    """q and k [B,S,H,hd] rotated by RoPE (M-RoPE for the vlm family's
    streams), or as they are with ``cfg.position_embedding == "nope"``."""
    if cfg.position_embedding == "nope":
        return q, k
    if mrope_positions is not None and cfg.mrope_sections:
        return (apply_mrope(q, mrope_positions, cfg.mrope_sections,
                            cfg.rope_theta),
                apply_mrope(k, mrope_positions, cfg.mrope_sections,
                            cfg.rope_theta))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def self_attention(p, x, positions, cfg, *, window: int = 0,
                   mrope_positions=None, causal: bool = True):
    """Full-sequence self attention (prefill)."""
    q, k, v = attn_qkv(p, x)
    q, k = position_qk(cfg, q, k, positions, mrope_positions)
    o = flash_attention(q, k, v, causal=causal, window=window,
                        scale=cfg.attn_scale)
    return attn_out(p, o)


def cross_attn_init(cfg, dtype, generator, device):
    return attn_init(cfg, dtype, generator, device)


def cross_attention(p, x, memory, *, scale: Optional[float] = None):
    """Encoder-decoder cross attention: q from ``x`` [B,S,d], k/v from
    ``memory`` [B,S_src,d], no positions (the memory carries its own
    encoding), every memory row attended (non-causal); ``scale`` as
    ``flash_attention``'s."""
    q = _proj(x, p["wq"])
    k, v = _proj(memory, p["wk"]), _proj(memory, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    o = flash_attention(q, k, v, causal=False, scale=scale)
    return attn_out(p, o)


# ---------------------------------------------------------------------------
# MLP (SwiGLU) and block.

def mlp_init(d: int, d_ff: int, dtype, generator, device):
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)
    return {
        "wi_gate": nn.truncnorm((d, d_ff), s_in, dtype, generator, device),
        "wi_up": nn.truncnorm((d, d_ff), s_in, dtype, generator, device),
        "wo": nn.truncnorm((d_ff, d), s_out, dtype, generator, device),
    }


def swiglu(p, x):
    """SwiGLU: silu(x @ wi_gate) * (x @ wi_up) @ wo."""
    g = F.silu(x @ p["wi_gate"])
    u = x @ p["wi_up"]
    return (g * u) @ p["wo"]


def mlp_apply(p, x):
    with span("model.mlp"):
        return swiglu(p, x)


def block_init(cfg, dtype, generator, device, d_ff: Optional[int] = None):
    """Standard pre-norm (attn + MLP) block."""
    return {"attn": attn_init(cfg, dtype, generator, device),
            "mlp": mlp_init(cfg.d_model, d_ff or cfg.d_ff, dtype, generator,
                            device),
            "ln1": nn.norm_init(cfg.d_model, dtype, device),
            "ln2": nn.norm_init(cfg.d_model, dtype, device)}


def block_apply(p, x, positions, cfg, *, window: int = 0,
                mrope_positions=None, causal: bool = True):
    h = self_attention(p["attn"], nn.norm(cfg, p["ln1"], x), positions,
                       cfg, window=window, mrope_positions=mrope_positions,
                       causal=causal)
    x = x + nn.residual(cfg, h)
    h = mlp_apply(p["mlp"], nn.norm(cfg, p["ln2"], x))
    return x + nn.residual(cfg, h)
