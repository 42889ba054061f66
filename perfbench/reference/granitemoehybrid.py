"""The ``granitemoehybrid`` model (GraniteMoeHybrid, IBM's Granite 4.0-H):
the plain float32 forward and its fp8 control (``hidden``, ``head``;
judged by ``served.served_gaps``), the weights' draws (``plan``), and the
counts the yardstick and the readers take from the model
(``matmul_params_per_token``, ``paged_layers``, ``ssm_state_bytes``).

The equations, as the published model computes them:

- the embedding times ``embedding_multiplier``;
- layer i: ``x += residual_multiplier * mixer(rmsnorm(x))``, the mixer a
  Mamba-2 layer or an attention layer as ``layer_types[i]`` says, then
  ``x += residual_multiplier * (moe(h) + shared_mlp(h))`` with
  ``h = rmsnorm(x)``;
- attention: causal GQA with no position embedding (``nope``), scores
  scaled by ``attention_multiplier``;
- Mamba-2: the in-projection's z, x, B, C and dt blocks (drawn as
  separate matrices, the published ``in_proj``'s rows in order), a causal
  depthwise conv of width ``mamba_d_conv`` with bias and SiLU over x, B
  and C, ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``, the SSD
  scan (chunked, ``_ssd``), ``y + D x``, the gated RMSNorm
  ``rmsnorm(y * silu(z))`` over the whole inner width (one group), and
  the out-projection;
- the MoE: top-k of the router logits (snapped to 1/64, lower expert
  index first on ties: the port's departure that the configuration
  states), gates the selected probabilities renormalized (the published
  softmax over the top-k logits), each token through its k SwiGLU
  experts only, plus the shared SwiGLU MLP;
- the final RMSNorm, every norm at ``rms_norm_eps``; the tied read-out
  (the judge divides the logits by ``logits_scaling``).

``hidden`` runs layer by layer over all sequences at once (the scan and
the attention one sequence at a time), the weights of one layer upcast at
a time, so that it fits beside the bf16 draws on the card.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.decoder import _moe, _rmsnorm
from perfbench.reference.served import Lin, fp8
# the judge, importable from the model module too
from perfbench.reference.served import served_gaps  # noqa: F401
from perfbench.yardstick import sizes

BF16, F32 = torch.bfloat16, torch.float32
GLOBAL = ("embed", "final_norm")
STATE_BYTES = 4          # the mamba state h in float32
CONV_BYTES = 2           # the conv tails in the configuration's bf16


def mamba_sizes(cfg: dict) -> dict:
    """The Mamba-2 sizes of a configuration file."""
    d = cfg["hidden_size"]
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    G, N = cfg["mamba_n_groups"], cfg["mamba_d_state"]
    assert H * P == cfg["mamba_expand"] * d, "mamba heads x head != inner"
    return dict(d=d, di=H * P, H=H, P=P, G=G, N=N, W=cfg["mamba_d_conv"],
                chunk=cfg["mamba_chunk_size"])


def kinds(cfg: dict) -> List[Tuple[str, int]]:
    """(kind, index among its kind) of each layer."""
    seen = {"mamba": 0, "attention": 0}
    out = []
    for k in cfg["layer_types"][:cfg["num_hidden_layers"]]:
        out.append((k, seen[k]))
        seen[k] += 1
    return out


def _count(cfg: dict, kind: str) -> int:
    return sum(1 for k, _ in kinds(cfg) if k == kind)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., T] -> [..., T, T]: sum of a[j+1..i] at (i, j) for j <= i,
    -inf above the diagonal."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones(T, T, dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~keep, float("-inf"))


def _ssd(x, a, b, c, chunk: int):
    """The SSD scan of one sequence (the Mamba-2 paper's minimal chunked
    form): x [T, H, P] (already times dt), a [T, H] (dt * A), b and c
    [T, N] (one group) -> y [T, H, P], the state starting at zero."""
    T, H, P = x.shape
    n = -(-T // chunk)
    pad = n * chunk - T
    if pad:
        x, a = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(a, (0, 0, 0, pad))
        b, c = F.pad(b, (0, 0, 0, pad)), F.pad(c, (0, 0, 0, pad))
    x = x.reshape(n, chunk, H, P)
    b, c = b.reshape(n, chunk, -1), c.reshape(n, chunk, -1)
    a = a.reshape(n, chunk, H).permute(2, 0, 1)          # [H, n, l]
    a_cum = torch.cumsum(a, dim=-1)
    # within each chunk
    Lmat = torch.exp(_segsum(a))                         # [H, n, l, l]
    y = torch.einsum("cln,csn,hcls,cshp->clhp", c, b, Lmat, x)
    # each chunk's state, then the states carried across chunks
    decay = torch.exp(a_cum[..., -1:] - a_cum)           # [H, n, l]
    states = torch.einsum("cln,hcl,clhp->chpn", b, decay, x)
    states = torch.cat([torch.zeros_like(states[:1]), states], dim=0)
    carry = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))  # [H,n+1,n+1]
    states = torch.einsum("hzc,chpn->zhpn", carry, states)[:-1]
    y = y + torch.einsum("cln,chpn,hcl->clhp", c, states, torch.exp(a_cum))
    return y.reshape(n * chunk, H, P)[:T]


def _conv(x, w, bias):
    """Causal depthwise conv of one sequence, zero history: x [T, C], w
    [W, C] (tap W-1 on the current token), then SiLU."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    y = sum(xp[i:i + x.shape[0]] * w[i] for i in range(W))
    return F.silu(y + bias)


def _mamba(h, lw, cfg, lens, lin, eps):
    """A Mamba-2 mixer over the sequences of ``lens``, concatenated in h."""
    m = mamba_sizes(cfg)
    di, H, P, N = m["di"], m["H"], m["P"], m["N"]
    z = lin(h, lin.w(lw["m_wz"]))
    xs = lin(h, lin.w(lw["m_wx"]))
    bc = lin(h, lin.w(lw["m_wbc"]))
    dt = lin(h, lin.w(lw["m_wdt"]))
    A = -torch.exp(lw["m_A_log"].float())
    outs, o = [], 0
    for n in lens:
        sl = slice(o, o + n)
        xc = _conv(xs[sl], lw["m_convx_w"].float(), lw["m_convx_b"].float())
        bcc = _conv(bc[sl], lw["m_convbc_w"].float(),
                    lw["m_convbc_b"].float())
        d_t = F.softplus(dt[sl] + lw["m_dt_bias"].float())      # [T, H]
        xh = xc.reshape(n, H, P)
        y = _ssd(xh * d_t[..., None], d_t * A, bcc[:, :N], bcc[:, N:],
                 m["chunk"])
        y = y + xh * lw["m_D"].float()[:, None]
        outs.append(y.reshape(n, di))
        o += n
    y = torch.cat(outs) * F.silu(z)
    y = _rmsnorm(y, lw["m_norm"], eps)
    return lin(y, lin.w(lw["m_out"]))


def _attention(h, lw, cfg, lens, lin):
    """Causal GQA with no positions, scores times attention_multiplier."""
    d = cfg["hidden_size"]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // nq
    q, k, v = (lin(h, lin.w(lw[n])) for n in ("wq", "wk", "wv"))
    q, k, v = q.reshape(-1, nq, hd), k.reshape(-1, nkv, hd), \
        v.reshape(-1, nkv, hd)
    if lin.fp8:
        k, v = fp8(k, -1), fp8(v, -1)
    scale = cfg["attention_multiplier"]
    outs, o = [], 0
    for n in lens:
        qs = q[o:o + n]
        ks = k[o:o + n].repeat_interleave(nq // nkv, dim=1)
        vs = v[o:o + n].repeat_interleave(nq // nkv, dim=1)
        s = torch.einsum("qhd,khd->hqk", qs, ks) * scale
        mask = torch.ones(n, n, dtype=torch.bool, device=h.device).tril()
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(torch.einsum("hqk,khd->qhd", p, vs))
        o += n
    return lin(torch.cat(outs).reshape(-1, nq * hd), lin.w(lw["wo"]))


def _ffn(h, lw, cfg, lin):
    """The routed experts (only for the tokens routed to them) plus the
    shared SwiGLU MLP."""
    y = _moe(h, lw, cfg, lin)
    g = F.silu(lin(h, lin.w(lw["sg"]))) * lin(h, lin.w(lw["su"]))
    return y + lin(g, lin.w(lw["sd"]))


def hidden(cfg: dict, w: Dict[str, torch.Tensor], seqs: Sequence[np.ndarray],
           precision: str = "f32") -> torch.Tensor:
    """Final-normed hidden states [sum of lengths, d] of every sequence."""
    lin = Lin(precision == "fp8")
    eps, res = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    dev = w["embed"].device
    lens = [len(s) for s in seqs]
    toks = torch.as_tensor(np.concatenate(seqs).astype(np.int64),
                           device=dev)
    x = w["embed"][toks].float() * cfg["embedding_multiplier"]
    for l, (kind, j) in enumerate(kinds(cfg)):
        if kind == "mamba":
            lw = {n: t[j] for n, t in w.items() if n.startswith("m_")}
            h = _mamba(_rmsnorm(x, lw["m_ln"], eps), lw, cfg, lens, lin,
                       eps)
        else:
            lw = {n: t[j] for n, t in w.items() if n.startswith("a_")}
            lw = {n[2:]: t for n, t in lw.items()}
            h = _attention(_rmsnorm(x, lw["ln"], eps), lw, cfg, lens, lin)
        x = x + res * h
        lw = {n[2:]: t[l] for n, t in w.items() if n.startswith("f_")}
        x = x + res * _ffn(_rmsnorm(x, lw["ln"], eps), lw, cfg, lin)
    return _rmsnorm(x, w["final_norm"], eps)


def head(cfg: dict, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The tied read-out [d, V]."""
    return w["embed"].t()


def plan(cfg: dict) -> List[Tuple[str, tuple, float, float, torch.dtype]]:
    """(name, shape, scale, offset, dtype) of every tensor, in draw order,
    each kind's layers stacked on a leading axis: ``m_*`` the mamba
    layers, ``a_*`` the attention layers, ``f_*`` every layer's FFN.
    Matrices N(0, 1/fan_in), conv taps N(0, 1/W), biases N(0, 0.01), norm
    scales 1 + N(0, 0.01); the embedding N(0, 1/(d m^2)) with m the
    ``embedding_multiplier``, so that the scaled embedding the first layer
    reads has the 1/d variance of every other matrix (drawn at 1/d, the
    tied read-out's logit of a token's own row, 12 |e|^2, would stand
    far above every other and the model would repeat its last token);
    the mamba's A_log N(1, 0.25) (decay rates around e), dt_bias N(-4, 1)
    (steps around softplus(-4) = 0.018, inside the published init's
    0.001-0.1) and D 1 + N(0, 0.01), in float32 as
    published; the router float32."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // nq
    ff, sff = cfg["intermediate_size"], cfg["shared_intermediate_size"]
    E = cfg["num_local_experts"]
    L = cfg["num_hidden_layers"]
    M, NA = _count(cfg, "mamba"), _count(cfg, "attention")
    m = mamba_sizes(cfg)
    di, H, W, GN = m["di"], m["H"], m["W"], m["G"] * m["N"]
    mat = lambda n, shape, fan_in, dt=BF16: (n, shape, fan_in ** -0.5,
                                             0.0, dt)
    emb = (d ** -0.5) / cfg["embedding_multiplier"]
    return [
        ("embed", (V, d), emb, 0.0, BF16),
        ("final_norm", (d,), 0.1, 1.0, BF16),
        ("m_ln", (M, d), 0.1, 1.0, BF16),
        mat("m_wz", (M, d, di), d), mat("m_wx", (M, d, di), d),
        mat("m_wbc", (M, d, 2 * GN), d), mat("m_wdt", (M, d, H), d),
        mat("m_convx_w", (M, W, di), W), ("m_convx_b", (M, di), 0.1, 0.0,
                                          BF16),
        mat("m_convbc_w", (M, W, 2 * GN), W),
        ("m_convbc_b", (M, 2 * GN), 0.1, 0.0, BF16),
        ("m_A_log", (M, H), 0.5, 1.0, F32),
        ("m_dt_bias", (M, H), 1.0, -4.0, F32),
        ("m_D", (M, H), 0.1, 1.0, F32),
        ("m_norm", (M, di), 0.1, 1.0, BF16),
        mat("m_out", (M, di, d), di),
        ("a_ln", (NA, d), 0.1, 1.0, BF16),
        mat("a_wq", (NA, d, nq * hd), d), mat("a_wk", (NA, d, nkv * hd), d),
        mat("a_wv", (NA, d, nkv * hd), d),
        mat("a_wo", (NA, nq * hd, d), nq * hd),
        ("f_ln", (L, d), 0.1, 1.0, BF16),
        mat("f_router", (L, d, E), d, F32),
        mat("f_wg", (L, E, d, ff), d), mat("f_wu", (L, E, d, ff), d),
        mat("f_wd", (L, E, ff, d), ff),
        mat("f_sg", (L, d, sff), d), mat("f_su", (L, d, sff), d),
        mat("f_sd", (L, sff, d), sff),
    ]


def matmul_params_per_token(cfg: dict) -> int:
    """Weights a token multiplies by: each mamba layer's in- and
    out-projections, each attention layer's q, k, v and o, in every layer
    the router, the ``k`` experts it picks and the shared MLP, and the
    tied read-out.  The conv taps are no matmul."""
    s, m = sizes(cfg), mamba_sizes(cfg)
    d, hd = s["d"], s["hd"]
    mamba = d * (2 * m["di"] + 2 * m["G"] * m["N"] + m["H"]) + m["di"] * d
    attn = d * hd * (2 * s["nq"] + 2 * s["nkv"])
    ffn = (d * s["E"] + s["k"] * 3 * d * s["ff"]
           + 3 * d * cfg["shared_intermediate_size"])
    return (_count(cfg, "mamba") * mamba + _count(cfg, "attention") * attn
            + s["L"] * ffn + d * s["V"])


def paged_layers(cfg: dict) -> int:
    """Layers that attend over the paged KV through K1: the attention
    layers."""
    return _count(cfg, "attention")


def ssm_state_bytes(cfg: dict, steps: int) -> float:
    """The least bytes the mamba state moves over ``steps`` lane token
    steps: in each mamba layer a lane's ``h`` [H, P, N] read once and
    written once in float32, and its conv tails [W-1, inner + 2 G N] read
    once and written once in bf16."""
    m = mamba_sizes(cfg)
    h = m["H"] * m["P"] * m["N"] * STATE_BYTES
    tails = (m["W"] - 1) * (m["di"] + 2 * m["G"] * m["N"]) * CONV_BYTES
    return 2.0 * (h + tails) * _count(cfg, "mamba") * steps
