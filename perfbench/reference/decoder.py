"""The ``decoder`` model of the benchmark's configurations (a configuration
file without a ``"model"`` key): a Qwen2-style dense stack (GQA with q/k/v
biases, RoPE, SwiGLU) and a GraniteMoe-style stack (the same attention,
a top-k router over SwiGLU experts), as each configuration file states
them (its ``departures`` say where that differs from the published
model).  The plain float32 forward and its fp8 control (``hidden``,
``head``; judged by ``served.served_gaps``), the weights' draws
(``plan``), and the counts the yardstick takes from the model
(``matmul_params_per_token``, ``paged_layers``).

``hidden`` runs layer by layer over all sequences at once, the weights of
one layer upcast at a time, so that it fits beside nothing else on the
card once the program is gone.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.served import Lin, fp8
# the judge, importable from the decoder too
from perfbench.reference.served import served_gaps  # noqa: F401
from perfbench.yardstick import sizes

BF16, F32 = torch.bfloat16, torch.float32
ROUTER_SNAP = 64.0   # router logits snapped to 1/64 (the departure the
                     # granite file states)
GLOBAL = ("embed", "lm_head", "final_norm")   # the draws not per layer


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x, pos, theta):
    """x [S, H, hd] rotated at positions ``pos`` [S] (halves rotated)."""
    half = x.shape[-1] // 2
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device),
                     -torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.float()[:, None] * freq[None]
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, scale):
    """Causal GQA of one sequence: q [S, nq, hd], k/v [S, nkv, hd]."""
    S, nq, hd = q.shape
    rep = nq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v)


def _moe(x, lw, cfg, lin):
    """Top-k of the router logits snapped to 1/64 (lower expert index
    first on ties), gates the selected probabilities renormalized, each
    token through its k SwiGLU experts."""
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    logits = x @ lw["router"].float()
    probs = torch.softmax(logits, dim=-1)
    idx = torch.arange(E, dtype=torch.float32, device=x.device)
    key = torch.round(logits * ROUTER_SNAP) * (E + 1.0) - idx
    ids = torch.topk(key, k, dim=-1).indices
    gates = torch.gather(probs, -1, ids)
    gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(E):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = x[tok]
        g = F.silu(lin(h, lin.w(lw["wg"][e]))) * lin(h, lin.w(lw["wu"][e]))
        y.index_add_(0, tok, lin(g, lin.w(lw["wd"][e]))
                     * gates[tok, slot][:, None])
    return y


def hidden(cfg: dict, w: Dict[str, torch.Tensor], seqs: Sequence[np.ndarray],
           precision: str = "f32") -> torch.Tensor:
    """Final-normed hidden states [sum of lengths, d] of every sequence."""
    lin = Lin(precision == "fp8")
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // nq
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    scale = cfg.get("attention_multiplier", hd ** -0.5)
    dev = w["embed"].device
    lens = [len(s) for s in seqs]
    toks = torch.as_tensor(np.concatenate(seqs).astype(np.int64),
                           device=dev)
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    x = w["embed"][toks].float() * cfg.get("embedding_multiplier", 1.0)
    res = cfg.get("residual_multiplier", 1.0)
    for l in range(L):
        lw = {n: t[l] for n, t in w.items() if n not in GLOBAL}
        h = _rmsnorm(x, lw["ln1"], eps)
        q, k, v = (lin(h, lin.w(lw[n])) for n in ("wq", "wk", "wv"))
        if cfg["qkv_bias"]:
            q, k, v = q + lw["bq"].float(), k + lw["bk"].float(), \
                v + lw["bv"].float()
        q = _rope(q.reshape(-1, nq, hd), pos, theta)
        k = _rope(k.reshape(-1, nkv, hd), pos, theta)
        v = v.reshape(-1, nkv, hd)
        if lin.fp8:
            k, v = fp8(k, -1), fp8(v, -1)
        outs, o = [], 0
        for n in lens:
            outs.append(_attention(q[o:o + n], k[o:o + n], v[o:o + n],
                                   scale))
            o += n
        a = torch.cat(outs).reshape(-1, nq * hd)
        x = x + res * lin(a, lin.w(lw["wo"]))
        h = _rmsnorm(x, lw["ln2"], eps)
        if cfg.get("num_local_experts", 0):
            x = x + res * _moe(h, lw, cfg, lin)
        else:
            g = F.silu(lin(h, lin.w(lw["wg"]))) * lin(h, lin.w(lw["wu"]))
            x = x + res * lin(g, lin.w(lw["wd"]))
    return _rmsnorm(x, w["final_norm"], eps)


def head(cfg: dict, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The read-out [d, V]: the tied embedding or the LM head."""
    return (w["embed"].t() if cfg["tie_word_embeddings"]
            else w["lm_head"])


def plan(cfg: dict) -> List[Tuple[str, tuple, float, float, torch.dtype]]:
    """(name, shape, scale, offset, dtype) of every tensor, in draw order:
    the published head counts, the layers stacked on a leading axis."""
    d, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // nq
    ff, E = cfg["intermediate_size"], cfg.get("num_local_experts", 0)
    mat = lambda n, shape, fan_in, dt=BF16: (n, shape, fan_in ** -0.5,
                                             0.0, dt)
    out = [mat("embed", (V, d), d)]
    if not cfg["tie_word_embeddings"]:
        out.append(mat("lm_head", (d, V), d))
    out += [mat("wq", (L, d, nq * hd), d), mat("wk", (L, d, nkv * hd), d),
            mat("wv", (L, d, nkv * hd), d), mat("wo", (L, nq * hd, d),
                                                nq * hd)]
    if cfg["qkv_bias"]:
        out += [("bq", (L, nq * hd), 0.1, 0.0, BF16),
                ("bk", (L, nkv * hd), 0.1, 0.0, BF16),
                ("bv", (L, nkv * hd), 0.1, 0.0, BF16)]
    out += [("ln1", (L, d), 0.1, 1.0, BF16), ("ln2", (L, d), 0.1, 1.0, BF16),
            ("final_norm", (d,), 0.1, 1.0, BF16)]
    if E:
        out += [mat("router", (L, d, E), d, F32),
                mat("wg", (L, E, d, ff), d), mat("wu", (L, E, d, ff), d),
                mat("wd", (L, E, ff, d), ff)]
    else:
        out += [mat("wg", (L, d, ff), d), mat("wu", (L, d, ff), d),
                mat("wd", (L, ff, d), ff)]
    return out


def matmul_params_per_token(cfg: dict) -> int:
    """Weights a token multiplies by: q, k, v, o at the published head
    counts, the MLP (or the router and the ``k`` experts it picks) in every
    layer, and the LM head.  The embedding lookup is no matmul."""
    s = sizes(cfg)
    d, hd = s["d"], s["hd"]
    attn = d * hd * (2 * s["nq"] + 2 * s["nkv"])
    if s["E"]:
        ffn = d * s["E"] + s["k"] * 3 * d * s["ff"]
    else:
        ffn = 3 * d * s["ff"]
    return s["L"] * (attn + ffn) + d * s["V"]


def paged_layers(cfg: dict) -> int:
    """Layers that attend over the paged KV through K1: every layer."""
    return cfg["num_hidden_layers"]
