"""Plain float32 forward of the benchmark's decoder configurations: a
Qwen2-style dense stack (GQA with q/k/v biases, RoPE, SwiGLU) and a
GraniteMoe-style stack (the same attention, a top-k router over SwiGLU
experts), as each configuration file states them (its ``departures``
say where that differs from the published model).

``served_gaps`` judges the tokens a program served: for every served
token, by how much its logit lies below the best logit of the reference
at that position.  Greedy decoding in the configuration's precision
gives gaps at rounding level; a wrong token, page or lane gives gaps the
size of the logits' spread.  ``precision="fp8"`` runs the control: every
bf16 matmul's weights (per output channel) and inputs (per row), and the
K/V (per token and head), rounded to float8 e4m3 and back.

Runs layer by layer over all sequences at once, the weights of one layer
upcast at a time, TF32 off, so that it fits beside nothing else on the
card once the program is gone.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import weights as RW

F8_MAX = 448.0
ROUTER_SNAP = 64.0   # router logits snapped to 1/64 (the departure the
                     # granite file states)
GLOBAL = ("embed", "lm_head", "final_norm")   # the draws not per layer


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the amax maps to the format's largest value), back in float32."""
    s = (x.abs().amax(dim=dim, keepdim=True) / F8_MAX).clamp_min(1e-12)
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Lin:
    """float32 matmuls, or the fp8 control's."""

    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def w(self, t: torch.Tensor) -> torch.Tensor:
        """A [in, out] weight in float32 (fp8: one scale per output)."""
        t = t.float()
        return _fp8(t, 0) if self.fp8 else t

    def __call__(self, x, w):
        return (_fp8(x, -1) if self.fp8 else x) @ w


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
    lin = _Lin(precision == "fp8")
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
            k, v = _fp8(k, -1), _fp8(v, -1)
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


def served_gaps(cfg: dict, seed: int, device, requests: List[tuple],
                control: bool = False, block: int = 1024) -> dict:
    """Judge served tokens.  ``requests``: (prompt, served tokens) pairs,
    served non-empty.  Returns ``gaps``: per request, the gap of each
    served token (the reference's best logit at that position minus the
    served token's).  With ``control``, also ``control_gaps``: at the same
    positions, the gap of the token the fp8 control puts first."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _served_gaps(cfg, seed, device, requests, control, block)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _served_gaps(cfg, seed, device, requests, control, block):
    w = RW.draw(cfg, seed, device)
    # the forward runs over prompt + served tokens but the last; row r of
    # a sequence predicts its token r + 1
    seqs, rows, targets, o = [], [], [], 0
    for prompt, served in requests:
        full = np.concatenate([np.asarray(prompt), np.asarray(served)])
        seqs.append(full[:-1])
        nk = len(prompt)
        rows.append(o + np.arange(nk - 1, len(full) - 1))
        targets.append(np.asarray(served))
        o += len(full) - 1
    rows_t = torch.as_tensor(np.concatenate(rows), device=w["embed"].device)
    tgt = torch.as_tensor(np.concatenate(targets).astype(np.int64),
                          device=rows_t.device)
    hid = {"f32": hidden(cfg, w, seqs, "f32")[rows_t]}
    if control:
        hid["fp8"] = hidden(cfg, w, seqs, "fp8")[rows_t]
    lin32, lin8 = _Lin(False), _Lin(True)
    head32 = lin32.w(_head(cfg, w))
    head8 = lin8.w(_head(cfg, w)) if control else None
    mult = 1.0 / cfg.get("logits_scaling", 1.0)
    gap, cgap = [], []
    for b0 in range(0, rows_t.numel(), block):
        sl = slice(b0, b0 + block)
        ref = lin32(hid["f32"][sl], head32) * mult
        best = ref.amax(-1)
        gap.append(best - ref.gather(-1, tgt[sl, None])[:, 0])
        if control:
            top = (lin8(hid["fp8"][sl], head8) * mult).argmax(-1)
            cgap.append(best - ref.gather(-1, top[:, None])[:, 0])
    split = np.cumsum([len(t) for t in targets])[:-1]
    out = {"gaps": np.split(torch.cat(gap).cpu().numpy(), split)}
    if control:
        out["control_gaps"] = np.split(torch.cat(cgap).cpu().numpy(), split)
    return out


def _head(cfg, w):
    """The read-out [d, V]: the tied embedding or the LM head."""
    return (w["embed"].t() if cfg["tie_word_embeddings"]
            else w["lm_head"])
