"""The port's side of the ``decoder`` model (``reference/decoder.py``):
the port's ``ModelConfig`` from the configuration file's ``port`` block,
the ``models/lm.py`` parameter tree laid out from the benchmark's draws,
the port's full-sequence forward, and the CPU tests' cut of a dense
(Qwen2) or MoE (GraniteMoe) configuration.  Imports ``repro_torch`` when
called, never when loaded."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def model_config(cfg: dict):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**cfg["port"])


def _pad_heads(t: torch.Tensor, nkv: int, rep: int, rep_to: int, dim: int):
    """Head-major axis ``dim`` of ``t`` holding ``nkv * rep`` heads, each KV
    group's ``rep`` query heads followed by ``rep_to - rep`` zero heads: the
    port's ``pad_heads_to`` layout in which query slot j reads KV head
    ``j // rep_to``, so the served function is the published one."""
    if rep_to == rep:
        return t
    shape = list(t.shape)
    grouped = t.reshape(shape[:dim] + [nkv, rep] + shape[dim + 1:])
    out = torch.zeros(shape[:dim] + [nkv, rep_to] + shape[dim + 1:],
                      dtype=t.dtype, device=t.device)
    out.narrow(dim + 1, 0, rep).copy_(grouped)
    return out.reshape(shape[:dim] + [nkv * rep_to] + shape[dim + 1:])


def params(cfg: dict, w: Dict[str, torch.Tensor]) -> dict:
    """The port's parameter tree (``models/lm.py`` layout, layers stacked)
    from the benchmark's draws.  Views where the layouts agree; the query
    heads are copied into the padded layout when the port pads them."""
    pc = model_config(cfg)
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    nq, nkv, hd = pc.num_heads, pc.n_kv, pc.hd
    rep, rep_to = nq // nkv, pc.n_q // nkv
    attn = {
        "wq": _pad_heads(w["wq"].reshape(L, d, nq, hd), nkv, rep, rep_to, 2),
        "wk": w["wk"].reshape(L, d, nkv, hd),
        "wv": w["wv"].reshape(L, d, nkv, hd),
        "wo": _pad_heads(w["wo"].reshape(L, nq, hd, d), nkv, rep, rep_to, 1),
    }
    if pc.qkv_bias:
        attn["bq"] = _pad_heads(w["bq"].reshape(L, nq, hd), nkv, rep,
                                rep_to, 1)
        attn["bk"] = w["bk"].reshape(L, nkv, hd)
        attn["bv"] = w["bv"].reshape(L, nkv, hd)
    ffn = {"wi_gate": w["wg"], "wi_up": w["wu"], "wo": w["wd"]}
    layers = {"attn": attn, "ln1": {"scale": w["ln1"]},
              "ln2": {"scale": w["ln2"]}}
    if pc.family == "moe":
        layers["moe"] = dict(ffn, router=w["router"])
    else:
        layers["mlp"] = ffn
    p = {"embed": {"embedding": w["embed"]}, "layers": layers,
         "final_norm": {"scale": w["final_norm"]}}
    if not pc.tie_embeddings:
        p["lm_head"] = {"w": w["lm_head"]}
    return p


def forward(cfg: dict, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The port's full-sequence forward (``models/lm.forward``) of one
    sequence ``tokens`` [S] in float32: logits [S, V]."""
    from repro_torch.models import lm, nn
    prm = nn.tree_map(lambda t: t.float(), params)
    pc = dataclasses.replace(model_config(cfg), dtype="float32")
    logits, _ = lm.forward(pc, prm, tokens[None])
    return logits[0]


def small(cfg: dict) -> dict:
    """The CPU tests' cut: every size cut down, the keys and the code
    paths the same (the dense cut keeps the padded query heads)."""
    if cfg["model_type"] == "qwen2":
        sizes = dict(hidden_size=80, intermediate_size=96, vocab_size=256,
                     num_hidden_layers=2, num_attention_heads=10,
                     num_key_value_heads=2, rope_theta=10000.0)
        port = dict(d_model=80, d_ff=96, vocab_size=256, num_layers=2,
                    num_heads=10, num_kv_heads=2, head_dim=8,
                    pad_heads_to=12, rope_theta=10000.0)
    else:
        sizes = dict(hidden_size=64, intermediate_size=32, vocab_size=256,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, num_local_experts=4,
                     num_experts_per_tok=2,
                     attention_multiplier=16 ** -0.5)
        port = dict(d_model=64, d_ff=32, vocab_size=256, num_layers=2,
                    num_heads=4, num_kv_heads=2, head_dim=16,
                    num_experts=4, experts_per_token=2,
                    moe_capacity_factor=2.0)
    cfg = dict(cfg, **sizes)
    cfg["port"] = dict(cfg["port"], **port)
    return cfg
