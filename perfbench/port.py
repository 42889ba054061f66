"""The system under test, set up from a configuration file: the port's
``ModelConfig`` (the file's ``port`` block), its parameter tree laid out
from the benchmark's draws, and the ``ContinuousBatcher`` that serves a
cell.  The only module of the harness that imports ``repro_torch``; it
imports it when a run sets up, never when it is itself imported."""
from __future__ import annotations

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


def batcher(cfg: dict, mix: dict, prm: dict, device):
    """The port's ``ContinuousBatcher`` for a cell: the mix's lanes and
    ``max_len``, the configuration's page size and megastep, the pool at
    the engine's default plan (1.25 x the worst case), FCFS with proactive
    admission control, no auto refill (the harness submits)."""
    from repro_torch.launch.serve import ContinuousBatcher
    from repro_torch.serving.sched import Scheduler
    sv = cfg["serving"]
    sched = Scheduler(slots=mix["lanes"], page_size=sv["page_size"],
                      max_len=mix["max_len"], megastep_k=sv["megastep_k"])
    return ContinuousBatcher(
        model_config(cfg), prm, batch=mix["lanes"], max_len=mix["max_len"],
        page_size=sv["page_size"], megastep_k=sv["megastep_k"],
        scheduler=sched, auto_refill=False, device=device)


def request(req_id: int, draw):
    from repro_torch.serving.sched import Request
    return Request(req_id=req_id, prompt=draw.prompt,
                   max_new_tokens=draw.max_new)


def counters() -> dict:
    """The program's host-sync count (``repro_torch.device.SYNC_STATS``)."""
    from repro_torch.device import SYNC_STATS
    return {"host_syncs": SYNC_STATS["host_syncs"]}
