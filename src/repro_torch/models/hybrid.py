"""Zamba2-style hybrid (PyTorch port of ``models/hybrid.py``): a Mamba2
backbone and ONE shared (attention + MLP) block whose parameters are
reused after every ``shared_attn_every`` mamba layers.

38 = 6·6 + 2 for the full config: six groups of (6 mamba layers, then
the shared block), then 2 trailing mamba layers.  Each invocation of the
shared block has its own KV pages at decode time (parameters shared,
state not).  The training loss waits for ROADMAP item 21.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import nn
from repro_torch.models import ssm
from repro_torch.models import ssm_lm


def num_shared_invocations(cfg) -> int:
    return cfg.num_layers // cfg.shared_attn_every


def check_supported(cfg) -> None:
    """Decode serves the shared block from the page table, so a depth
    below one group would leave the state without one (the reference's
    decode would fail on its missing table)."""
    if num_shared_invocations(cfg) < 1:
        raise ValueError(
            f"{cfg.name}: num_layers={cfg.num_layers} is below one group of "
            f"{cfg.shared_attn_every} mamba layers, so the shared attention "
            f"block never runs")


def mamba_decode_chunk(cfg, layer_params, states: ssm.MambaState, x,
                       lo: int, hi: int, tp_axis: Optional[str] = None):
    """One-token decode through mamba layers [lo, hi): x [B,1,d] ->
    (x', the chunk's states stacked ``[hi-lo, B, ...]``)."""
    outs = []
    for i in range(lo, hi):
        lp = nn.layer_slice(layer_params, i)
        st = ssm.MambaState(*(t[i] for t in states))
        h, st2 = ssm.mamba_decode_step(lp["mamba"], nn.rmsnorm(lp["ln"], x),
                                       cfg, st, tp_axis=tp_axis)
        x = x + h
        outs.append(st2)
    return x, ssm.MambaState(*(torch.stack(ts) for ts in zip(*outs)))


def init(cfg, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random parameters in the reference's layout (the mamba layers
    stacked, the one shared block), drawn from ``generator``."""
    dev = resolve_device(device)
    dtype = cfg.activation_dtype()
    return {"embed": nn.embed_init(cfg.vocab_size, cfg.d_model, dtype,
                                   generator, dev),
            "layers": nn.stack_layer_params(
                [ssm_lm.layer_init(cfg, dtype, generator, dev)
                 for _ in range(cfg.num_layers)]),
            "shared": L.block_init(cfg, dtype, generator, dev),
            "final_norm": nn.norm_init(cfg.d_model, dtype, dev)}


def forward(cfg, params, tokens, *, last_only: bool = False,
            **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> logits [B,S,V] (f32) and a zero aux
    loss."""
    S = tokens.shape[1]
    every = cfg.shared_attn_every
    n_inv = num_shared_invocations(cfg)
    x = nn.embed_lookup(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)
    for g in range(n_inv):
        x = ssm_lm.mamba_layers(cfg, params["layers"], x, g * every,
                                (g + 1) * every)
        x = L.block_apply(params["shared"], x, positions, cfg)
    x = ssm_lm.mamba_layers(cfg, params["layers"], x, n_inv * every,
                            cfg.num_layers)
    if last_only:
        x = x[:, -1:]
    x = nn.rmsnorm(params["final_norm"], x)
    logits = nn.embed_logits(params["embed"], x).float()
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)
