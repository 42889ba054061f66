"""Seamless-style encoder-decoder backbone (PyTorch port of
``models/encdec.py``).

Encoder: non-causal self attention over precomputed frame embeddings (the
audio frontend is a stub: the caller gives ``src_embeds`` [B, S_src, d]).
Decoder: causal self attention, cross attention over the encoder's memory,
SwiGLU MLP.  The teacher-forced loss waits for ROADMAP item 21.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import nn


def _dec_layer_init(cfg, dtype, generator, device):
    p = L.block_init(cfg, dtype, generator, device)
    p["cross"] = L.cross_attn_init(cfg, dtype, generator, device)
    p["ln_cross"] = nn.norm_init(cfg.d_model, dtype, device)
    return p


def init(cfg, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random parameters in the reference's layout, drawn from
    ``generator``."""
    dev = resolve_device(device)
    dtype = cfg.activation_dtype()
    return {"embed": nn.embed_init(cfg.vocab_size, cfg.d_model, dtype,
                                   generator, dev),
            "encoder": nn.stack_layer_params(
                [L.block_init(cfg, dtype, generator, dev)
                 for _ in range(cfg.encoder_layers)]),
            "decoder": nn.stack_layer_params(
                [_dec_layer_init(cfg, dtype, generator, dev)
                 for _ in range(cfg.num_layers)]),
            "enc_norm": nn.norm_init(cfg.d_model, dtype, dev),
            "final_norm": nn.norm_init(cfg.d_model, dtype, dev)}


def encode(cfg, params, src_embeds):
    """src_embeds [B,S_src,d] -> the encoder's memory [B,S_src,d]."""
    x = src_embeds
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.encoder_layers):
        lp = nn.layer_slice(params["encoder"], i)
        x = x + L.self_attention(lp["attn"], nn.rmsnorm(lp["ln1"], x),
                                 positions, cfg, causal=False)
        x = x + L.mlp_apply(lp["mlp"], nn.rmsnorm(lp["ln2"], x))
    return nn.rmsnorm(params["enc_norm"], x)


def decode_train(cfg, params, tokens, memory):
    """Teacher-forced decoder over ``tokens`` [B,S] -> normed [B,S,d]."""
    x = nn.embed_lookup(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.num_layers):
        lp = nn.layer_slice(params["decoder"], i)
        x = x + L.self_attention(lp["attn"], nn.rmsnorm(lp["ln1"], x),
                                 positions, cfg)
        x = x + L.cross_attention(lp["cross"],
                                  nn.rmsnorm(lp["ln_cross"], x), memory)
        x = x + L.mlp_apply(lp["mlp"], nn.rmsnorm(lp["ln2"], x))
    return nn.rmsnorm(params["final_norm"], x)


def forward(cfg, params, tokens, *, src_embeds=None, last_only: bool = False,
            **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward -> logits [B,S,V] (f32) and a zero aux
    loss."""
    assert src_embeds is not None, "encdec requires src_embeds (stub frontend)"
    memory = encode(cfg, params, src_embeds)
    x = decode_train(cfg, params, tokens, memory)
    if last_only:
        x = x[:, -1:]
    logits = nn.embed_logits(params["embed"], x).float()
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)
