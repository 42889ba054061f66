"""Seamless-style encoder-decoder backbone (PyTorch port of
``models/encdec.py``).

Encoder: non-causal self attention over precomputed frame embeddings (the
audio frontend is a stub: the caller gives ``src_embeds`` [B, S_src, d]).
Decoder: causal self attention, cross attention over the encoder's memory,
SwiGLU MLP.  ``loss_fn`` is the teacher-forced loss; ``remat`` recomputes
each layer's activations in the backward.
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


def _enc_layer(cfg, lp, x, positions):
    return L.block_apply(lp, x, positions, cfg, causal=False)


def _dec_layer(cfg, lp, x, positions, memory):
    h = L.self_attention(lp["attn"], nn.norm(cfg, lp["ln1"], x), positions,
                         cfg)
    x = x + nn.residual(cfg, h)
    h = L.cross_attention(lp["cross"], nn.norm(cfg, lp["ln_cross"], x),
                          memory, scale=cfg.attn_scale)
    x = x + nn.residual(cfg, h)
    h = L.mlp_apply(lp["mlp"], nn.norm(cfg, lp["ln2"], x))
    return x + nn.residual(cfg, h)


def encode(cfg, params, src_embeds, *, remat: bool = False):
    """src_embeds [B,S_src,d] -> the encoder's memory [B,S_src,d]."""
    x = src_embeds
    positions = torch.arange(x.shape[1], device=x.device)
    layer = nn.remat(_enc_layer, remat)
    for i in range(cfg.encoder_layers):
        x = layer(cfg, nn.layer_slice(params["encoder"], i), x, positions)
    return nn.norm(cfg, params["enc_norm"], x)


def decode_train(cfg, params, tokens, memory, *, remat: bool = False):
    """Teacher-forced decoder over ``tokens`` [B,S] -> normed [B,S,d]."""
    x = nn.embed_scale(cfg, nn.embed_lookup(params["embed"], tokens))
    positions = torch.arange(x.shape[1], device=x.device)
    layer = nn.remat(_dec_layer, remat)
    for i in range(cfg.num_layers):
        x = layer(cfg, nn.layer_slice(params["decoder"], i), x, positions,
                  memory)
    return nn.norm(cfg, params["final_norm"], x)


def forward(cfg, params, tokens, *, src_embeds=None, remat: bool = False,
            last_only: bool = False,
            **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward -> logits [B,S,V] (f32) and a zero aux
    loss."""
    assert src_embeds is not None, "encdec requires src_embeds (stub frontend)"
    memory = encode(cfg, params, src_embeds, remat=remat)
    x = decode_train(cfg, params, tokens, memory, remat=remat)
    if last_only:
        x = x[:, -1:]
    logits = nn.logits_scale(cfg, nn.embed_logits(params["embed"],
                                                  x).float())
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg, params, tokens, labels, *, src_embeds=None,
            remat: bool = True):
    """Teacher-forced mean next-token cross entropy over ``src_embeds``'
    memory (labels = tokens shifted by caller)."""
    logits, _ = forward(cfg, params, tokens, src_embeds=src_embeds,
                        remat=remat)
    return nn.mean_nll(logits, labels)
