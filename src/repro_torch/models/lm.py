"""Decoder-only LM, dense family (PyTorch port of ``models/lm.py``).

The MoE family (ROADMAP item 14), gemma3's local/global pattern (item 15)
and the vlm family (item 16) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import nn


def check_supported(cfg) -> None:
    """The dense family without a local/global pattern is ported."""
    if cfg.family == "moe":
        raise NotImplementedError("MoE family is ROADMAP item 14")
    if cfg.family == "vlm":
        raise NotImplementedError("vlm family (M-RoPE) is ROADMAP item 16")
    if cfg.pattern_local:
        raise NotImplementedError(
            "gemma3 local/global attention is ROADMAP item 15")
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not served by "
                                  f"models.lm")


def init(cfg, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random parameters in the reference's layout, drawn from
    ``generator`` (for standalone runs; parity tests convert the
    reference's own ``init`` with ``models.convert``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = cfg.activation_dtype()
    p = {"embed": nn.embed_init(cfg.vocab_size, cfg.d_model, dtype,
                                generator, dev),
         "layers": nn.stack_layer_params(
             [L.block_init(cfg, dtype, generator, dev)
              for _ in range(cfg.num_layers)]),
         "final_norm": nn.norm_init(cfg.d_model, dtype, dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = nn.dense_init(cfg.d_model, cfg.vocab_size,
                                     bias=False, dtype=dtype,
                                     generator=generator, device=dev)
    return p


def forward(cfg, params, tokens, *, positions=None,
            last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> logits [B,S,V] (f32) and aux loss (0)."""
    check_supported(cfg)
    B, S = tokens.shape
    x = nn.embed_lookup(params["embed"], tokens)
    if positions is None:
        positions = torch.arange(S, device=tokens.device)
    for i in range(cfg.num_layers):
        x = L.block_apply(nn.layer_slice(params["layers"], i), x, positions,
                          cfg)
    if last_only:
        x = x[:, -1:]
    x = nn.rmsnorm(params["final_norm"], x)
    return _logits(cfg, params, x), torch.zeros((), device=tokens.device)


def _logits(cfg, params, x):
    if cfg.tie_embeddings:
        logits = nn.embed_logits(params["embed"], x)
    else:
        logits = nn.dense(params["lm_head"], x)
    return logits.float()
