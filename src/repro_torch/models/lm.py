"""Decoder-only LM covering the dense / moe / vlm families, gemma3's 5:1
local:global attention pattern included (PyTorch port of ``models/lm.py``).

gemma3 runs its layers as ``num_layers / (pattern_local + 1)``
superblocks: ``pattern_local`` local layers with ``window=local_window``,
then one global layer.  The ssm, hybrid and encdec families have modules
of their own (``models/registry.py``).  ``remat`` recomputes each layer's
activations in the backward (``nn.remat``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import nn
from repro_torch.obs.trace import span

FAMILIES = ("dense", "moe", "vlm")


def check_supported(cfg) -> None:
    """The dense, moe and vlm families run here; a local/global pattern
    needs a whole number of superblocks (the reference asserts it)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not served by "
                                  f"models.lm")
    group = cfg.pattern_local + 1
    if cfg.pattern_local and cfg.num_layers % group:
        raise ValueError(
            f"{cfg.name}: num_layers={cfg.num_layers} is not a multiple of "
            f"the {cfg.pattern_local}:1 local/global superblock ({group} "
            f"layers)")


def _layer_init(cfg, dtype, generator, device):
    if cfg.family == "moe":
        return {"attn": L.attn_init(cfg, dtype, generator, device),
                "moe": MOE.moe_init(cfg, dtype, generator, device),
                "ln1": nn.norm_init(cfg.d_model, dtype, device),
                "ln2": nn.norm_init(cfg.d_model, dtype, device)}
    return L.block_init(cfg, dtype, generator, device)


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
             [_layer_init(cfg, dtype, generator, dev)
              for _ in range(cfg.num_layers)]),
         "final_norm": nn.norm_init(cfg.d_model, dtype, dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = nn.dense_init(cfg.d_model, cfg.vocab_size,
                                     bias=False, dtype=dtype,
                                     generator=generator, device=dev)
    return p


def layer_window(cfg, i: int) -> int:
    """Sliding window of layer ``i``: gemma3's local layers are the first
    ``pattern_local`` of each superblock; 0 (global) otherwise."""
    pat = cfg.pattern_local
    return cfg.local_window if pat and i % (pat + 1) < pat else 0


def _apply_layer(cfg, p, x, positions, *, window: int, mrope_positions):
    if cfg.family == "moe":
        h = L.self_attention(p["attn"], nn.norm(cfg, p["ln1"], x),
                             positions, cfg, window=window,
                             mrope_positions=mrope_positions)
        x = x + nn.residual(cfg, h)
        y, aux = MOE.moe_apply(p["moe"], nn.norm(cfg, p["ln2"], x), cfg)
        return x + nn.residual(cfg, y), aux
    x = L.block_apply(p, x, positions, cfg, window=window,
                      mrope_positions=mrope_positions)
    return x, None


def forward(cfg, params, tokens, *, positions=None, patch_embeds=None,
            mrope_positions=None, remat: bool = False,
            last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> logits [B,S,V] (f32) and aux loss."""
    check_supported(cfg)
    B, S = tokens.shape
    x = nn.embed_scale(cfg, nn.embed_lookup(params["embed"], tokens))
    if patch_embeds is not None:
        # vision stub: patch embeddings occupy the first n_patch positions
        n_patch = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, n_patch:]], dim=1)
    if positions is None:
        positions = torch.arange(S, device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    layer = nn.remat(_apply_layer, remat)
    for i in range(cfg.num_layers):
        x, a = layer(cfg, nn.layer_slice(params["layers"], i), x,
                     positions, window=layer_window(cfg, i),
                     mrope_positions=mrope_positions)
        if a is not None:
            aux = aux + a
    if last_only:
        x = x[:, -1:]
    x = nn.norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), aux


def _logits(cfg, params, x):
    with span("model.lm_head"):
        if cfg.tie_embeddings:
            logits = nn.embed_logits(params["embed"], x)
        else:
            logits = nn.dense(params["lm_head"], x)
        return nn.logits_scale(cfg, logits.float())


def loss_fn(cfg, params, tokens, labels, *, remat: bool = True):
    """Mean next-token cross entropy (labels = tokens shifted by caller),
    plus the MoE's load-balance term ``0.01 · aux / num_layers``."""
    logits, aux = forward(cfg, params, tokens, remat=remat)
    loss = nn.mean_nll(logits, labels)
    if cfg.family == "moe":
        loss = loss + 0.01 * aux / cfg.num_layers
    return loss
