"""Mamba2 LM (attention-free; PyTorch port of ``models/ssm_lm.py``):
embed -> Mamba2 blocks -> logits, and the next-token loss."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import nn
from repro_torch.models import ssm


def layer_init(cfg, dtype, generator, device):
    """One Mamba2 layer: the block and its pre-norm."""
    return {"mamba": ssm.mamba_init(cfg, dtype, generator, device),
            "ln": nn.norm_init(cfg.d_model, dtype, device)}


def init(cfg, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random parameters in the reference's layout, drawn from
    ``generator``."""
    dev = resolve_device(device)
    dtype = cfg.activation_dtype()
    return {"embed": nn.embed_init(cfg.vocab_size, cfg.d_model, dtype,
                                   generator, dev),
            "layers": nn.stack_layer_params(
                [layer_init(cfg, dtype, generator, dev)
                 for _ in range(cfg.num_layers)]),
            "final_norm": nn.norm_init(cfg.d_model, dtype, dev)}


def _mamba_layer(cfg, lp, x):
    h = ssm.mamba_forward(lp["mamba"], nn.norm(cfg, lp["ln"], x), cfg)
    return x + nn.residual(cfg, h)


def mamba_layers(cfg, stacked, x, lo: int, hi: int, remat: bool = False):
    """Full-sequence forward through the stacked mamba layers [lo, hi);
    ``remat`` recomputes each layer's activations in the backward."""
    layer = nn.remat(_mamba_layer, remat)
    for i in range(lo, hi):
        x = layer(cfg, nn.layer_slice(stacked, i), x)
    return x


def forward(cfg, params, tokens, *, remat: bool = False,
            last_only: bool = False,
            **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> logits [B,S,V] (f32) and a zero aux
    loss."""
    x = nn.embed_scale(cfg, nn.embed_lookup(params["embed"], tokens))
    x = mamba_layers(cfg, params["layers"], x, 0, cfg.num_layers, remat)
    if last_only:
        x = x[:, -1:]
    x = nn.norm(cfg, params["final_norm"], x)
    logits = nn.logits_scale(cfg, nn.embed_logits(params["embed"],
                                                  x).float())
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg, params, tokens, labels, *, remat: bool = True):
    """Mean next-token cross entropy (labels = tokens shifted by caller)."""
    logits, _ = forward(cfg, params, tokens, remat=remat)
    return nn.mean_nll(logits, labels)
