"""Mamba2 LM (attention-free; PyTorch port of ``models/ssm_lm.py``):
embed -> Mamba2 blocks -> logits.  The training loss waits for the
training slice (ROADMAP item 21)."""
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


def mamba_layers(cfg, stacked, x, lo: int, hi: int):
    """Full-sequence forward through the stacked mamba layers [lo, hi)."""
    for i in range(lo, hi):
        lp = nn.layer_slice(stacked, i)
        x = x + ssm.mamba_forward(lp["mamba"], nn.rmsnorm(lp["ln"], x), cfg)
    return x


def forward(cfg, params, tokens, *, last_only: bool = False,
            **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> logits [B,S,V] (f32) and a zero aux
    loss."""
    x = nn.embed_lookup(params["embed"], tokens)
    x = mamba_layers(cfg, params["layers"], x, 0, cfg.num_layers)
    if last_only:
        x = x[:, -1:]
    x = nn.rmsnorm(params["final_norm"], x)
    logits = nn.embed_logits(params["embed"], x).float()
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)
