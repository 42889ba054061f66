"""The hybrid family: zamba2's shared block (the PyTorch port of
``models/hybrid.py``), and granitemoehybrid's ``layer_types`` stack.

Zamba2: a Mamba2 backbone and ONE shared (attention + MLP) block whose
parameters are reused after every ``shared_attn_every`` mamba layers.

38 = 6·6 + 2 for the full config: six groups of (6 mamba layers, then
the shared block), then 2 trailing mamba layers.  Each invocation of the
shared block has its own KV pages at decode time (parameters shared,
state not).  ``remat`` recomputes each mamba layer's activations in the
backward, as the reference's checkpointed mamba scan does.

The ``layer_types`` stack (``cfg.layer_types`` non-empty; GraniteMoeHybrid):
layer i's mixer is a Mamba2 layer or a GQA attention layer (no positions
with ``position_embedding == "nope"``), as ``layer_types[i]`` says, and
every layer has an FFN of its own (the MoE with its shared expert, or a
SwiGLU MLP):

    x += residual_multiplier * mixer(rmsnorm(x))
    x += residual_multiplier * ffn(rmsnorm(x))

with the embedding scaled by ``embedding_multiplier`` and the logits
divided by ``logits_scaling``; every norm takes ``rms_norm_eps``.
These four are ``models/nn``'s block helpers, which every family takes
(at their defaults they change nothing).  Its parameters are stacked by
kind: ``mamba`` [n_mamba, ...] (the mamba block and its pre-norm
``ln``), ``attn`` [n_attn, ...] (``attn``, ``ln``) and ``ffn``
[num_layers, ...] (``moe`` or ``mlp``, ``ln``); the mamba state and the
KV pools hold only their own kind's layers, in order.

The decode step is ``serving/engine``'s one layer loop, whose plan reads
the order from ``layer_kinds`` and ``num_shared_invocations``; every
mamba layer there writes its state in place
(``ssm.mamba_decode_step_``), on one device and on a mesh alike.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import nn
from repro_torch.models import ssm
from repro_torch.models import ssm_lm
from repro_torch.models import moe as MOE

MIXERS = ("mamba", "attention")


def num_shared_invocations(cfg) -> int:
    return cfg.num_layers // cfg.shared_attn_every


def layer_kinds(cfg) -> List[Tuple[str, int]]:
    """(kind, index among the layers of that kind) of each layer of a
    ``layer_types`` stack."""
    seen = {k: 0 for k in MIXERS}
    out = []
    for kind in cfg.layer_types:
        out.append((kind, seen[kind]))
        seen[kind] += 1
    return out


def num_mamba_layers(cfg) -> int:
    """Layers that carry a mamba state."""
    if cfg.layer_types:
        return cfg.layer_types.count("mamba")
    return cfg.num_layers


def check_supported(cfg) -> None:
    """Decode serves the attention from the page table, so a depth below
    one group (zamba2), or a ``layer_types`` stack without an attention
    layer, would leave the state without one (the reference's decode
    would fail on its missing table)."""
    if cfg.layer_types:
        bad = sorted(set(cfg.layer_types) - set(MIXERS))
        if bad or len(cfg.layer_types) != cfg.num_layers \
                or "attention" not in cfg.layer_types:
            raise ValueError(
                f"{cfg.name}: layer_types must give one of {MIXERS} for "
                f"each of the {cfg.num_layers} layers, one attention layer "
                f"at least (got {cfg.layer_types})")
        return
    if num_shared_invocations(cfg) < 1:
        raise ValueError(
            f"{cfg.name}: num_layers={cfg.num_layers} is below one group of "
            f"{cfg.shared_attn_every} mamba layers, so the shared attention "
            f"block never runs")


def _typed_init(cfg, generator, dev) -> Dict[str, Any]:
    dtype = cfg.activation_dtype()
    d = cfg.d_model

    def ffn():
        p = {"ln": nn.norm_init(d, dtype, dev)}
        if cfg.num_experts:
            p["moe"] = MOE.moe_init(cfg, dtype, generator, dev)
        else:
            p["mlp"] = L.mlp_init(d, cfg.d_ff, dtype, generator, dev)
        return p

    def attn():
        return {"attn": L.attn_init(cfg, dtype, generator, dev),
                "ln": nn.norm_init(d, dtype, dev)}

    n_attn = cfg.layer_types.count("attention")
    return {"embed": nn.embed_init(cfg.vocab_size, d, dtype, generator, dev),
            "mamba": nn.stack_layer_params(
                [ssm_lm.layer_init(cfg, dtype, generator, dev)
                 for _ in range(num_mamba_layers(cfg))]),
            "attn": nn.stack_layer_params([attn() for _ in range(n_attn)]),
            "ffn": nn.stack_layer_params([ffn()
                                          for _ in range(cfg.num_layers)]),
            "final_norm": nn.norm_init(d, dtype, dev)}


def _typed_layer(cfg, params, i, kind, j, x, positions):
    if kind == "mamba":
        mp = nn.layer_slice(params["mamba"], j)
        h = ssm.mamba_forward(mp["mamba"], nn.norm(cfg, mp["ln"], x), cfg)
    else:
        ap = nn.layer_slice(params["attn"], j)
        h = L.self_attention(ap["attn"], nn.norm(cfg, ap["ln"], x),
                             positions, cfg)
    x = x + nn.residual(cfg, h)
    fp = nn.layer_slice(params["ffn"], i)
    h = nn.norm(cfg, fp["ln"], x)
    if "moe" in fp:
        y, aux = MOE.moe_apply(fp["moe"], h, cfg)
    else:
        y, aux = L.mlp_apply(fp["mlp"], h), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    return x + nn.residual(cfg, y), aux


def init(cfg, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random parameters in the reference's layout (the mamba layers
    stacked, the one shared block), drawn from ``generator``; a
    ``layer_types`` stack's stacked by kind."""
    dev = resolve_device(device)
    if cfg.layer_types:
        return _typed_init(cfg, generator, dev)
    dtype = cfg.activation_dtype()
    return {"embed": nn.embed_init(cfg.vocab_size, cfg.d_model, dtype,
                                   generator, dev),
            "layers": nn.stack_layer_params(
                [ssm_lm.layer_init(cfg, dtype, generator, dev)
                 for _ in range(cfg.num_layers)]),
            "shared": L.block_init(cfg, dtype, generator, dev),
            "final_norm": nn.norm_init(cfg.d_model, dtype, dev)}


def forward(cfg, params, tokens, *, remat: bool = False,
            last_only: bool = False,
            **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> logits [B,S,V] (f32) and the aux loss
    (zero, or a ``layer_types`` stack's MoE load-balance terms)."""
    x = nn.embed_scale(cfg, nn.embed_lookup(params["embed"], tokens))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.layer_types:
        layer = nn.remat(_typed_layer, remat)
        for i, (kind, j) in enumerate(layer_kinds(cfg)):
            x, a = layer(cfg, params, i, kind, j, x, positions)
            aux = aux + a
    else:
        every = cfg.shared_attn_every
        n_inv = num_shared_invocations(cfg)
        for g in range(n_inv):
            x = ssm_lm.mamba_layers(cfg, params["layers"], x, g * every,
                                    (g + 1) * every, remat)
            x = L.block_apply(params["shared"], x, positions, cfg)
        x = ssm_lm.mamba_layers(cfg, params["layers"], x, n_inv * every,
                                cfg.num_layers, remat)
    if last_only:
        x = x[:, -1:]
    x = nn.norm(cfg, params["final_norm"], x)
    return lm._logits(cfg, params, x), aux


def loss_fn(cfg, params, tokens, labels, *, remat: bool = True):
    """Mean next-token cross entropy (labels = tokens shifted by caller),
    plus a ``layer_types`` stack's MoE term ``0.01 · aux / num_layers``,
    as ``models.lm``'s."""
    logits, aux = forward(cfg, params, tokens, remat=remat)
    loss = nn.mean_nll(logits, labels)
    if cfg.layer_types and cfg.num_experts:
        loss = loss + 0.01 * aux / cfg.num_layers
    return loss
