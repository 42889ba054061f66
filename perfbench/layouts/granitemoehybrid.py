"""The port's side of the ``granitemoehybrid`` model
(``reference/granitemoehybrid.py``): the port's ``ModelConfig`` from the
configuration file's ``port`` block (a ``layer_types`` stack of the
hybrid family), the ``models/hybrid.py`` parameter tree laid out from the
benchmark's draws (views: the draws are in the port's layout already),
the port's full-sequence forward, and the CPU tests' cut.  Imports
``repro_torch`` when called, never when loaded."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def model_config(cfg: dict):
    from repro_torch.configs.base import ModelConfig
    port = dict(cfg["port"])
    port["layer_types"] = tuple(port["layer_types"])
    return ModelConfig(**port)


def params(cfg: dict, w: Dict[str, torch.Tensor]) -> dict:
    """The port's parameter tree (``models/hybrid.py``'s ``layer_types``
    layout: ``mamba``, ``attn`` and ``ffn`` stacked by kind) from the
    benchmark's draws."""
    pc = model_config(cfg)
    NA, d, nq, nkv, hd = (w["a_wq"].shape[0], pc.d_model, pc.num_heads,
                          pc.n_kv, pc.hd)
    mamba = {"w_z": w["m_wz"], "w_x": w["m_wx"], "w_bc": w["m_wbc"],
             "w_dt": w["m_wdt"], "conv_x_w": w["m_convx_w"],
             "conv_x_b": w["m_convx_b"], "conv_bc_w": w["m_convbc_w"],
             "conv_bc_b": w["m_convbc_b"], "A_log": w["m_A_log"],
             "dt_bias": w["m_dt_bias"], "D": w["m_D"], "norm": w["m_norm"],
             "w_out": w["m_out"]}
    attn = {"wq": w["a_wq"].reshape(NA, d, nq, hd),
            "wk": w["a_wk"].reshape(NA, d, nkv, hd),
            "wv": w["a_wv"].reshape(NA, d, nkv, hd),
            "wo": w["a_wo"].reshape(NA, nq, hd, d)}
    moe = {"router": w["f_router"], "wi_gate": w["f_wg"],
           "wi_up": w["f_wu"], "wo": w["f_wd"],
           "shared": {"wi_gate": w["f_sg"], "wi_up": w["f_su"],
                      "wo": w["f_sd"]}}
    return {"embed": {"embedding": w["embed"]},
            "mamba": {"mamba": mamba, "ln": {"scale": w["m_ln"]}},
            "attn": {"attn": attn, "ln": {"scale": w["a_ln"]}},
            "ffn": {"moe": moe, "ln": {"scale": w["f_ln"]}},
            "final_norm": {"scale": w["final_norm"]}}


def forward(cfg: dict, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The port's full-sequence forward (``models/hybrid.forward``) of one
    sequence ``tokens`` [S] in float32: logits [S, V], divided by
    ``logits_scaling``."""
    from repro_torch.models import hybrid, nn
    prm = nn.tree_map(lambda t: t.float(), params)
    pc = dataclasses.replace(model_config(cfg), dtype="float32")
    logits, _ = hybrid.forward(pc, prm, tokens[None])
    return logits[0]


def small(cfg: dict) -> dict:
    """The CPU tests' cut: every size cut down, the keys, the multipliers
    and the code paths the same (mamba layers around an attention layer,
    the MoE with its shared expert, two scan chunks in a short
    sequence)."""
    types = ["mamba", "attention", "mamba", "mamba"]
    sizes = dict(hidden_size=64, intermediate_size=32, vocab_size=256,
                 num_hidden_layers=4, layer_types=types,
                 num_attention_heads=4, num_key_value_heads=2,
                 num_local_experts=6, num_experts_per_tok=2,
                 shared_intermediate_size=48, mamba_n_heads=8,
                 mamba_d_head=16, mamba_d_state=16, mamba_chunk_size=16,
                 attention_multiplier=0.125)
    port = dict(d_model=64, d_ff=32, vocab_size=256, num_layers=4,
                layer_types=types, num_heads=4, num_kv_heads=2,
                head_dim=16, num_experts=6, experts_per_token=2,
                moe_capacity_factor=3.0, shared_d_ff=48, ssm_state=16,
                ssm_head_dim=16, ssm_chunk=16, attention_multiplier=0.125)
    cfg = dict(cfg, **sizes)
    cfg["port"] = dict(cfg["port"], **port)
    return cfg
