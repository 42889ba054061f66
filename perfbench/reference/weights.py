"""The weights of a configuration, drawn on the device from the run's seed
in a few large calls, in the type they are served in (bf16; the MoE
router float32), in the published layout: the published head counts, the
layers stacked on a leading axis.

The harness hands these tensors to the port (``perfbench/port.py`` lays
them out as the port wants them); the reference draws them again from
the same seed.  Matrices are ``N(0, 1/fan_in)``, biases ``N(0, 0.1^2)``,
norm scales ``1 + N(0, 0.1^2)``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

BF16, F32 = torch.bfloat16, torch.float32


def plan(cfg: dict) -> List[Tuple[str, tuple, float, float, torch.dtype]]:
    """(name, shape, scale, offset, dtype) of every tensor, in draw order."""
    d, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // nq
    ff, E = cfg["intermediate_size"], cfg.get("num_local_experts", 0)
    mat = lambda n, shape, fan_in, dt=BF16: (n, shape, fan_in ** -0.5,
                                             0.0, dt)
    out = [mat("embed", (V, d), d)]
    if not cfg["tie_word_embeddings"]:
        out.append(mat("lm_head", (d, V), d))
    out += [mat("wq", (L, d, nq * hd), d), mat("wk", (L, d, nkv * hd), d),
            mat("wv", (L, d, nkv * hd), d), mat("wo", (L, nq * hd, d),
                                                nq * hd)]
    if cfg["qkv_bias"]:
        out += [("bq", (L, nq * hd), 0.1, 0.0, BF16),
                ("bk", (L, nkv * hd), 0.1, 0.0, BF16),
                ("bv", (L, nkv * hd), 0.1, 0.0, BF16)]
    out += [("ln1", (L, d), 0.1, 1.0, BF16), ("ln2", (L, d), 0.1, 1.0, BF16),
            ("final_norm", (d,), 0.1, 1.0, BF16)]
    if E:
        out += [mat("router", (L, d, E), d, F32),
                mat("wg", (L, E, d, ff), d), mat("wu", (L, E, d, ff), d),
                mat("wd", (L, E, ff, d), ff)]
    else:
        out += [mat("wg", (L, d, ff), d), mat("wu", (L, d, ff), d),
                mat("wd", (L, ff, d), ff)]
    return out


def draw(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of ``cfg``, drawn from ``seed`` on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = {}
    for name, shape, scale, offset, dt in plan(cfg):
        t = torch.randn(shape, generator=gen, dtype=dt, device=dev)
        t.mul_(scale)
        if offset:
            t.add_(offset)
        out[name] = t
    return out


def nbytes(cfg: dict) -> int:
    return sum(math.prod(s) * (4 if dt == F32 else 2)
               for _, s, _, _, dt in plan(cfg))
