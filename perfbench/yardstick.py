"""The published peaks of the card and the operation and byte counts the
per-layer metrics divide by them.  Counted from the configuration's
published sizes (the published head count, not the port's padding; the
experts a token uses, not the port's capacity slots), so that a later
change to the program cannot move the yardstick.

What depends on the model (the matmul weights a token uses, the layers
that attend over the paged KV) comes from the configuration's model
module (``modules.reference``).

Peaks: NVIDIA's H100 SXM data sheet, dense rates at 700 W.
"""
from __future__ import annotations

from perfbench import modules

H100_BF16_FLOPS = 989e12       # dense bf16 tensor-core rate
H100_HBM_BYTES_PER_S = 3.35e12  # device memory


def sizes(cfg: dict) -> dict:
    """The published sizes a count needs, read from a configuration file
    (``L``: every layer, of whatever kind)."""
    d = cfg["hidden_size"]
    nq = cfg["num_attention_heads"]
    return dict(d=d, nq=nq, nkv=cfg["num_key_value_heads"],
                hd=cfg.get("head_dim") or d // nq,
                ff=cfg["intermediate_size"], V=cfg["vocab_size"],
                L=cfg["num_hidden_layers"],
                E=cfg.get("num_local_experts", 0),
                k=cfg.get("num_experts_per_tok", 0))


def matmul_params_per_token(cfg: dict) -> int:
    """Weights a token multiplies by, the LM head included: the
    configuration's model module counts them (``modules.reference``)."""
    return modules.reference(cfg).matmul_params_per_token(cfg)


def window_flops(cfg: dict, steps: int, attended: int) -> float:
    """Model FLOPs of ``steps`` lane token steps that attended ``attended``
    tokens in all (summed over the steps): 2 per matmul weight a token
    uses, and q.k and p.v in each paged layer."""
    s = sizes(cfg)
    per_attended = 4 * s["nq"] * s["hd"] * paged_layers(cfg)
    return 2.0 * matmul_params_per_token(cfg) * steps \
        + float(per_attended) * attended


def k1_bytes(cfg: dict, steps: int, attended: int, max_pages: int,
             kv_bytes: int = 2, q_bytes: int = 2) -> float:
    """Bytes the fused decode attention K1 needs over ``steps`` lane token
    steps that attended ``attended`` tokens in all, summed over the paged
    layers: each attended token's K and V read once, and per lane step q
    (published heads), the f32 partials (o, m, l) written, the lane's
    block-table row and its position read.  The paged layers are the
    model module's ``paged_layers``."""
    s = sizes(cfg)
    nq, nkv, hd = s["nq"], s["nkv"], s["hd"]
    per_token = 2 * nkv * hd * kv_bytes
    per_step = (nq * hd * q_bytes + 4 * (nq * hd + 2 * nq)
                + 4 * max_pages + 4)
    return float(paged_layers(cfg)) * (per_token * attended
                                       + per_step * steps)


def paged_layers(cfg: dict) -> int:
    """Layers that attend over the paged KV through K1."""
    return modules.reference(cfg).paged_layers(cfg)


def lane_steps(p0, p1) -> tuple:
    """(steps, attended) of one round from the lanes' positions before and
    after it: a lane that moved from p0 to p1 ran the steps at positions
    p0 .. p1 - 1, the step at position p attending p + 1 tokens."""
    steps = attended = 0
    for a, b in zip(p0, p1):
        a, b = int(a), int(b)
        if b > a:
            steps += b - a
            attended += (b * (b + 1) - a * (a + 1)) // 2
    return steps, attended
