"""Mixture-of-Experts MLP, single device (PyTorch port of ``models/moe.py``,
the path the reference takes when no mesh is active).

Capacity: static per-expert capacity C = ceil(T·k/E · cf) rounded up to 8;
overflow tokens are dropped (gates renormalized over the surviving
experts).  Expert selection is the reference's: top-k of the grid-snapped
router logits with a lower-expert-index tie-break, gates from the exact
probabilities.  The router computes in float32 whatever the model dtype
(its weight is float32, as in the reference).

The combine is deterministic: each token gathers its k expert outputs
into ``[T, k, d]`` and sums over k, where the reference scatter-adds them,
so no atomic add decides the bits and a decode step gives the same bits on
every run.  Nothing here waits on the card (no ``bincount``, no
data-dependent shape).

Expert parallelism over a mesh (the reference's ``shard_map`` branches and
``moe_decode_local``) is ROADMAP item 22.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import nn


def moe_init(cfg, dtype, generator: torch.Generator, device):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    tn = lambda shape, s, dt: nn.truncnorm(shape, s, dt, generator, device)
    return {"router": tn((d, E), s_in, torch.float32),
            "wi_gate": tn((E, d, f), s_in, dtype),
            "wi_up": tn((E, d, f), s_in, dtype),
            "wo": tn((E, f, d), s_out, dtype)}


def _capacity(T: int, k: int, E: int, factor: float) -> int:
    c = int(math.ceil(T * k / E * factor))
    return min(T, max(8, -(-c // 8) * 8))


# Router snap grid: the reference snaps the raw logits to this grid and
# breaks ties by expert index, so that reduction-order noise cannot flip an
# expert (see the reference module for the full argument).
ROUTER_SNAP_GRID = 1.0 / 64.0


def _router_top_k(logits, probs, k: int, E: int):
    """top-k of the grid-snapped logits, lower expert index first on ties;
    gates from the exact probabilities.  ``torch.round`` rounds half to
    even like ``jnp.round``, and the keys ``snapped·(E+1) − idx`` are
    distinct, so ``topk`` returns the reference's ids in its order."""
    snapped = torch.round(logits / ROUTER_SNAP_GRID)      # [T,E] small ints
    idx = torch.arange(E, dtype=torch.float32, device=logits.device)
    _, ids = torch.topk(snapped * (E + 1.0) - idx[None, :], k, dim=-1)
    gates = torch.gather(probs, -1, ids)                  # [T,k]
    return gates, ids


def _moe_local(x, router, wig, wiu, wo, *, k: int, E: int, C: int):
    """All experts on one device: x [T,d] -> (y [T,d], aux)."""
    T, d = x.shape
    dev = x.device
    logits = x.float() @ router                           # [T,E] f32
    probs = torch.softmax(logits, dim=-1)
    gates, ids = _router_top_k(logits, probs, k, E)       # [T,k]
    gates = gates / gates.sum(dim=-1, keepdim=True)

    experts = torch.arange(E, device=dev)
    match = ids[None, :, :] == experts[:, None, None]     # [E,T,k]

    # aux load-balance loss (Switch-style): E * sum_e f_e * P_e
    me = probs.mean(dim=0)                                # [E]
    ce = match.sum(dim=(1, 2)).float() / (T * k)
    aux = E * (me * ce).sum()

    sel = match.any(dim=-1)                               # [E,T]
    pos = torch.cumsum(sel.to(torch.int32), dim=1) - 1    # [E,T]
    keep = sel & (pos < C)
    slot = torch.where(keep, pos, C).to(torch.int64)      # C = trash slot

    # capacity slots: buf[e, c] is the token in expert e's slot c
    e_rows = experts[:, None].expand(E, T)
    buf = torch.zeros((E, C + 1, d), dtype=x.dtype, device=dev)
    buf[e_rows, slot] = torch.where(keep[..., None], x[None], 0)
    buf = buf[:, :C]

    h = F.silu(torch.bmm(buf, wig)) * torch.bmm(buf, wiu)
    out = torch.bmm(h, wo)                                # [E,C,d]

    # combine: token t's j-th expert output at its slot, or 0 if the token
    # was dropped there
    t_rows = torch.arange(T, device=dev)[:, None].expand(T, k)
    kept = keep[ids, t_rows]                              # [T,k]
    contrib = out[ids, pos[ids, t_rows].clamp(0, C - 1)]  # [T,k,d]
    contrib = torch.where(kept[..., None],
                          contrib * gates[..., None], 0.0)    # f32
    return contrib.sum(dim=1).to(x.dtype), aux


def moe_apply(p, x, cfg, rules=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> (y [B,S,d], aux_loss scalar)."""
    if rules is not None:
        raise NotImplementedError(
            "MoE over a mesh (expert parallelism) is ROADMAP item 22")
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    y, aux = _moe_local(x.reshape(B * S, d), p["router"], p["wi_gate"],
                        p["wi_up"], p["wo"], k=k, E=E,
                        C=_capacity(B * S, k, E, cfg.moe_capacity_factor))
    return y.reshape(B, S, d), aux


def moe_decode_local(p, x, cfg):
    """The reference's per-chip MoE inside the manual decode region."""
    raise NotImplementedError(
        "moe_decode_local (the manual-TP decode region) is ROADMAP item 22")
