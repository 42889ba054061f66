"""Mixture-of-Experts MLP (PyTorch port of ``models/moe.py``): the
single-device path, and over a mesh the reference's expert-parallel and
data-parallel branches and the manual decode region's per-rank MoE.

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

A shared expert (``cfg.shared_d_ff``, GraniteMoeHybrid's shared MLP): one
SwiGLU MLP that every token passes through, added to the routed output
(``p["shared"]``), on one device.

On a mesh each rank combines its own experts' outputs in that same
order, and the ranks' partial outputs are summed by a psum in member order
(``dist/collectives``): a fixed-order collective, no atomics across
ranks either.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import nn
from repro_torch.obs.trace import span


def moe_init(cfg, dtype, generator: torch.Generator, device):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    tn = lambda shape, s, dt: nn.truncnorm(shape, s, dt, generator, device)
    p = {"router": tn((d, E), s_in, torch.float32),
         "wi_gate": tn((E, d, f), s_in, dtype),
         "wi_up": tn((E, d, f), s_in, dtype),
         "wo": tn((E, f, d), s_out, dtype)}
    if cfg.shared_d_ff:
        p["shared"] = L.mlp_init(d, cfg.shared_d_ff, dtype, generator, device)
    return p


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


def _moe_local(x, router, wig, wiu, wo, *, k: int, E: int, C: int,
               E_local: int = None, e_offset: int = 0):
    """MoE on this rank's experts ``e_offset .. e_offset + E_local - 1``
    (all E by default): x [T,d] -> (partial y [T,d], aux).  The tokens
    routed to other ranks' experts add nothing here; the caller's psum
    over the expert axis completes the sum."""
    E_local = E if E_local is None else E_local
    T, d = x.shape
    dev = x.device
    with span("model.moe.router"):
        logits = x.float() @ router                       # [T,E] f32
        probs = torch.softmax(logits, dim=-1)
        gates, ids = _router_top_k(logits, probs, k, E)   # [T,k]
        gates = gates / gates.sum(dim=-1, keepdim=True)

        # aux load-balance loss (Switch-style): E * sum_e f_e * P_e
        me = probs.mean(dim=0)                            # [E]
        ce = (ids.reshape(-1, 1) == torch.arange(E, device=dev)).sum(
            dim=0).float() / (T * k)
        aux = E * (me * ce).sum()

    with span("model.moe.dispatch"):
        experts = e_offset + torch.arange(E_local, device=dev)
        match = ids[None, :, :] == experts[:, None, None]  # [E_l,T,k]
        sel = match.any(dim=-1)                           # [E_l,T]
        pos = torch.cumsum(sel.to(torch.int32), dim=1) - 1    # [E_l,T]
        keep = sel & (pos < C)
        slot = torch.where(keep, pos, C).to(torch.int64)  # C = trash slot

        # capacity slots: buf[e, c] is the token in local expert e's slot c
        e_rows = torch.arange(E_local, device=dev)[:, None].expand(-1, T)
        buf = torch.zeros((E_local, C + 1, d), dtype=x.dtype, device=dev)
        buf[e_rows, slot] = torch.where(keep[..., None], x[None], 0)
        buf = buf[:, :C]

    with span("model.moe.experts"):
        h = F.silu(torch.bmm(buf, wig)) * torch.bmm(buf, wiu)
        out = torch.bmm(h, wo)                            # [E_l,C,d]

    # combine: token t's j-th expert output at its slot, or 0 if that
    # expert is another rank's or the token was dropped there
    with span("model.moe.combine"):
        li = ids - e_offset                               # [T,k]
        mine = (li >= 0) & (li < E_local)
        lic = li.clamp(0, E_local - 1)
        t_rows = torch.arange(T, device=dev)[:, None].expand(T, k)
        kept = mine & keep[lic, t_rows]                   # [T,k]
        contrib = out[lic, pos[lic, t_rows].clamp(0, C - 1)]  # [T,k,d]
        contrib = torch.where(kept[..., None],
                              contrib * gates[..., None], 0.0)    # f32
        return contrib.sum(dim=1).to(x.dtype), aux


def moe_param_specs(cfg, rules):
    """The specs the rules give the moe params (what ``moe_apply`` takes
    on a mesh)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    ax = {"router": ("embed", None),
          "wi_gate": ("experts", "embed", "mlp_shard"),
          "wi_up": ("experts", "embed", "mlp_shard"),
          "wo": ("experts", "mlp_shard", "embed")}
    shp = {"router": (d, E), "wi_gate": (E, d, f), "wi_up": (E, d, f),
           "wo": (E, f, d)}
    return {n: rules.spec(a, shp[n]) for n, a in ax.items()}


def moe_apply(p, x, cfg, rules=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> (y [B,S,d], aux_loss scalar).  ``rules`` defaults to
    the active ones (``dist.ctx``).

    On a mesh, ``p`` holds this rank's pieces as the rules cut them
    (``moe_param_specs``) and ``x`` this rank's piece of the activations:
    replicated in serve mode, the batch over (pod, data) in train mode.
    The result has x's layout.  The reference's two branches:

    - expert parallel (``experts`` maps onto ``model``): each rank runs its
      E/tp experts on its tokens (serve mode: all tokens, with the expert
      FFN width sharded over ``data``), then one psum over ``model`` (and
      ``data`` when the width is sharded) in member order;
    - data parallel otherwise: the tokens are split over every axis, every
      rank runs all experts on full weights (gathered here as GSPMD does
      outside the reference's region), and the outputs are gathered back.
    """
    with span("model.moe"):
        y, aux = _moe_apply(p, x, cfg, rules)
        if "shared" in p:
            with span("model.moe.shared"):
                y = y + L.swiglu(p["shared"], x)
        return y, aux


def _moe_apply(p, x, cfg, rules):
    from repro_torch.dist import collectives as C
    from repro_torch.dist import ctx
    from repro_torch.dist.sharding import P, reshard
    rules = ctx.current_rules() if rules is None else rules
    if rules is not None and "shared" in p:
        raise NotImplementedError("the shared expert runs on one device "
                                  "only")
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    if rules is None:
        y, aux = _moe_local(x.reshape(B * S, d), p["router"], p["wi_gate"],
                            p["wi_up"], p["wo"], k=k, E=E,
                            C=_capacity(B * S, k, E, cfg.moe_capacity_factor))
        return y.reshape(B, S, d), aux
    mesh = rules.mesh
    serve = rules.mode == "serve"
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    dp = rules.mesh_size(dp_axes)
    have_x = P() if serve or not dp_axes else P(dp_axes)
    B_glob = B * rules.mesh_size(have_x[0]) if have_x else B
    have = moe_param_specs(cfg, rules)
    ep = ("model" in mesh.shape and rules.axis_for("experts", E) is not None
          and E % mesh.shape["model"] == 0)
    if not ep:
        all_axes = tuple(a for a in ("pod", "data", "model")
                         if a in mesh.shape)
        n_all = rules.mesh_size(all_axes)
        want_x = P(all_axes) if B_glob % n_all == 0 else P()
        x_l = reshard(x, have_x, want_x)
        w = {n: reshard(p[n], have[n], P()) for n in have}
        Bl = x_l.shape[0]
        y, aux = _moe_local(x_l.reshape(Bl * S, d), w["router"],
                            w["wi_gate"], w["wi_up"], w["wo"], k=k, E=E,
                            C=_capacity(Bl * S, k, E,
                                        cfg.moe_capacity_factor))
        aux = C.psum(aux, all_axes) / n_all
        return reshard(y.reshape(Bl, S, d), want_x, have_x), aux
    tp = mesh.shape["model"]
    E_local = E // tp
    f_sharded = serve and "data" in mesh.shape and \
        cfg.d_ff % mesh.shape["data"] == 0
    f_spec = "data" if f_sharded else None
    want = {"router": P(), "wi_gate": P("model", None, f_spec),
            "wi_up": P("model", None, f_spec), "wo": P("model", f_spec)}
    w = {n: reshard(p[n], have[n], want[n]) for n in have}
    T_local = B * S
    y, aux = _moe_local(x.reshape(T_local, d), w["router"], w["wi_gate"],
                        w["wi_up"], w["wo"], k=k, E=E, E_local=E_local,
                        e_offset=C.axis_index("model") * E_local,
                        C=_capacity(T_local, k, E, cfg.moe_capacity_factor))
    y = C.psum(y, ("data", "model") if f_sharded else "model")
    aux = C.psum(aux, "model") / tp
    if dp_axes and not serve:
        aux = C.psum(aux, dp_axes) / dp
    return y.reshape(B, S, d), aux


def moe_decode_local(p, x, cfg):
    """Per-rank MoE of the fused manual decode region: tokens replicated,
    this rank's E/tp experts (``p`` cut by ``dist/tp.decode_param_specs``),
    combined by one psum over ``model``.  The aux loss is dropped (decode
    never trains the router).  x [B, S, d] -> y [B, S, d]."""
    from repro_torch.dist import collectives as C
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    E_local = p["wi_gate"].shape[0]
    y, _ = _moe_local(x.reshape(B * S, d), p["router"], p["wi_gate"],
                      p["wi_up"], p["wo"], k=k, E=E, E_local=E_local,
                      e_offset=C.axis_index("model") * E_local,
                      C=_capacity(B * S, k, E, cfg.moe_capacity_factor))
    return C.psum(y.reshape(B, S, d), "model")
