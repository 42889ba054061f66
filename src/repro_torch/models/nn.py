"""Minimal functional NN substrate (PyTorch port of ``models/nn.py``).

Parameters are nested dicts of tensors in the JAX package's layouts
(``dense.w [d_in, d_out]``, stacked layers with a leading ``[L, ...]``
axis), so that the port and the reference compute the same function on
converted parameters (``models/convert``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.obs.trace import span

Params = Dict[str, Any]


def truncnorm(shape, scale: float, dtype, generator: torch.Generator,
              device) -> torch.Tensor:
    """Normal(0, scale) truncated to +-2 scale (by clamping), drawn in f32
    from ``generator`` on ``device``.  The port's own init; it does not
    reproduce ``jax.random``."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x.clamp_(-2.0, 2.0) * scale).to(dtype)


def dense_init(d_in: int, d_out: int, *, bias: bool, dtype, generator,
               device, scale: float | None = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": truncnorm((d_in, d_out), scale, dtype, generator, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def norm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    """RMSNorm computed in f32, cast back to x's dtype."""
    with span("model.rmsnorm"):
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
        return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# A block's arithmetic around its mixers, as the config sets it: every
# family's forward and decode step take these, and nothing else reads the
# four keys (Mamba-2's gated norm inside the mixer takes the eps itself).

def norm(cfg, p, x):
    """RMSNorm at ``cfg.rms_norm_eps``: each sub-layer's pre-norm and the
    final norm."""
    return rmsnorm(p, x, cfg.rms_norm_eps)


def residual(cfg, h):
    """A sub-layer's output as the residual stream adds it."""
    r = cfg.residual_multiplier
    return h if r == 1.0 else h * r


def embed_scale(cfg, x):
    """The token embedding as the first layer reads it."""
    m = cfg.embedding_multiplier
    return x if m == 1.0 else x * m


def logits_scale(cfg, y):
    """The float32 read-out divided by ``cfg.logits_scaling``."""
    s = cfg.logits_scaling
    return y if s == 1.0 else y / s


def embed_init(vocab: int, d: int, dtype, generator, device) -> Params:
    return {"embedding": truncnorm((vocab, d), d ** -0.5, dtype, generator,
                                   device)}


def embed_lookup(p, tokens):
    return p["embedding"][tokens]


def embed_logits(p, x):
    """Tied read-out: x [.., d] @ E^T -> [.., vocab]."""
    return x @ p["embedding"].T


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tensors of a nested-dict tree, in sorted key order (the order
    ``jax.tree.leaves`` gives the reference's dicts)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, flat: list):
    """``tree``'s nesting with the tensors of ``flat``, given in
    ``tree_leaves`` order."""
    it = iter(flat)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)
    return walk(tree)


def layer_slice(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked ``[L, ...]`` parameter tree (views)."""
    return tree_map(lambda t: t[i], stacked)


def remat(fn, enabled: bool):
    """``fn`` as is, or under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint(..., nothing_saveable)`` on its layer scan): the call
    saves only its inputs and recomputes its activations in the
    backward."""
    if not enabled:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def mean_nll(logits, labels) -> torch.Tensor:
    """Mean next-token negative log-likelihood: logits [B,S,V] (f32),
    labels [B,S] (the caller shifts them)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0].mean()


def stack_layer_params(layers) -> Params:
    """Stack a list of per-layer trees along a new leading axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layer_params([l[k] for l in layers]) for k in first}
    return torch.stack(layers, dim=0)

