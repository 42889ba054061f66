"""AdamW with global-norm clipping and a cosine schedule (PyTorch port of
``training/optimizer.py``).

The moments are float32 whatever the parameter dtype; the update is
computed in float32 and cast back on write; decoupled weight decay applies
to matrices only (``p.ndim >= 2``); the learning rate is the schedule's at
the incremented count.  The reference is functional; here ``apply``
updates the parameters and both moments in place (the full-width model's
optimizer state is most of the card's memory, so no second copy is made)
and returns the same tensors.  Parameter trees are nested dicts of
tensors (``models/nn.Params``).

On a mesh (``training/train_step.make_train_step(rules=)``) each rank
holds its shards of the parameters and moments (ZeRO: the moments take
the parameters' specs) and runs the same update on them; only the global
norm needs the mesh, and the caller passes it in (``sharded_global_norm``).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models import nn
from repro_torch.models.nn import tree_leaves as leaves


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: Any                # f32 tree, like params
    v: Any                # f32 tree, like params
    count: torch.Tensor   # int32 []


def init(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = leaves(params)[0].device
    return OptState(m=nn.tree_map(zeros, params), v=nn.tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (float32)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def sharded_global_norm(grads, specs) -> torch.Tensor:
    """The global norm of a tree of gradient shards: each leaf's local sum
    of squares is psum'd over the mesh axes that shard it (``specs``, a
    tree of ``P`` like ``grads``) and over no other, so a leaf replicated
    over ``model`` or ``pod`` counts once.  Leaves are grouped by those
    axes, one psum a group."""
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import spec_axes
    groups: dict = {}
    for g, sp in zip(leaves(grads), leaves(specs)):
        axes = spec_axes(sp)
        sq = torch.sum(torch.square(g.float()))
        groups[axes] = sq if axes not in groups else groups[axes] + sq
    mesh = C.current_mesh()
    total = None
    for axes in sorted(groups):
        part = C.psum(groups[axes], tuple(a for a in mesh.axis_names
                                          if a in axes)) if axes \
            else groups[axes]
        total = part if total is None else total + part
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Scale ``grads`` to a global norm of at most ``max_norm``; ``norm``
    is computed here unless given (a mesh's ``sharded_global_norm``)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return nn.tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def apply(cfg: AdamWConfig, params, opt: OptState,
          grads, norm=None) -> Tuple[Any, OptState, dict]:
    """One AdamW step; ``params``, ``opt.m`` and ``opt.v`` are updated in
    place (and returned).  ``grads`` has the tree of ``params``; ``norm``
    is their global norm when the caller computed it (on a mesh)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, norm)
    count = opt.count + 1
    lr = schedule(cfg, count)
    countf = count.float()
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=countf.device), countf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=countf.device), countf)
    with torch.no_grad():
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt.m),
                              leaves(opt.v)):
            g32 = g.float()
            m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
            v.mul_(cfg.b2).add_((g32 * (1 - cfg.b2)).mul_(g32))
            del g32
            step = m / b1c
            step.div_((v / b2c).sqrt_().add_(cfg.eps))
            p32 = p.float()
            if p.ndim >= 2:  # decoupled weight decay on matrices only
                step.add_(p32 * cfg.weight_decay)
            p.copy_(p32.sub_(step.mul_(lr)))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(m=opt.m, v=opt.v, count=count), metrics
