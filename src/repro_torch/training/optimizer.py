"""AdamW with global-norm clipping and a cosine schedule (PyTorch port of
``training/optimizer.py``, single device).

The moments are float32 whatever the parameter dtype; the update is
computed in float32 and cast back on write; decoupled weight decay applies
to matrices only (``p.ndim >= 2``); the learning rate is the schedule's at
the incremented count.  The reference is functional; here ``apply``
updates the parameters and both moments in place (the full-width model's
optimizer state is most of the card's memory, so no second copy is made)
and returns the same tensors.  Parameter trees are nested dicts of
tensors (``models/nn.Params``).
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


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return nn.tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def apply(cfg: AdamWConfig, params, opt: OptState,
          grads) -> Tuple[Any, OptState, dict]:
    """One AdamW step; ``params``, ``opt.m`` and ``opt.v`` are updated in
    place (and returned).  ``grads`` has the tree of ``params``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
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
