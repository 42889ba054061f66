"""The train step for one device (PyTorch port of ``training/
train_step.py``'s GSPMD path): loss -> grad -> clip -> AdamW, with
activation remat per layer.

The reference's ``make_train_step_manual_pod`` (the cross-pod step with
int8 error-feedback gradient compression) and ``init_pod_error_buffers``
need the mesh, ROADMAP item 22b.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.models import nn
from repro_torch.models.registry import get_model
from repro_torch.training import optimizer as opt


class TrainState(NamedTuple):
    params: Any
    opt: opt.OptState
    step: torch.Tensor     # int32 []


def init_state(cfg, generator: torch.Generator, device=None) -> TrainState:
    """Random parameters from ``generator`` (the model's own ``init``),
    zero moments, step 0.  The reference also returns the logical axes of
    every leaf, which only its mesh reads."""
    params = get_model(cfg).init(cfg, generator, device)
    for p in nn.tree_leaves(params):
        p.requires_grad_(True)
    o = opt.init(params)
    return TrainState(params=params, opt=o, step=torch.zeros_like(o.count))


def make_loss_fn(cfg, remat: bool = True) -> Callable:
    model = get_model(cfg)

    def loss_fn(params, batch):
        kwargs = {}
        if "src_embeds" in batch:
            kwargs["src_embeds"] = batch["src_embeds"]
        if cfg.family == "vlm":
            logits, aux = model.forward(
                cfg, params, batch["tokens"],
                patch_embeds=batch.get("patch_embeds"),
                mrope_positions=batch.get("mrope_positions"),
                remat=remat)
            return nn.mean_nll(logits, batch["labels"]) + (
                0.01 * aux / cfg.num_layers if cfg.family == "moe" else 0.0)
        return model.loss_fn(cfg, params, batch["tokens"], batch["labels"],
                             remat=remat, **kwargs)

    return loss_fn


def make_train_step(cfg, adamw: Optional[opt.AdamWConfig] = None,
                    remat: bool = True) -> Callable:
    """``train_step(state, batch) -> (state', metrics)``; the parameters
    and moments of ``state`` are updated in place (``optimizer.apply``)."""
    adamw = adamw or opt.AdamWConfig()
    loss_fn = make_loss_fn(cfg, remat=remat)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        leaves = nn.tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(state.params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        params2, opt2, metrics = opt.apply(
            adamw, state.params, state.opt,
            nn.tree_unflatten(state.params, grads))
        metrics["loss"] = loss.detach()
        return TrainState(params2, opt2, state.step + 1), metrics

    return train_step
