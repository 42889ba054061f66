"""Train-step factories (PyTorch port of ``training/train_step.py``).

``make_train_step`` — loss -> grad -> clip -> AdamW, with activation
remat per layer.  Without ``rules`` it is the one-device step.  With
``rules`` (``dist/sharding.train_rules`` of a bound mesh) it is the
reference's GSPMD step, run SPMD on a rank of ``launch/mesh.run_spmd``:
each rank holds its shards of the parameters and AdamW moments, cut by
``rules.spec`` of their logical axes (FSDP of ``embed`` over ``data``,
Megatron leaves over ``model``).  A step

1. all-gathers the parameters, outside autograd;
2. runs the loss and its backward on this rank's slice of the batch (the
   batch over (pod, data), as the rules cut it);
3. cuts each gradient to the leaf's shard: its ``model`` cut locally,
   then ``reduce_scatter`` over the batch axes that shard the leaf, and a
   psum over the batch axes that do not (``pod``, or every batch axis for
   a leaf the rules leave whole), divided by the batch's rank count;
4. runs AdamW on the shards, clipped by the global norm, whose squares
   are psum'd only over the axes that shard each leaf.

It is GSPMD's arithmetic without tensor parallelism inside autograd: the
model axis computes redundantly, and ``dist/tp``'s forward collectives
stay detached.

``make_train_step_manual_pod`` — the reference's cross-pod variant: the
parameters are replicated, the batch is split over (pod, data), the
gradients are pmean'd over ``data`` and reduced over ``pod`` through
``dist/compression.tree_compressed_psum`` (int8 + error feedback), and
AdamW runs identically on every rank, so every rank's parameters keep the
same bits.  ``init_pod_error_buffers`` gives the per-pod residuals.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.models import nn
from repro_torch.models.registry import get_model
from repro_torch.training import optimizer as opt

# logical axes of the batch leaves (the reference dry-run's BATCH_LOGICAL)
BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "src_embeds": ("batch", "seq", None),
    "patch_embeds": ("batch", None, None),
    "mrope_positions": (None, "batch", "seq"),
}


class TrainState(NamedTuple):
    params: Any
    opt: opt.OptState
    step: torch.Tensor     # int32 []


def param_shapes(cfg) -> Dict[str, Any]:
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    memory."""
    return get_model(cfg).init(cfg, None, "meta")


def state_axes(cfg) -> TrainState:
    """The logical axes of every leaf of a train state (the reference's
    ``init_state`` returns them beside the state)."""
    axes = SH.param_axes(param_shapes(cfg))
    return TrainState(params=axes,
                      opt=opt.OptState(m=axes, v=axes, count=()), step=())


def param_specs(cfg, rules):
    """The spec tree a rank cuts the parameters (and their moments) with
    under ``rules``."""
    shapes = param_shapes(cfg)
    return rules.tree_specs(SH.param_axes(shapes), shapes)


def state_specs(cfg, rules) -> TrainState:
    """The spec tree of a rank's sharded train state (the moments take the
    parameters' specs; count and step are replicated)."""
    ps = param_specs(cfg, rules)
    return TrainState(params=ps, opt=opt.OptState(m=ps, v=ps,
                                                  count=SH.P()),
                      step=SH.P())


def init_state(cfg, generator: torch.Generator, device=None, *,
               rules=None) -> TrainState:
    """Random parameters from ``generator`` (the model's own ``init``),
    zero moments, step 0.  With ``rules`` every rank draws the same full
    parameters from the same seeded generator and keeps its shards (on
    the mesh's device), so a mesh and one device start from the same
    weights."""
    if rules is not None:
        device = rules.mesh.device if device is None else device
    params = get_model(cfg).init(cfg, generator, device)
    if rules is not None:
        params = SH.local_shard(params, param_specs(cfg, rules), rules.mesh)
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


def _loss_and_grads(loss_fn, params, batch):
    leaves = nn.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), grads


def make_train_step(cfg, adamw: Optional[opt.AdamWConfig] = None,
                    remat: bool = True, rules=None) -> Callable:
    """``train_step(state, batch) -> (state', metrics)``; the parameters
    and moments of ``state`` are updated in place (``optimizer.apply``).
    With ``rules`` the state holds this rank's shards (``init_state(
    rules=)``) and ``batch`` is the global batch, the same on every rank
    (see the module docstring)."""
    adamw = adamw or opt.AdamWConfig()
    loss_fn = make_loss_fn(cfg, remat=remat)
    if rules is not None:
        return _make_rules_step(cfg, adamw, loss_fn, rules)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, grads = _loss_and_grads(loss_fn, state.params, batch)
        params2, opt2, metrics = opt.apply(
            adamw, state.params, state.opt,
            nn.tree_unflatten(state.params, grads))
        metrics["loss"] = loss
        return TrainState(params2, opt2, state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# The rules-sharded step.

def batch_axes(rules, batch) -> tuple:
    """The mesh axes the global batch is split over under ``rules`` (mesh
    order; empty when the batch does not divide)."""
    B = batch["tokens"].shape[0]
    return SH._as_tuple(rules.axis_for("batch", B))


def local_batch(batch, axes, mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of the global ``batch`` over the mesh ``axes``
    (every leaf cut on its batch dim, ``BATCH_AXES``)."""
    if not axes:
        return dict(batch)
    entry = axes[0] if len(axes) == 1 else tuple(axes)
    out = {}
    for k, v in batch.items():
        spec = SH.P(*(entry if a == "batch" else None
                      for a in BATCH_AXES[k]))
        out[k] = v[SH.shard_slices(spec, tuple(v.shape), mesh)]
    return out


def gather_full(t: torch.Tensor, spec) -> torch.Tensor:
    """The full value of a shard ``t`` cut by ``spec`` (all-gathered
    over each dim's axes), detached."""
    for d, e in enumerate(spec):
        if SH._as_tuple(e):
            t = C.all_gather(t.detach(), SH._as_tuple(e), dim=d, tiled=True)
    return t.detach()


def shard_grad(g: torch.Tensor, spec, baxes, mesh) -> torch.Tensor:
    """This rank's shard (``spec``) of the batch-mean gradient, from its
    own full gradient ``g`` of the batch slice over ``baxes``: the dims
    cut over non-batch axes are cut locally, those over batch axes are
    reduce-scattered, and the remaining batch axes psum'd."""
    nb = 1
    for a in baxes:
        nb *= mesh.shape[a]
    spec = tuple(spec) + (None,) * (g.dim() - len(spec))
    local = SH.P(*(None if set(SH._as_tuple(e)) & set(baxes) else e
                   for e in spec))
    g = g[SH.shard_slices(local, tuple(g.shape), mesh)]
    done = set()
    for d, e in enumerate(spec):
        ax = SH._as_tuple(e)
        if not set(ax) & set(baxes):
            continue
        if not set(ax) <= set(baxes):
            raise ValueError(f"spec entry {e} mixes batch and other axes")
        g = C.reduce_scatter(g, ax, dim=d)
        done.update(ax)
    rest = tuple(a for a in mesh.axis_names if a in baxes and a not in done)
    if rest:
        g = C.psum(g, rest)
    return g / nb


def _make_rules_step(cfg, adamw, loss_fn, rules):
    mesh = rules.mesh
    specs = nn.tree_leaves(param_specs(cfg, rules))

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        shards = nn.tree_leaves(state.params)
        full = [gather_full(p, sp) for p, sp in zip(shards, specs)]
        baxes = batch_axes(rules, batch)
        loss, grads = _loss_and_grads(
            loss_fn, nn.tree_unflatten(state.params, full),
            local_batch(batch, baxes, mesh))
        del full
        nb = 1
        for a in baxes:
            nb *= mesh.shape[a]
        loss = C.psum(loss, baxes) / nb if baxes else loss
        gshards = []
        for i, sp in enumerate(specs):
            gshards.append(shard_grad(grads[i], sp, baxes, mesh))
            grads[i] = None
        gtree = nn.tree_unflatten(state.params, gshards)
        norm = opt.sharded_global_norm(
            gtree, nn.tree_unflatten(state.params, specs))
        params2, opt2, metrics = opt.apply(adamw, state.params, state.opt,
                                           gtree, norm=norm)
        metrics["loss"] = loss
        return TrainState(params2, opt2, state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# The cross-pod compressed step.

def make_train_step_manual_pod(cfg, mesh,
                               adamw: Optional[opt.AdamWConfig] = None,
                               remat: bool = True, rules=None) -> Callable:
    """``train_step(state, err, batch) -> (state', err', metrics)`` on a
    rank of ``mesh`` (which has a ``pod`` axis).  ``state`` is replicated
    (the whole parameters on every rank), ``batch`` the global batch,
    ``err`` this rank's pod's residuals (``init_pod_error_buffers(...,
    mesh=)``: a leading dim of 1, its piece of the reference's pod-sharded
    ``[npods, ...]``).  The batch is split over (pod, data), the gradients
    are pmean'd over ``data`` uncompressed, then reduced over ``pod``
    through int8 error-feedback compression and divided by npods; the
    loss is pmean'd over (pod, data); AdamW runs identically on every
    rank.  The ``model`` axis computes redundantly, as in the reference.
    ``rules`` is accepted for the reference's signature: the replicated
    step cuts nothing by it."""
    from repro_torch.dist import compression
    if "pod" not in mesh.shape:
        raise ValueError("the manual-pod step needs a pod axis")
    adamw = adamw or opt.AdamWConfig()
    loss_fn = make_loss_fn(cfg, remat=remat)
    dp_axes = tuple(a for a in ("data",) if a in mesh.shape)
    npods = mesh.shape["pod"]

    def train_step(state: TrainState, err, batch):
        axes = tuple(a for a in ("pod",) + dp_axes if mesh.shape[a] > 1)
        b = local_batch(batch, axes, mesh)
        loss, grads = _loss_and_grads(loss_fn, state.params, b)
        gtree = nn.tree_unflatten(state.params, grads)
        if dp_axes:      # within-pod DP mean, uncompressed
            nd = mesh.shape["data"]
            gtree = nn.tree_map(lambda g: C.psum(g, dp_axes) / nd, gtree)
        gtree, err2 = compression.tree_compressed_psum(
            gtree, "pod", nn.tree_map(lambda e: e[0], err))
        gtree = nn.tree_map(lambda g: g / npods, gtree)
        nl = 1
        for a in ("pod",) + dp_axes:
            nl *= mesh.shape[a]
        loss = C.psum(loss, ("pod",) + dp_axes) / nl
        params2, opt2, metrics = opt.apply(adamw, state.params, state.opt,
                                           gtree)
        err2 = nn.tree_map(lambda e: e[None], err2)
        return (TrainState(params2, opt2, state.step + 1), err2,
                {"loss": loss, "grad_norm": metrics["grad_norm"],
                 "lr": metrics["lr"]})

    return train_step


def init_pod_error_buffers(params, npods: int, mesh=None):
    """Per-pod error-feedback residuals in float32: ``[npods, ...]`` like
    each parameter (the reference's layout), or with ``mesh`` this rank's
    piece of it, ``[1, ...]`` (the residual of its pod)."""
    n = 1 if mesh is not None else npods
    return nn.tree_map(lambda p: torch.zeros((n,) + tuple(p.shape),
                                             dtype=torch.float32,
                                             device=p.device), params)
