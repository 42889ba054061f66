"""Convert the JAX package's parameter tree into the port's.

Takes the reference's parameters as nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, repro.models.lm.init(cfg, key)[0])``:
stacked ``[L, ...]`` layers, ``lm_head`` when untied) and returns the same
tree as torch tensors of ``cfg``'s dtype on ``device``, but for the leaves
the reference keeps in float32 whatever the model dtype (``F32_LEAVES``:
the MoE router; the mamba block's ``A_log``, ``dt_bias`` and ``D``), which
stay float32.  Every family's tree goes through the same walk: the SSM
and hybrid families' ``layers.mamba`` / ``layers.ln`` and ``shared``,
encdec's ``encoder``, ``decoder`` (with ``cross`` and ``ln_cross``) and
``enc_norm``.  The layouts are the same on both
sides, so both compute the same function.  ``train_state_from_numpy`` does
the same for a whole train state (parameters, AdamW moments, count), and
``pod_error_from_numpy`` for the manual-pod step's error buffers.
On a mesh each rank converts only its own pieces (``specs``).  numpy
only: nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

# (parent key, leaf key) of the leaves the reference draws in float32
F32_LEAVES = {("moe", "router"), ("mamba", "A_log"), ("mamba", "dt_bias"),
              ("mamba", "D")}


def from_numpy_tree(tree, cfg, device=None, *, specs=None,
                    mesh=None) -> Dict[str, Any]:
    """With ``specs`` and ``mesh`` (a rank of a device mesh), the tree is
    first cut into this rank's pieces (``dist/sharding.local_shard``, e.g.
    with ``serving/engine.mesh_param_specs``), which land on the mesh's
    device: the single-device run and every mesh get the same weights."""
    if specs is not None:
        from repro_torch.dist.sharding import local_shard
        tree = local_shard(tree, specs, mesh)
        device = mesh.device if device is None else device
    dev = resolve_device(device)

    def conv(x, dtype):
        # bf16 arrays (ml_dtypes) go through f32: bf16 -> f32 -> bf16 is
        # exact
        a = np.asarray(x)
        if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=dev, dtype=dtype)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path[-1:] + (k,)) for k, v in t.items()}
        return conv(t, torch.float32 if path in F32_LEAVES
                    else cfg.activation_dtype())

    return walk(tree, ())


def train_state_from_numpy(params, m, v, count, cfg, device=None, step=None,
                           *, specs=None, mesh=None):
    """The reference's train state — ``params``, the AdamW moments ``m``
    and ``v`` (float32 trees like ``params``) and ``count``, all numpy —
    as the port's ``training.train_step.TrainState`` on ``device``, so both
    packages start a step from the same state.  ``step`` defaults to
    ``count``; the parameters require grad.  With ``specs`` (e.g.
    ``train_step.param_specs(cfg, rules)``) and ``mesh`` a rank gets its
    shards of the parameters and of both moments, on the mesh's device."""
    from repro_torch.models.nn import tree_leaves
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import TrainState

    if specs is not None:
        from repro_torch.dist.sharding import local_shard
        m, v = local_shard(m, specs, mesh), local_shard(v, specs, mesh)
        device = mesh.device if device is None else device
    dev = resolve_device(device)
    p = from_numpy_tree(params, cfg, dev, specs=specs, mesh=mesh)
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(x) for k, x in tree.items()}
        return torch.from_numpy(np.array(tree, np.float32)).to(dev)

    def i32(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=dev)

    return TrainState(params=p,
                      opt=opt.OptState(m=f32(m), v=f32(v), count=i32(count)),
                      step=i32(count if step is None else step))


def pod_error_from_numpy(err, mesh, device=None):
    """The reference's manual-pod error buffers (numpy trees of float32
    ``[npods, ...]``, sharded over ``pod``) as this rank's piece ``[1,
    ...]``: its pod's residual, on the mesh's device unless ``device``."""
    from repro_torch.dist.sharding import P, local_shard
    piece = local_shard(err, P("pod"), mesh)
    dev = resolve_device(mesh.device if device is None else device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(x) for k, x in t.items()}
        return torch.from_numpy(np.array(t, np.float32)).to(dev)
    return walk(piece)
