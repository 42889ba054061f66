"""Convert the JAX package's parameter tree into the port's.

Takes the reference's parameters as nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, repro.models.lm.init(cfg, key)[0])``:
stacked ``[L, ...]`` layers, ``lm_head`` when untied) and returns the same
tree as torch tensors of ``cfg``'s dtype on ``device``.  The layouts are
the same on both sides, so both compute the same function.  numpy only:
nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def from_numpy_tree(tree, cfg, device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    dtype = cfg.activation_dtype()

    def conv(x):
        # bf16 arrays (ml_dtypes) go through f32: bf16 -> f32 -> bf16 is
        # exact
        a = np.asarray(x)
        if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=dev, dtype=dtype)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return conv(t)

    return walk(tree)
