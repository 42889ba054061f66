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
sides, so both compute the same function.  numpy only: nothing here
imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

# (parent key, leaf key) of the leaves the reference draws in float32
F32_LEAVES = {("moe", "router"), ("mamba", "A_log"), ("mamba", "dt_bias"),
              ("mamba", "D")}


def from_numpy_tree(tree, cfg, device=None) -> Dict[str, Any]:
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
