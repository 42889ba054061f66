"""GPipe-style pipeline parallelism over the ``pod`` mesh axis (PyTorch
port of ``dist/pipeline.py``).

Layers are range-partitioned over the pipeline axis (stage s owns layers
[s·L/S, (s+1)·L/S)); the batch is split into M microbatches that flow
through the stages with ``ppermute`` shifts.  Classic GPipe fill/drain:
M + S - 1 ticks, bubble fraction (S-1)/(M+S-1).

It runs SPMD on a rank of ``launch/mesh.run_spmd``: the rank holds its
stage's layers (its cut ``[L/S, ...]`` of the stacked weights) and the
whole input.  The ranks of the other axes see the same input and compute
the same stage redundantly, as in the reference.  At the end the last
stage's outputs are psum'd over the pipeline axis, so every rank returns
them.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.dist import collectives as C


def bubble_fraction(microbatches: int, stages: int) -> float:
    """Idle fraction of the GPipe schedule."""
    return (stages - 1) / (microbatches + stages - 1)


def _pipeline_axis(mesh) -> str:
    if "pod" in mesh.shape:
        return "pod"
    return mesh.axis_names[0]


def stage_layers(cfg, mesh) -> slice:
    """The layers this rank's stage owns."""
    axis = _pipeline_axis(mesh)
    S = mesh.shape[axis]
    n = cfg.num_layers // S
    s = mesh.coords[axis]
    return slice(s * n, (s + 1) * n)


def make_pipelined_forward(cfg, mesh, apply_range: Callable,
                           microbatches: int = 4) -> Callable:
    """Returns ``fwd(w_local, x)`` == ``apply_range(w_stack, x)`` computed
    as an S-stage pipeline, where ``w_local`` is this rank's stage of the
    stacked weights (``w_stack[stage_layers(cfg, mesh)]``, a tensor or a
    tree of them).

    ``apply_range(w, x)`` must apply a [L_local, ...] stack of layer
    weights sequentially to ``x`` — the same callable runs the whole model
    on one device (S=1) and one stage of it here.  ``x`` is [B, ...] with
    B % microbatches == 0; ``cfg.num_layers % stages == 0``."""
    axis = _pipeline_axis(mesh)
    S = mesh.shape[axis]
    M = int(microbatches)
    L = cfg.num_layers
    if L % S:
        raise ValueError(f"num_layers={L} not divisible by {S} stages")

    def fwd(w_local, x):
        B = x.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        s = mesh.coords[axis]
        xs = x.reshape((M, B // M) + tuple(x.shape[1:]))
        buf = torch.zeros_like(xs[0])          # activation entering me
        outs = torch.zeros_like(xs)            # the last stage's results
        fwd_perm = [(i, i + 1) for i in range(S - 1)]
        for t in range(M + S - 1):
            cur = xs[min(t, M - 1)] if s == 0 else buf
            y = apply_range(w_local, cur)
            mb = t - (S - 1)
            if mb >= 0 and s == S - 1:
                outs[mb] = y
            if S > 1:
                buf = C.ppermute(y, axis, fwd_perm)
        # every stage gets the last stage's collected outputs
        if s != S - 1:
            outs = torch.zeros_like(outs)
        return C.psum(outs, axis).reshape(x.shape)

    return fwd
