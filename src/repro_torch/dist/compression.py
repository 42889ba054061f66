"""Int8 gradient compression with error feedback (PyTorch port of
``dist/compression.py``).

Cross-pod gradient reduction is bandwidth-bound; int8 cuts wire bytes 4x
vs f32.  Plain quantization biases the update; error feedback carries the
quantization residual into the next step, so nothing is lost in
expectation.  Scales are per-tensor symmetric (absmax / 127) —
round-to-nearest error is bounded by half a quantization step.

``tree_compressed_psum`` is the compressed all-reduce over a mesh axis.
The wire carries each member's int8 payload and its f32 scale, not the
dequantized f32 values the reference's ``psum`` moves: every member
dequantizes each member's piece (``q.float() * scale``, the very values
the reference sends) and sums them in member order.  That is the
reference's sum of the dequantized values taken in that order, bit for
bit, at a quarter of the bytes (``compressed_bytes`` a member).
"""
from __future__ import annotations

from typing import Tuple

import torch

_QMAX = 127.0


def _quantize(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape, float) -> (q int8 flat [n], scale f32 scalar)."""
    flat = x.float().reshape(-1)
    absmax = flat.abs().max()
    scale = absmax.clamp_min(1e-30) / _QMAX
    q = torch.clamp(torch.round(flat / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def _dequantize(q, scale, n: int) -> torch.Tensor:
    """Inverse of ``_quantize``: first ``n`` elements as f32."""
    return q[:n].float() * scale


def compress_leaf(g, err) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback round for a gradient leaf: returns (sent, err')
    where ``sent`` is what goes on the wire (dequantized back to g's shape)
    and ``err'`` the residual to carry."""
    x32 = g.float() + err.float()
    q, scale = _quantize(x32)
    sent = _dequantize(q, scale, x32.numel()).reshape(g.shape)
    return sent, x32 - sent


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        from repro_torch.models.nn import tree_leaves
        return tree_leaves(tree)
    return list(tree) if isinstance(tree, (list, tuple)) else [tree]


def tree_compressed_psum(grads, axis, err):
    """Compressed all-reduce over mesh ``axis`` with error feedback:
    each member quantizes (grad + residual) to int8, the payloads and
    scales are all-gathered, and each member sums the dequantized pieces
    in member order.  ``grads`` and ``err`` are trees of the same
    structure (nested dicts).  Returns (summed grads in the grads' dtype,
    the residual err') — the caller divides by the axis size for a
    mean."""
    from repro_torch.dist import collectives as C

    def one(g, e):
        x32 = g.float() + e.float()
        q, scale = _quantize(x32)
        err2 = x32 - _dequantize(q, scale, x32.numel()).reshape(g.shape)
        # one int8 buffer per leaf: the payload, then the scale's 4 bytes
        wire = torch.cat([q, scale.reshape(1).view(torch.int8)])
        parts = C.all_gather(wire, axis, dim=0, tiled=False)
        n = x32.numel()
        acc = None
        for p in parts.unbind(0):
            piece = _dequantize(p[:n], p[n:].clone().view(torch.float32)[0], n)
            acc = piece if acc is None else acc + piece
        return acc.reshape(g.shape).to(g.dtype), err2

    def walk(g, e):
        """(summed, residual) trees, the leaves reduced in sorted key
        order (the same collectives in the same order on every member)."""
        if not isinstance(g, dict):
            return one(g, e)
        pairs = {k: walk(g[k], e[k]) for k in sorted(g)}
        return ({k: pairs[k][0] for k in g}, {k: pairs[k][1] for k in g})

    return walk(grads, err)


def compressed_bytes(tree) -> int:
    """Wire bytes a member sends for one compressed reduction of ``tree``
    (a tree or a list of tensors): the int8 payload plus one f32 scale per
    leaf."""
    return sum(int(x.numel()) + 4 for x in _leaves(tree))
