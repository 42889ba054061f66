"""Hash functions for the linear-probing table (PyTorch).

Multiply-shift hashing (Dietzfelbinger et al.): ``h(v) = (v * A mod 2^32) >>
(32 - k)`` for a table of size ``m = 2^k`` and odd seed-derived multiplier
``A``; for other ``m``, multiply-shift to 16 bits then scale.  Bitwise the
JAX package's ``core/hashing.py``, which computes in uint32 with
wrap-around.  torch has no shifts on uint32 CPU tensors, so every product
here is taken in int64 on values below ``2**32`` and masked back to 32 bits;
the 32-bit multiply is split into two 16-bit halves so that no int64
product can overflow.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def derive_multiplier(seed: int) -> int:
    """Derive an odd 32-bit multiplier from a seed (splitmix-style)."""
    z = (seed + 0x9E3779B9) & 0xFFFFFFFF
    z = (z ^ (z >> 16)) * 0x85EBCA6B & 0xFFFFFFFF
    z = (z ^ (z >> 13)) * 0xC2B2AE35 & 0xFFFFFFFF
    z = z ^ (z >> 16)
    return (z | 1) & 0xFFFFFFFF


def is_pow2(m: int) -> bool:
    return m > 0 and (m & (m - 1)) == 0


def as_u32(x) -> torch.Tensor:
    """An integer tensor as int64 holding its uint32 value (two's
    complement wrap of negative int32 input, like ``jnp.uint32``)."""
    return torch.as_tensor(x).to(torch.int64) & MASK32


def mul_u32(x: torch.Tensor, a: int) -> torch.Tensor:
    """``x * a mod 2^32`` for int64 ``x`` in [0, 2^32) and a python int
    ``a`` in [0, 2^32), without int64 overflow."""
    lo, hi = a & 0xFFFF, (a >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def hash_keys(keys, m: int, seed: int = 0) -> torch.Tensor:
    """Vectorized h(v) in [0, m) as int32.  ``keys``: integer tensor read
    as uint32."""
    x = mul_u32(as_u32(keys), derive_multiplier(seed))
    if is_pow2(m):
        k = m.bit_length() - 1
        if k == 0:
            return torch.zeros_like(x, dtype=torch.int32)
        return (x >> (32 - k)).to(torch.int32)
    # general m: multiply-shift to 16 bits then scale; the uint32 product
    # wraps exactly as the JAX package's does
    hi = x >> 16
    return (((hi * (m & MASK32)) & MASK32) >> 16).to(torch.int32)



def probe_distance(idx, start, m: int):
    """Distance of ``idx`` from ``start`` along the probe sequence (mod m),
    the paper's ``i - h(v)`` with wraparound.  Python ints give an int,
    tensors a tensor of their dtype."""
    d = idx - start
    if isinstance(d, torch.Tensor):
        return torch.where(d < 0, d + m, d)
    return d + m if d < 0 else d
