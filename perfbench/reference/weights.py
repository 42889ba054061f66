"""The weights of a configuration, drawn on the device from the run's seed
in a few large calls, in the type they are served in (bf16; the MoE
router float32), in the published layout that the configuration's model
module plans (``reference/<model>.py``'s ``plan``).

The harness hands these tensors to the port (the model's
``layouts/<model>.py`` lays them out as the port wants them); the
reference draws them again from the same seed.  The decoder's matrices
are ``N(0, 1/fan_in)``, biases ``N(0, 0.1^2)``, norm scales
``1 + N(0, 0.1^2)``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from perfbench import modules

F32 = torch.float32


def plan(cfg: dict) -> List[Tuple[str, tuple, float, float, torch.dtype]]:
    """(name, shape, scale, offset, dtype) of every tensor, in draw order:
    the configuration's model module's (``modules.reference``)."""
    return modules.reference(cfg).plan(cfg)


def draw(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of ``cfg``, drawn from ``seed`` on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = {}
    for name, shape, scale, offset, dt in plan(cfg):
        t = torch.randn(shape, generator=gen, dtype=dt, device=dev)
        t.mul_(scale)
        if offset:
            t.add_(offset)
        out[name] = t
    return out


def nbytes(cfg: dict) -> int:
    return sum(math.prod(s) * (4 if dt == F32 else 2)
               for _, s, _, _, dt in plan(cfg))
