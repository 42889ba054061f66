"""Family -> model module dispatch: the dense, moe and vlm families are
served by ``models.lm``; the others raise naming their ROADMAP item."""
from __future__ import annotations

from repro_torch.models import lm


def get_model(cfg):
    lm.check_supported(cfg)
    return lm
