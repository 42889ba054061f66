"""Family -> model module dispatch (only the dense family is ported)."""
from __future__ import annotations

from repro_torch.models import lm

_NOT_PORTED = {
    "moe": "ROADMAP item 14",
    "vlm": "ROADMAP item 16",
    "ssm": "ROADMAP item 17",
    "hybrid": "ROADMAP item 17",
    "encdec": "ROADMAP item 18",
}


def get_model(cfg):
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(f"family {cfg.family!r} is not ported "
                                  f"yet: {_NOT_PORTED[cfg.family]}")
    lm.check_supported(cfg)
    return lm
