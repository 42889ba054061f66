"""Family -> model module dispatch, as the reference's ``_FAMILY_MODULES``:
the dense, moe and vlm families are served by ``models.lm``, the ssm
family by ``models.ssm_lm``, the hybrid by ``models.hybrid`` and encdec by
``models.encdec``."""
from __future__ import annotations

from repro_torch.models import encdec, hybrid, lm, ssm_lm

_FAMILY_MODULES = {
    "dense": lm,
    "moe": lm,
    "vlm": lm,
    "ssm": ssm_lm,
    "hybrid": hybrid,
    "encdec": encdec,
}


def check_supported(cfg) -> None:
    """Raises for a family the port does not know, or a depth its decode
    cannot serve (gemma3 off its superblocks, a hybrid below one group)."""
    if cfg.family not in _FAMILY_MODULES:
        raise NotImplementedError(f"unknown model family {cfg.family!r}")
    mod = _FAMILY_MODULES[cfg.family]
    if mod is lm:
        lm.check_supported(cfg)
    elif mod is hybrid:
        hybrid.check_supported(cfg)


def get_model(cfg):
    check_supported(cfg)
    return _FAMILY_MODULES[cfg.family]
