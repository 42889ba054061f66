"""The port's device rule and its host-sync accounting.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise and never move to the CPU
quietly.  Eager PyTorch code that branches on a device value has to wait
for the card: every such wait in the port goes through ``host_bool`` /
``host_int``, which count it in ``SYNC_STATS`` so a run can report host
syncs per token.
"""
from __future__ import annotations

import torch

SYNC_STATS = {"host_syncs": 0}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when a CUDA device is asked for and
    none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def host_bool(t: torch.Tensor) -> bool:
    """``bool(t)`` for a 0-dim tensor, counted as one host sync."""
    SYNC_STATS["host_syncs"] += 1
    return bool(t)


def host_int(t: torch.Tensor) -> int:
    """``int(t)`` for a 0-dim tensor, counted as one host sync."""
    SYNC_STATS["host_syncs"] += 1
    return int(t)


def host_numpy(t: torch.Tensor):
    """``t`` as a numpy array on the host, counted as one host sync."""
    SYNC_STATS["host_syncs"] += 1
    return t.detach().cpu().numpy()
