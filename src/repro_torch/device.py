"""The port's device rule and its host-sync accounting.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise and never move to the CPU
quietly.  Eager PyTorch code that branches on a device value, or copies
host data to the card, has to wait for the card: every such wait in the
port goes through the helpers below (``host_bool``, ``host_int``,
``host_numpy``, ``host_nonzero``, ``to_card``), which count it in
``SYNC_STATS`` so a run can report host syncs per token.  They count
structurally, on the CPU too.  ``strict_syncs`` turns every other wait of
the card into an error, which is how a test shows that none escapes the
count.
"""
from __future__ import annotations

import contextlib

import torch

SYNC_STATS = {"host_syncs": 0}

_strict = False     # inside strict_syncs(): the helpers lift the check


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when a CUDA device is asked for and
    none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


@contextlib.contextmanager
def strict_syncs():
    """Inside the block a wait of the card that does not go through this
    module's helpers raises (torch's sync debug mode at "error"; each
    helper lifts it around its own wait).  Needs a card."""
    global _strict
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    _strict = True
    try:
        yield
    finally:
        _strict = False
        torch.cuda.set_sync_debug_mode(prev)


def _wait(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a call that waits for the card, counted as
    one host sync."""
    SYNC_STATS["host_syncs"] += 1
    if not _strict:
        return fn(*args, **kwargs)
    torch.cuda.set_sync_debug_mode(0)
    try:
        return fn(*args, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode("error")


def host_bool(t: torch.Tensor) -> bool:
    """``bool(t)`` for a 0-dim tensor, counted as one host sync."""
    return _wait(bool, t)


def host_int(t: torch.Tensor) -> int:
    """``int(t)`` for a 0-dim tensor, counted as one host sync."""
    return _wait(int, t)


def _to_numpy(t: torch.Tensor):
    return t.detach().cpu().numpy()


def host_numpy(t: torch.Tensor):
    """``t`` as a numpy array on the host, counted as one host sync."""
    return _wait(_to_numpy, t)


def host_nonzero(t: torch.Tensor) -> torch.Tensor:
    """The flat indices of ``t``'s nonzero entries, a tensor whose size
    comes from device data: counted as one host sync."""
    return _wait(torch.nonzero, t).flatten()


def to_card(a, device, dtype=None) -> torch.Tensor:
    """Host data ``a`` (a numpy array, a Python number or list) as a
    tensor on ``device``: a blocking copy from pageable memory, which
    waits for the device's stream to drain first, counted as one host
    sync."""
    return _wait(torch.as_tensor, a, dtype=dtype, device=device)
