"""Sharding-rules context (PyTorch port of ``dist/ctx.py``): a
dynamically scoped rule set consulted by modules that pick a collective
strategy from the active rules (``models/moe.py``, ``dist/tp.py``), and a
second stack of the mesh axes that are *manual* in the innermost region.

The reference keeps the second stack for ``shard_map`` regions, inside
which a sharding constraint must not name a manual axis.  The port runs
one process per rank and every region is manual over every axis, so the
stack only answers the gates that ask whether an axis is already owned
(``dist/tp.decode_manual_unsupported``).
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

_RULES_STACK: list = []
_MANUAL_STACK: list = []


def current_rules():
    """The innermost active rule set (None when none, or entered with
    None)."""
    return _RULES_STACK[-1] if _RULES_STACK else None


@contextlib.contextmanager
def use_rules(rules) -> Iterator:
    """Make ``rules`` the active rule set for the block.  ``use_rules(None)``
    clears it (the single-device paths key off ``current_rules() is
    None``); the previous set is restored on exit, also on an exception."""
    _RULES_STACK.append(rules)
    try:
        yield rules
    finally:
        _RULES_STACK.pop()


def current_manual_axes() -> frozenset:
    """Union of the mesh axes bound manually by the enclosing regions."""
    out: frozenset = frozenset()
    for axes in _MANUAL_STACK:
        out = out | axes
    return out


@contextlib.contextmanager
def manual_axes(names) -> Iterator:
    """Record that ``names`` are manual inside the block."""
    _MANUAL_STACK.append(frozenset(names))
    try:
        yield
    finally:
        _MANUAL_STACK.pop()


def shard_act(x: torch.Tensor, axes: tuple, full_shape=None) -> torch.Tensor:
    """The identity, after a shape check.

    In the reference this is ``with_sharding_constraint``: it tells GSPMD
    how a global activation is laid out.  A rank of the port holds only
    its own piece, already cut, so there is nothing to lay out; what can
    still go wrong is a piece of the wrong size.  So under active rules,
    given the global ``full_shape``, the tensor must have the local shape
    that the rules' spec (manual axes excluded) cuts from it, and this
    raises otherwise.  Without rules or ``full_shape`` there is nothing to
    check."""
    rules = current_rules()
    if rules is None or full_shape is None:
        return x
    spec = rules.spec(axes, tuple(full_shape), exclude=current_manual_axes())
    want = rules.local_shape(spec, tuple(full_shape))
    if tuple(x.shape) != want:
        raise ValueError(f"shard_act: local shape {tuple(x.shape)} is not "
                         f"the shard {want} that spec {spec} cuts from "
                         f"{tuple(full_shape)}")
    return x
