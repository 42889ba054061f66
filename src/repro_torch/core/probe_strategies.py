"""ProbeStrategy: the probe order / claim arbitration / deletion contract
(PyTorch port of ``core/probe_strategies.py``).

Only ``linear`` — the paper's algorithm, implemented inline in
``core/batched.py`` — is ported.  ``robinhood`` and ``hopscotch`` are
ROADMAP item 19: asking for them raises ``NotImplementedError``; the port
never substitutes ``linear`` for them.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core import batched as BT

_NOT_PORTED = {
    "robinhood": "ROADMAP item 19 (RobinHoodStrategy)",
    "hopscotch": "ROADMAP item 19 (HopscotchStrategy)",
}


class ProbeStrategy:
    """The contract a probe strategy satisfies:

    * ``find_batch`` is wait-free: pure vectorized reads.
    * ``insert_batch``/``delete_batch`` leave the table quiescent and equal
      to a sequential execution of some serialization of the batch.
    * ``num_keys``/``num_tombs`` stay exact; ``forecast_slack`` is the
      extra headroom the forecaster must hold for the no-ABORT proof.
    """

    name: str = ""
    uses_tombstones: bool = True
    #: the probe kernel (kernels/probe) assumes this probe order
    kernel_supported: bool = False

    def forecast_slack(self, n_pages: int) -> int:
        return 0

    def find_batch(self, ht, keys, active=None):
        raise NotImplementedError

    def insert_batch(self, ht, keys, active=None, claim_tombstones=True):
        raise NotImplementedError

    def delete_batch(self, ht, keys, active=None):
        raise NotImplementedError


class LinearStrategy(ProbeStrategy):
    name = "linear"
    uses_tombstones = True
    kernel_supported = True

    def find_batch(self, ht, keys, active=None):
        return BT.find_batch(ht, keys, active)

    def insert_batch(self, ht, keys, active=None, claim_tombstones=True):
        return BT.insert_batch(ht, keys, active, claim_tombstones)

    def delete_batch(self, ht, keys, active=None):
        return BT.delete_batch(ht, keys, active)


STRATEGIES: Dict[str, ProbeStrategy] = {"linear": LinearStrategy()}


def get_strategy(name: str) -> ProbeStrategy:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"probe strategy {name!r} is not ported to PyTorch yet: "
            f"{_NOT_PORTED[name]}")
    try:
        return STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown probe strategy {name!r}; expected one of "
            f"{sorted(set(STRATEGIES) | set(_NOT_PORTED))}") from None
