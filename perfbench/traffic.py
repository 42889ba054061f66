"""The one traffic generator: a mix file's parameters (``traffic/<mix>
.json``) and the run's seed give the requests.

``BASE_SEED`` fixes the sequence of request sizes and arrival gaps; the
run's ``--seed`` only reorders them inside consecutive blocks of
``SHUFFLE_BLOCK`` requests and draws the prompt tokens.  So every seed
asks for the same work in another order: each block spans the same
stretch of the arrival clock and holds the same sizes, so a window holds
nearly the same requests whatever the seed, and runs on different seeds
spread no wider than runs on one seed would.

Mix keys: ``loop`` (``open``: arrivals on the wall clock, ``closed``: a
lane's next request when its last one finishes), ``lanes``, ``max_len``,
``requests`` (how many sizes to draw), ``prompt`` and ``output`` (a
length distribution: ``{"dist": "lognormal", "median", "sigma", "min",
"max"}`` or ``{"dist": "uniform", "min", "max"}``), for open loops
``arrivals`` (``{"process": "poisson", "rate_per_s"}``) and ``warmup_s``,
for closed loops ``warmup_rounds``.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

BASE_SEED = 0
SHUFFLE_BLOCK = 64


@dataclasses.dataclass
class Draw:
    """One request as the generator draws it: its prompt, how many tokens
    it asks for, and (open loop) when it is due, in seconds from the
    arrival clock's start."""
    prompt: np.ndarray
    max_new: int
    due_s: float


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths from a length distribution."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        return rng.integers(lo, hi + 1, size=n)
    if spec["dist"] == "lognormal":
        x = np.exp(np.log(float(spec["median"]))
                   + float(spec["sigma"]) * rng.standard_normal(n))
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def gaps(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` arrival gaps in seconds."""
    if spec["process"] == "poisson":
        return rng.exponential(1.0 / float(spec["rate_per_s"]), size=n)
    raise ValueError(f"unknown arrival process {spec['process']!r}")


def generate(mix: dict, seed: int, vocab_size: int) -> List[Draw]:
    """The run's requests, in the order they are due (open loop) or sent
    (closed loop)."""
    n = int(mix["requests"])
    base = np.random.default_rng(BASE_SEED)
    lp = lengths(mix["prompt"], n, base)
    lo = lengths(mix["output"], n, base)
    if lp.max() + lo.max() > int(mix["max_len"]):
        raise ValueError("prompt plus output can exceed max_len")
    gap = (gaps(mix["arrivals"], n, base) if mix["loop"] == "open"
           else np.zeros(n))
    rng = np.random.default_rng(seed)
    order = _block_permutation(n, SHUFFLE_BLOCK, rng)
    due = np.cumsum(gap[_block_permutation(n, SHUFFLE_BLOCK, rng)])
    return [Draw(prompt=rng.integers(0, vocab_size, size=int(lp[i]),
                                     dtype=np.int64).astype(np.int32),
                 max_new=int(lo[i]), due_s=float(due[j]))
            for j, i in enumerate(order)]


def _block_permutation(n: int, block: int, rng: np.random.Generator):
    """A permutation of ``range(n)`` that moves no index out of its block
    of ``block`` consecutive ones."""
    return np.concatenate([b + rng.permutation(min(block, n - b))
                           for b in range(0, n, block)])
