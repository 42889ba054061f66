"""The comparison that decides ``correct``, on what the timed path
served, once the window has closed and the program's state is freed.

Numbers compared, each with its limit (``rule``):

- ``mean_logit_gap`` and ``logit_gap`` (<=): over a sample of the
  requests that got sampled tokens, drawn from the seed with the one
  with the most tokens in it, the mean and the widest gap by which a
  served token's logit lies below the best logit of the float32
  reference at that position (the model step: embedding, attention over
  the paged KV through K1, MLP or MoE, head; the configuration's model
  module, ``reference/<model>.py``, computes the reference).  Each is
  compared where the configuration's ``check`` states its limit
  (``mean_logit_gap_limit``, ``logit_gap_limit``), set from the
  program's readings and the fp8 control's (PERF.md).
- ``tokens_compared`` (>=): served tokens in that sample, at least the
  configuration's ``check.min_tokens_compared``: a run that serves
  nothing proves nothing.
- ``lane_pos``, ``page_table``, ``block_table`` (== 0): the allocator's
  state against what the lanes' records say it must hold
  (``reference/allocator.py``).
- ``served_len`` (== 0): finished requests that got another number of
  sampled tokens than they asked for (up to ``max_len``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from perfbench.reference import allocator as RA
from perfbench.reference import served as RS


def sample(served: Sequence[tuple], n: int, seed: int) -> List[int]:
    """Indices of up to ``n`` requests: the one with the most served
    tokens, and the rest drawn from the seed."""
    if not served:
        return []
    longest = int(np.argmax([len(s) for _, s in served]))
    rest = [i for i in range(len(served)) if i != longest]
    rng = np.random.default_rng(seed + 7)
    pick = rng.permutation(len(rest))[:max(0, n - 1)]
    return [longest] + sorted(rest[i] for i in pick)


def judge(cfg: dict, seed: int, device, snap: dict,
          served: Sequence[Tuple[np.ndarray, np.ndarray]],
          stops: Sequence[Tuple[int, int]]) -> dict:
    ck = cfg["check"]
    idx = sample(served, int(ck["requests"]), seed)
    reqs = [served[i] for i in idx]
    gaps = (RS.served_gaps(cfg, seed, device, reqs)["gaps"] if reqs
            else [])
    flat = np.concatenate(gaps) if gaps else np.zeros(0)
    n_tok = int(flat.size)
    alloc = RA.judge(**snap)
    bad_len = sum(1 for got, want in stops if got != want)
    numbers = {}
    for name, value in (("mean_logit_gap", float(flat.mean()) if n_tok
                         else 0.0),
                        ("logit_gap", float(flat.max(initial=0.0)))):
        if f"{name}_limit" in ck:
            numbers[name] = {"value": value, "limit": ck[f"{name}_limit"],
                             "rule": "<="}
    numbers.update({
        "tokens_compared": {"value": n_tok,
                            "limit": ck["min_tokens_compared"],
                            "rule": ">="},
        "lane_pos": {"value": alloc["lane_pos"], "limit": 0, "rule": "=="},
        "page_table": {"value": alloc["page_table"], "limit": 0,
                       "rule": "=="},
        "block_table": {"value": alloc["block_table"], "limit": 0,
                        "rule": "=="},
        "served_len": {"value": bad_len, "limit": 0, "rule": "=="},
    })
    ok = all(passes(v) for v in numbers.values())
    worst = ck.get("logit_gap_limit", np.inf)
    failed = bad_len + sum(1 for g in gaps if g.size and g.max() > worst)
    return {"correct": ok, "numbers": numbers, "failed_requests": failed}


def passes(n: dict) -> bool:
    v, lim, rule = n["value"], n["limit"], n["rule"]
    return {"<=": v <= lim, ">=": v >= lim, "==": v == lim}[rule]
