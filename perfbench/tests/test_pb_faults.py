"""The whole run with the timed path broken underneath, past the harness's
look for a card: each fault a one-card serving cell can have must come
out as not correct.  (The exchange between chips does not exist on one
card.)  The unbroken run is correct."""
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests import small


def unchanged_state(srv):
    def step(params, state, tokens, *a):
        return tokens.repeat(1, srv.K), state
    srv.mega_fn = step


def half_batch(srv):
    """The second half of the lanes gets the first half's outputs: the
    step computed over half of the batch only."""
    mega = srv.mega_fn

    def step(*a):
        toks, st = mega(*a)
        h = toks.shape[0] // 2
        toks = toks.clone()
        toks[h:2 * h] = toks[:h]
        return toks, st
    srv.mega_fn = step


def altered_token(srv):
    """Lane 0's last token of every megastep altered where it is made."""
    mega = srv.mega_fn
    V = srv.cfg.vocab_size

    def step(*a):
        toks, st = mega(*a)
        toks = toks.clone()
        toks[0, -1] = (toks[0, -1] + 1) % V
        return toks, st
    srv.mega_fn = step


@pytest.mark.parametrize("workload", ["qwen2.5-32b.chat",
                                      "granite-moe-1b-a400m.decode-batch"])
@pytest.mark.parametrize("fault", [None, unchanged_state, half_batch,
                                   altered_token])
def test_fault_comes_out_not_correct(workload, fault):
    torch.manual_seed(0)
    # the open loop at a rate that keeps most lanes busy, as the cell's
    # does (~100 of 128): a fault in lanes that hold nothing shows nowhere
    over = ({"arrivals": {"process": "poisson", "rate_per_s": 30.0}}
            if workload.endswith(".chat") else {})
    c = small.cell(workload, **over)
    out = harness.run_cell(c, 2**31 + 99, 2.0, False, "cpu",
                           time.perf_counter(), hooks=fault)
    assert out["correct"] is (fault is None), out["checks"]
