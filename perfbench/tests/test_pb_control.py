"""The control of the correctness check at a size a test run holds: the
float32 reference in the program's place, computed in float8 e4m3, must
come out as not correct under each configuration's limits, on the tokens
a run served; the program's own reading passes them.  (Its readings on
the card, at the cells' sizes, are in PERF.md.)"""
import time

import numpy as np
import pytest

from perfbench import check as CK
from perfbench import harness
from perfbench.reference import decoder as RD
from perfbench.tests import small


@pytest.mark.parametrize("workload", ["qwen2.5-32b.decode-batch",
                                      "granite-moe-1b-a400m.decode-batch"])
@pytest.mark.parametrize("seed", [2**31 + 1, 77])
def test_fp8_control_fails_the_limits(workload, seed, monkeypatch):
    c = small.cell(workload)
    got = {}
    orig = CK.judge

    def spy(cfg, seed_, dev, snap, served, stops):
        got["served"] = served
        return orig(cfg, seed_, dev, snap, served, stops)
    monkeypatch.setattr(CK, "judge", spy)
    out = harness.run_cell(c, seed, 2.0, False, "cpu", time.perf_counter())
    assert out["correct"]
    reqs = [got["served"][i] for i in
            CK.sample(got["served"], c.config["check"]["requests"], seed)]
    res = RD.served_gaps(c.config, seed, "cpu", reqs, control=True)
    ctl = np.concatenate(res["control_gaps"])
    ck = c.config["check"]
    fails = [ctl.mean() > ck["mean_logit_gap_limit"]]
    if "logit_gap_limit" in ck:
        fails.append(ctl.max() > ck["logit_gap_limit"])
    assert any(fails)
    prog = np.concatenate(res["gaps"])
    assert prog.mean() <= ck["mean_logit_gap_limit"]
