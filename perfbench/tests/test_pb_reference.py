"""The plain reference against the port at the small sizes on the CPU:
each configuration's reference logits against the port's full-sequence
forward in float32, through its model modules (the padded head layout
and the MoE included), the allocator's hash against the port's, and the
allocator judge against states it must refuse."""
import json
import time

import numpy as np
import pytest
import torch

from perfbench import harness, modules, port
from perfbench.reference import allocator as RA
from perfbench.reference import weights as RW
from perfbench.tests import small

CONFIGS = [c["name"] for c in json.loads(
    (harness.HERE.parent / "BENCHMARK.json").read_text())["configs"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logits_match_the_port_forward(name):
    """Every configuration of BENCHMARK.json, through its model modules:
    the reference's logits against the port's forward in float32."""
    cfg = small.config(name)
    ref, lay = modules.reference(cfg), modules.layout(cfg)
    w = RW.draw(cfg, 2**31 + 5, "cpu")
    seq = np.random.default_rng(1).integers(0, cfg["vocab_size"], 37)
    got = lay.forward(cfg, port.params(cfg, w), torch.as_tensor(seq))
    want = ref.hidden(cfg, w, [seq]) @ ref.head(cfg, w).float() \
        / cfg.get("logits_scaling", 1.0)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


def test_padded_heads_serve_the_published_function():
    cfg = small.config("qwen2.5-32b.stage16")
    w = RW.draw(cfg, 3, "cpu")
    wq = port.params(cfg, w)["layers"]["attn"]["wq"]      # [L, d, 12, 8]
    assert wq.shape[2] == 12
    assert torch.count_nonzero(wq[:, :, 5::6]) == 0        # one per group
    assert torch.equal(wq[:, :, :5], w["wq"].reshape(2, 80, 10, 8)[:, :, :5])


@pytest.mark.parametrize("m", [64, 1000, 4096, 10240])
def test_allocator_hash_matches_the_port(m):
    from repro_torch.core import batched as BT
    keys = np.random.default_rng(m).integers(0, 2**27, 500)
    for seed in (0, 1, 12345):
        t = BT.create(m, seed=seed, device="cpu")
        want = BT._hash(t, torch.as_tensor(keys)).numpy()
        assert np.array_equal(RA.bucket(keys, m, seed), want)


@pytest.fixture(scope="module")
def served_state():
    c = small.cell("qwen2.5-32b.decode-batch")
    got = {}

    def spy(cfg, seed, dev, snap, served, stops):
        got["snap"] = snap
        return {"correct": True, "numbers": {}, "failed_requests": 0}
    from perfbench import check as CK
    orig = CK.judge
    CK.judge = spy
    try:
        harness.run_cell(c, 21, 2.0, False, "cpu", time.perf_counter())
    finally:
        CK.judge = orig
    return got["snap"]


def test_allocator_judge_passes_the_served_state(served_state):
    assert RA.judge(**served_state) == {"lane_pos": 0, "page_table": 0,
                                        "block_table": 0}
    assert served_state["held"].any()


@pytest.mark.parametrize("fault", ["cell", "block", "pos", "tomb", "lost"])
def test_allocator_judge_refuses_broken_states(served_state, fault):
    s = {k: (v.copy() if isinstance(v, np.ndarray) else v)
         for k, v in served_state.items()}
    lane = int(np.nonzero(s["held"] & (s["pos"] > 0))[0][0])
    live = np.nonzero(((s["cells"] & 3) == RA.TAG_FINAL)
                      & ((s["cells"] >> 2) != RA.RESERVED))[0]
    if fault == "cell":            # a page's key moved to a free cell
        free = np.nonzero((s["cells"] == RA.EMPTY)
                          | (s["cells"] == RA.TOMBSTONE))[0][0]
        s["cells"][free], s["cells"][live[0]] = s["cells"][live[0]], \
            s["cells"][free]
        key = "block_table"
    elif fault == "block":
        s["block_table"][lane, 0] += 1
        key = "block_table"
    elif fault == "pos":
        s["expected_pos"][lane] += 1
        key = "lane_pos"
    elif fault == "tomb":
        s["num_tombs"] += 1
        key = "page_table"
    else:                          # a live page dropped
        s["cells"][live[0]] = RA.TOMBSTONE
        key = "page_table"
    assert RA.judge(**s)[key] > 0
