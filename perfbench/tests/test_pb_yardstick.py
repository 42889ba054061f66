"""The FLOP and byte formulas against hand counts, and the traffic
generator repeated by seed."""
import numpy as np
import pytest

from perfbench import traffic, yardstick as Y
from perfbench.tests import small


def test_matmul_params_dense_by_hand():
    cfg = small.config("qwen2.5-32b.stage16")   # d 80, 10/2 heads of 8
    d, hd, ff, V, L = 80, 8, 96, 256, 2
    per_layer = d * hd * (2 * 10 + 2 * 2) + 3 * d * ff
    assert Y.matmul_params_per_token(cfg) == L * per_layer + d * V


def test_matmul_params_moe_counts_router_and_top_k():
    cfg = small.config("granite-moe-1b-a400m.unscaled")  # d 64, E 4, k 2
    d, hd, ff, V, L = 64, 16, 32, 256, 2
    per_layer = d * hd * (2 * 4 + 2 * 2) + d * 4 + 2 * 3 * d * ff
    assert Y.matmul_params_per_token(cfg) == L * per_layer + d * V


def test_published_qwen_counts():
    import json, pathlib
    cfg = json.loads((pathlib.Path(Y.__file__).parent / "configs"
                      / "qwen2.5-32b.stage16.json").read_text())
    # 40 query heads, not the 48 slots the port pads to
    attn = 5120 * 128 * (2 * 40 + 2 * 8)
    assert Y.matmul_params_per_token(cfg) == \
        16 * (attn + 3 * 5120 * 27648) + 5120 * 152064


def test_lane_steps_and_flops():
    steps, att = Y.lane_steps([0, 5, 9], [3, 5, 10])
    assert (steps, att) == (3 + 0 + 1, (1 + 2 + 3) + 10)
    cfg = small.config("qwen2.5-32b.stage16")
    f = Y.window_flops(cfg, steps, att)
    assert f == 2.0 * Y.matmul_params_per_token(cfg) * 4 + 4 * 10 * 8 * 2 * 16


def test_k1_bytes_by_hand():
    cfg = small.config("qwen2.5-32b.stage16")   # nq 10, nkv 2, hd 8, L 2
    got = Y.k1_bytes(cfg, steps=3, attended=50, max_pages=16)
    per_token = 2 * 2 * 8 * 2
    per_step = 10 * 8 * 2 + 4 * (10 * 8 + 2 * 10) + 4 * 16 + 4
    assert got == 2 * (per_token * 50 + per_step * 3)


def test_traffic_repeats_by_seed_and_keeps_its_sizes_across_seeds():
    mix = small.mix("chat", requests=300)
    a = traffic.generate(mix, 2**31 + 3, 256)
    b = traffic.generate(mix, 2**31 + 3, 256)
    c = traffic.generate(mix, 17, 256)
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
               and x.due_s == y.due_s for x, y in zip(a, b))
    key = lambda r: sorted((len(x.prompt), x.max_new) for x in r)
    assert key(a) == key(c)
    assert [x.due_s for x in a] != [x.due_s for x in c]
    assert sorted(np.diff([0.0] + [x.due_s for x in a])) == pytest.approx(
        sorted(np.diff([0.0] + [x.due_s for x in c])))
    # every block of SHUFFLE_BLOCK requests: the same sizes, the same span
    # of the arrival clock, whatever the seed
    B = traffic.SHUFFLE_BLOCK
    for b in range(0, 300, B):
        assert key(a[b:b + B]) == key(c[b:b + B])
        assert a[min(b + B, 300) - 1].due_s == pytest.approx(
            c[min(b + B, 300) - 1].due_s)


def test_lengths_stay_inside_their_clip():
    rng = np.random.default_rng(0)
    x = traffic.lengths({"dist": "lognormal", "median": 128, "sigma": 0.7,
                         "min": 16, "max": 512}, 5000, rng)
    assert x.min() >= 16 and x.max() <= 512
    assert 100 <= np.median(x) <= 160
