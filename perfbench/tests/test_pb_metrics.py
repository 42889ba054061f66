"""The metric arithmetic: percentiles, the censoring rule of ttft_p95_s,
tails over all requests, rates over the whole window."""
import statistics
import types

import numpy as np
import pytest

from perfbench import harness, stats
from perfbench import yardstick as Y
from perfbench.tests import small


def window(recs, rounds=(), ws=10.0, seconds=20.0, we=31.0):
    return types.SimpleNamespace(recs=list(recs), rounds=list(rounds), ws=ws,
                                 we=we, seconds=seconds, K=8, trace=None)


def rec(due, first=None, admit=None):
    return harness.Rec(req=None, due=due, first_t=first, admit_t=admit)


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([], 95) is None


def test_spread_is_quartile_distance_over_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def test_ttft_censors_at_window_end_and_counts_only_due_requests():
    read = harness.reader("ttft_p95_s")
    recs = [rec(12.0 + i * 0.1, first=12.5 + i * 0.1) for i in range(18)]
    recs += [rec(29.0), rec(29.5)]          # never served: 2 s and 1.5 s
    recs.append(rec(5.0, first=40.0))       # due before the window
    recs.append(rec(30.5, first=30.6))      # due after it
    assert read(window(recs)) == pytest.approx(1.5)
    recs[-4] = rec(29.0, first=29.1)
    recs[-3] = rec(29.5, first=29.6)
    assert read(window(recs)) == pytest.approx(0.5)


def test_tails_cover_all_requests_not_chunks():
    read = harness.reader("ttft_p95_s")
    due = np.linspace(11.0, 29.0, 200)
    lat = np.arange(200) / 100.0            # 0 .. 1.99 s
    recs = [rec(d, first=d + l) for d, l in zip(due, lat)]
    assert read(window(recs)) == pytest.approx(lat[189])


def test_queue_wait_median_with_censoring():
    read = harness.reader("queue_wait_p50_s")
    recs = [rec(20.0, admit=20.5), rec(21.0, admit=23.0), rec(25.0)]
    assert read(window(recs)) == pytest.approx(2.0)


def test_output_rate_over_the_whole_window():
    read = harness.reader("output_tokens_per_s")
    rounds = [dict(t0=10.0 + i, t1=11.0 + i, delivered=100) for i in range(5)]
    w = window([], rounds, ws=10.0, we=15.5)
    assert read(w) == pytest.approx(500 / 5.5)


def test_tpot_counts_tokens_after_the_first_delivery():
    read = harness.reader("tpot_p95_ms")
    a, b = object(), object()
    rounds = [dict(t1=1.0, got=[(a, 8), (b, 3)]), dict(t1=1.4, got=[(a, 8)]),
              dict(t1=1.8, got=[(a, 8)])]
    # a: 16 tokens after its first delivery in 0.8 s; b: one delivery only
    assert read(window([], rounds)) == pytest.approx(50.0)


def test_step_metrics_divide_by_token_steps():
    w = window([], [dict(t0=0.0, t1=0.5, mega_s=0.4, syncs=24,
                         keys_probed=80)] * 2)
    assert harness.reader("batcher_ms_per_step.open")(w) == \
        pytest.approx(2 * 100 / 16)
    assert harness.reader("megastep_ms_per_step.open")(w) == \
        pytest.approx(800 / 16)
    assert harness.reader("host_syncs_per_step.closed")(w) == 3.0
    assert harness.reader("keys_probed_per_step.closed")(w) == 10.0


def test_host_times_skip_the_sampled_rounds():
    plain = dict(t0=0.0, t1=0.5, mega_s=0.4, syncs=24, keys_probed=80,
                 p0=[0, 10], p1=[8, 18], sampled=False)
    traced = dict(plain, t1=2.0, mega_s=1.5, sampled=True)
    w = window([], [plain, traced, plain])
    assert harness.reader("batcher_ms_per_step.open")(w) == \
        pytest.approx(2 * 100 / 16)
    assert harness.reader("megastep_ms_per_step.open")(w) == \
        pytest.approx(800 / 16)
    # the counts take every round: a sample changes no count
    assert harness.reader("host_syncs_per_step.closed")(w) == 3.0
    cfg = small.config("qwen2.5-32b.stage16")
    w.cfg = cfg
    steps, att = Y.lane_steps(plain["p0"], plain["p1"])
    want = Y.window_flops(cfg, 2 * steps, 2 * att) / (1.0 *
                                                      Y.H100_BF16_FLOPS)
    assert harness.reader("mfu.open")(w) == pytest.approx(want * 100.0)


def test_device_readers_are_silent_without_a_trace():
    w = window([], [dict(t0=0.0, t1=1.0, mega_s=0.5, p0=[0], p1=[8])])
    for m in ("k1_roofline.open", "device_idle_share.open"):
        assert harness.reader(m)(w) is None


def test_k1_roofline_counts_the_sampled_rounds_only():
    cfg = small.config("qwen2.5-32b.stage16")
    r = dict(t0=0.0, t1=1.0, mega_s=0.5, p0=[0, 4], p1=[8, 12])
    w = window([], [dict(r, sampled=True), dict(r, sampled=False)])
    w.cfg, w.max_pages = cfg, 16
    w.trace, w.window_s = {"k1_s": 1e-3, "busy_s": 0.25}, 1.0
    steps, att = Y.lane_steps(r["p0"], r["p1"])
    want = Y.k1_bytes(cfg, steps, att, 16) / Y.H100_HBM_BYTES_PER_S / 1e-3
    assert harness.reader("k1_roofline.open")(w) == \
        pytest.approx(want * 100.0)
    assert harness.reader("device_idle_share.open")(w) == \
        pytest.approx(75.0)


def test_traced_run_samples_a_few_rounds_and_takes_its_spans_off():
    import time
    from repro_torch.models import layers as L
    from repro_torch.serving import engine as EG
    from perfbench import devtrace
    before = (EG.fused_decode_kernel, EG.nn.rmsnorm, L.mlp_apply)
    out = harness.run_cell(small.cell("qwen2.5-32b.chat", trace=True),
                           2**31 + 5, 2.0, True, "cpu", time.perf_counter())
    s = out["sampling"]
    assert 0 < s["rounds_sampled"] <= devtrace.SAMPLES * \
        devtrace.SAMPLE_ROUNDS
    assert s["rounds_sampled"] < s["rounds"]
    assert s["ms_per_step_sampled"] > 0 and s["ms_per_step_unsampled_after"] > 0
    assert (EG.fused_decode_kernel, EG.nn.rmsnorm, L.mlp_apply) == before
    assert out["correct"], out["checks"]
    assert "megastep_ms_per_step.open" in out["metrics"]
