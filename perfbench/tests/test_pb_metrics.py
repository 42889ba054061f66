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


def traced(spans, sampled=2, plain=1):
    """A traced window: ``sampled`` rounds in samples, ``plain`` outside,
    K = 8, and the program's span table ``spans``."""
    w = window([], [dict(sampled=True)] * sampled
               + [dict(sampled=False)] * plain)
    w.spans = spans
    return w


def test_span_table_self_total_and_outermost_layer_time():
    from perfbench import devtrace
    ms = 1_000_000
    # batcher.round > allocator.rebuild > allocator.alloc_step (nested),
    # then a root allocator.free, and model.moe > model.moe.router
    items = [("batcher.round", 0, 100 * ms, -1, 9),
             ("allocator.rebuild", 10 * ms, 40 * ms, 0, 5),
             ("allocator.alloc_step", 15 * ms, 25 * ms, 1, 2),
             ("model.moe", 50 * ms, 90 * ms, 0, 1),
             ("model.moe.router", 55 * ms, 60 * ms, 3, 1),
             ("allocator.free", 120 * ms, 126 * ms, -1, 0)]
    t = devtrace.span_table(items, idle={"model.moe": 0.004})
    assert t["allocator.alloc_step"]["outer_s"] == 0.0
    assert t["allocator.alloc_step"]["total_s"] == pytest.approx(0.010)
    assert t["allocator.rebuild"]["outer_s"] == pytest.approx(0.030)
    assert t["allocator.rebuild"]["self_s"] == pytest.approx(0.020)
    assert t["allocator.rebuild"]["syncs"] == 3
    assert t["batcher.round"]["self_s"] == pytest.approx(0.030)
    assert t["batcher.round"]["syncs"] == 3
    assert t["model.moe"]["total_s"] == pytest.approx(0.040)
    assert t["model.moe.router"]["outer_s"] == 0.0
    assert t["model.moe"]["idle_s"] == 0.004
    assert t["allocator.free"]["idle_s"] == 0.0
    both = devtrace.merge_tables([t, t])
    assert both["allocator.rebuild"]["count"] == 2
    assert both["allocator.rebuild"]["outer_s"] == pytest.approx(0.060)
    # only the outermost allocator spans count: 30 ms + 6 ms over the
    # 2 sampled rounds' 16 token steps
    read = harness.reader("allocator_ms_per_step.closed")
    assert read(traced(t)) == pytest.approx(36.0 / 16)
    assert harness.reader("moe_ms_per_step.closed")(traced(t)) == \
        pytest.approx(40.0 / 16)


def test_span_readers_are_silent_without_their_spans():
    from perfbench import devtrace
    dense = devtrace.span_table([("batcher.round", 0, 5_000_000, -1, 0),
                                 ("allocator.alloc_step", 0, 1_000_000, 0,
                                  1)])
    for m in ("allocator_ms_per_step.open", "moe_ms_per_step.closed"):
        assert harness.reader(m)(traced(None)) is None    # a timed run
        assert harness.reader(m)(traced({})) is None
    assert harness.reader("moe_ms_per_step.closed")(traced(dense)) is None
    assert harness.reader("allocator_ms_per_step.open")(traced(dense)) == \
        pytest.approx(1.0 / 16)
    # spans but no sampled round to divide by
    assert harness.reader("allocator_ms_per_step.open")(
        traced(dense, sampled=0)) is None


def test_device_idle_goes_to_the_innermost_program_span():
    from perfbench import devtrace
    ms = 1_000_000
    prog = [("batcher.round", 0, 100 * ms, -1, 0),
            ("model.rope", 20 * ms, 30 * ms, 0, 2)]
    events = [("gemm", 0, 20 * ms), ("gemm", 30 * ms, 90 * ms)]
    out = devtrace.summarize(events, 0, 100 * ms, devtrace.Spans(),
                             top=None, program=prog)
    # holes: 20-30 ms inside model.rope, 90-100 ms inside batcher.round
    assert out["program_idle"] == pytest.approx({"model.rope": 0.010,
                                                 "batcher.round": 0.010})
    assert dict(out["idle_gaps"]) == pytest.approx({"harness": 0.020})


def test_traced_run_reads_the_program_spans_in_its_samples_only(
        monkeypatch):
    import time
    from perfbench import devtrace
    from repro_torch.obs import trace
    full = {}
    costliest = devtrace.costliest

    def spy(spans, n=15):
        full.update(spans)
        return costliest(spans, n)
    monkeypatch.setattr(devtrace, "costliest", spy)
    out = harness.run_cell(
        small.cell("granite-moe-1b-a400m.decode-batch", trace=True),
        2**31 + 9, 2.0, True, "cpu", time.perf_counter())
    assert trace._spans is None                 # the recorder is off again
    assert out["correct"], out["checks"]
    assert 0 < len(out["spans"]) <= 15 < len(full)
    assert all(full[n] == e for n, e in out["spans"].items())
    # every span lies in a sampled round: one batcher.round each, and
    # one MoE block a layer a token step
    rounds = out["sampling"]["rounds_sampled"]
    assert full["batcher.round"]["count"] == rounds
    assert full["model.moe"]["count"] == rounds * 4 * 2
    assert "allocator.alloc_step" in full
    for m in ("allocator_ms_per_step.closed", "moe_ms_per_step.closed"):
        assert out["metrics"][m]["value"] > 0
