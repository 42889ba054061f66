"""The serving path's layer spans (``repro_torch.obs.trace``) and the
complete host-sync count (``repro_torch.device``).

On the CPU: recording changes nothing the batcher serves; with recording
off nothing is kept; one round's spans nest batcher -> megastep -> token
step -> layer -> RoPE, with RoPE twice a paged layer a token step; the
spans' self syncs add up to the round's ``SYNC_STATS`` difference, which
for a round with no page crossing is the number the structure predicts;
the CLI's Chrome-trace export loads back; the batcher's registry exports
no kernel counters.

On the card (``gpu``; skipped without one): a served run with admissions
and evictions under ``device.strict_syncs`` (every wait of the card that
the helpers do not count raises), and a spin kernel's device interval,
read from the profiler, inside the span around it (the spans and the
profiler share a clock).  This file imports no JAX.
"""
import contextlib
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

from repro_torch import device as D
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import ContinuousBatcher
from repro_torch.models.registry import get_model
from repro_torch.obs import trace as OT
from repro_torch.serving.sched import Scheduler, synthetic_workload

torch.set_num_threads(1)

ARCHS = ["qwen2.5-32b", "granite-moe-1b-a400m"]
K, PAGE = 4, 16


def batcher(arch, device="cpu", requests=2, batch=2, max_len=48,
            page_size=PAGE, n_pages=None, tracer=None, **load):
    """A smoke-config batcher with K1 on under ``linear``, ``requests``
    synthetic requests submitted."""
    cfg = dataclasses.replace(get_smoke_config(arch), fused_kernel=True)
    gen = torch.Generator(device=device).manual_seed(0)
    params = get_model(cfg).init(cfg, gen, torch.device(device))
    srv = ContinuousBatcher(
        cfg, params, batch=batch, max_len=max_len, page_size=page_size,
        megastep_k=K, auto_refill=False, n_pages=n_pages, tracer=tracer,
        scheduler=Scheduler(slots=batch, page_size=page_size,
                            max_len=max_len, megastep_k=K),
        device=device)
    srv.sched.submit_many(synthetic_workload(
        requests, vocab_size=cfg.vocab_size, max_len=max_len, seed=3,
        **load))
    return srv


def chain(spans, i):
    """The names from span ``i`` up to its root."""
    out = []
    while i >= 0:
        out.append(spans[i].name)
        i = spans[i].parent
    return out


def test_recording_changes_nothing_served():
    """The same tokens and the same state with spans recorded or not."""
    runs = []
    for record in (False, True):
        torch.manual_seed(0)
        srv = batcher("qwen2.5-32b", requests=4)
        with (OT.record_spans() if record else
              contextlib.nullcontext()) as spans:
            for _ in range(40):
                if srv.sched.drained:
                    break
                srv.step_round()
        assert srv.sched.drained
        assert (len(spans) > 0) if record else spans is None
        runs.append(srv)
    a, b = runs
    assert ({r.req_id: r.sampled for r in a.sched.finished}
            == {r.req_id: r.sampled for r in b.sched.finished})
    for k in ("block_table", "seq_ids", "pos", "active", "aborted"):
        assert torch.equal(a.state[k], b.state[k]), k
    assert torch.equal(a.state["table"].table, b.state["table"].table)
    for x, y in zip(a.state["pools"], b.state["pools"]):
        assert torch.equal(x, y)


def test_nothing_is_kept_with_recording_off():
    """Outside ``record_spans`` a span site hands back one shared object
    and the list of an ended recording stays as it was."""
    srv = batcher("qwen2.5-32b")
    with OT.record_spans() as spans:
        pass
    srv.step_round()
    srv.step_round()
    assert spans == []
    assert OT.span("model.rope") is OT.span("batcher.round")
    with OT.record_spans() as spans:
        srv.step_round()
    n = len(spans)
    srv.step_round()
    assert n > 0 and len(spans) == n


@pytest.mark.parametrize("arch", ARCHS)
def test_round_span_tree_and_sync_count(arch):
    """A round's spans: one root ``batcher.round`` carrying the clock of
    the round's Tracer events, RoPE 2 x paged layers x K times, each under
    layer, token step, megastep and round; granite's MoE block with its
    four children.  Self syncs sum to the round's ``SYNC_STATS``
    difference; in a round with no page crossing, no admission and no
    eviction that is K x (1 allocation count + 1 write plan + 2 RoPE
    copies a layer) + 3 copies of the round's inputs + 2 reads of its
    outputs + 1 abort count + 2 headroom reads."""
    srv = batcher(arch)
    L = srv.cfg.num_layers
    srv.step_round()                 # admits both requests
    srv.step_round()                 # positions 0..3: each lane crosses
    p0 = srv.pos.copy()
    assert not any(p % PAGE == 0 for p0s in p0 for p in range(p0s, p0s + K))
    s0 = D.SYNC_STATS["host_syncs"]
    with OT.record_spans() as spans:
        plan = srv.step_round()
    syncs = D.SYNC_STATS["host_syncs"] - s0
    assert not plan.admissions and not plan.evict_slots

    roots = [s for s in spans if s.parent < 0]
    assert [s.name for s in roots] == ["batcher.round"]
    assert roots[0].clock == srv.sched.clock
    assert roots[0].syncs == syncs
    summary = OT.summarize(spans)
    assert sum(d["syncs"] for d in summary.values()) == syncs
    assert syncs == K * (2 + 2 * L) + 8
    assert summary["allocator.alloc_step"]["syncs"] == K
    assert summary["model.kv_write_plan"]["syncs"] == K
    assert summary["model.rope"]["syncs"] == 2 * L * K
    assert summary["allocator.headroom"]["syncs"] == 2

    ropes = [i for i, s in enumerate(spans) if s.name == "model.rope"]
    assert len(ropes) == 2 * L * K
    for i in ropes:
        assert chain(spans, i) == ["model.rope", "model.layer",
                                   "model.token_step", "model.megastep",
                                   "batcher.round"]
    assert summary["model.layer"]["count"] == L * K
    assert summary["kernels.k1"]["count"] == L * K
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert all(d["self_s"] >= 0 for d in summary.values())
    if arch.startswith("granite"):
        moe = [i for i, s in enumerate(spans) if s.name == "model.moe"]
        assert len(moe) == L * K
        kids = [s.name for s in spans if s.parent == moe[0]]
        assert kids == ["model.moe.router", "model.moe.dispatch",
                        "model.moe.experts", "model.moe.combine"]
    else:
        assert summary["model.mlp"]["count"] == L * K


def test_helpers_count_their_waits():
    """``to_card`` and ``host_nonzero`` count one sync each, on the CPU
    too, and a span's counts are its interval's."""
    s0 = D.SYNC_STATS["host_syncs"]
    t = D.to_card(np.array([0, 3, 0, 5]), "cpu", torch.int64)
    assert D.host_nonzero(t).tolist() == [1, 3]
    assert D.SYNC_STATS["host_syncs"] - s0 == 2
    with OT.record_spans() as spans:
        with OT.span("outer"):
            D.host_int(t.sum())
            with OT.span("inner"):
                D.host_bool(t.any())
                D.host_numpy(t)
    assert [(s.name, s.parent, s.syncs) for s in spans] == [
        ("outer", -1, 3), ("inner", 0, 2)]
    summary = OT.summarize(spans)
    assert summary["outer"]["syncs"] == 1 and summary["inner"]["syncs"] == 2


def test_cli_spans_out_and_no_kernel_source(monkeypatch, capsys, tmp_path):
    """``--spans-out`` writes Chrome-trace JSON that loads back (complete
    events, parents before children, rounds with their clock); the
    batcher's registry exports no kernel counters."""
    from repro_torch.launch import serve
    path = tmp_path / "spans.json"
    prefix = tmp_path / "metrics"
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen2.5-32b", "--smoke", "--device", "cpu",
        "--batch", "2", "--max-len", "24", "--page-size", "4",
        "--megastep", "4", "--requests", "3", "--rounds", "20",
        "--fused-kernel", "--fail-on-abort", "--spans-out", str(path),
        "--metrics-out", str(prefix)])
    assert serve.main() == 0
    assert f"[serve] spans: {path}" in capsys.readouterr().out
    events = json.loads(path.read_text())["traceEvents"]
    assert events and all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    for i, e in enumerate(events):
        p = e["args"]["parent"]
        assert p < i and (p < 0 or events[p]["ts"] <= e["ts"])
    rounds = [e for e in events if e["name"] == "batcher.round"]
    assert rounds and all(e["args"]["parent"] == -1 for e in rounds)
    clocks = [e["args"]["clock"] for e in rounds]
    assert clocks == list(range(4, 4 * len(rounds) + 1, 4))
    names = {e["name"] for e in events}
    assert {"model.megastep", "model.rope", "allocator.alloc_step",
            "allocator.free", "scheduler.plan", "kernels.k1"} <= names
    snap = json.loads((tmp_path / "metrics.json").read_text())
    assert not [k for part in snap.values() for k in part
                if k.startswith("kernel_")]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    _build.library()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_no_sync_escapes_the_count_on_the_card(arch, tmp_path, capsys):
    """Rounds with admissions, evictions and page crossings under
    ``strict_syncs``: a wait of the card outside the counting helpers
    raises.  The dense run also writes a Tracer (its table-health reads)."""
    _card()
    tracer = (OT.Tracer(str(tmp_path / "t.jsonl"))
              if arch.startswith("qwen") else None)
    srv = batcher(arch, device="cuda", requests=8, batch=4, max_len=40,
                  page_size=4, tracer=tracer)
    per_round = []
    with D.strict_syncs():
        while not srv.sched.drained:
            assert len(per_round) < 60
            s0 = D.SYNC_STATS["host_syncs"]
            srv.step_round()
            per_round.append(D.SYNC_STATS["host_syncs"] - s0)
    if tracer is not None:
        tracer.close()
    st = srv.sched.stats
    assert st.completed == 8 and st.aborts == 0
    with capsys.disabled():
        print(f"\n[{arch}] {torch.cuda.get_device_name()}: "
              f"{len(per_round)} rounds under strict_syncs, "
              f"{st.completed} admitted and evicted, counted syncs a "
              f"round {per_round}")


@pytest.mark.gpu
def test_span_clock_holds_the_kernel_interval(capsys):
    """A spin kernel's device interval, as the profiler reports it, lies
    inside the span around its launch and ``synchronize``."""
    _card()
    from torch.profiler import ProfilerActivity, profile
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with OT.record_spans() as spans:
            with OT.span("test.sleep"):
                torch.cuda._sleep(50_000_000)
                torch.cuda.synchronize()
    evs = [e for e in prof.profiler.kineto_results.events()
           if "CUDA" in str(e.device_type())]
    assert len(evs) == 1, [e.name() for e in evs]     # the spin kernel
    a = int(evs[0].start_ns())
    b = a + int(evs[0].duration_ns())
    s = spans[0]
    with capsys.disabled():
        print(f"\n{torch.cuda.get_device_name()}: {evs[0].name()}, span "
              f"{(s.end_ns - s.start_ns) / 1e6:.3f} ms, kernel "
              f"{(b - a) / 1e6:.3f} ms, starts {(a - s.start_ns) / 1e3:.1f}"
              f" us after the span, ends {(s.end_ns - b) / 1e3:.1f} us "
              "before its end")
    assert s.start_ns <= a < b <= s.end_ns
