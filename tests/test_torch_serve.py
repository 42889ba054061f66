"""The port's ContinuousBatcher against the JAX package's.

Four requests, batch 2, max_len 24, K=4, block-table verification every
round, on the dense smoke config in f32 with the reference's parameters
converted, under each probe strategy (``cfg.probe_strategy``): the same
completions, the same sampled tokens, table and meta, and 0 aborts, and
the port's JSONL trace passes ``tools/trace_report.py --check-invariants``
and equals the reference's trace event for event (but for
``keys_probed``: the port counts every probe, the JAX package only those
made outside its jitted megastep).
"""
import dataclasses
import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch.serve import ContinuousBatcher as JBatcher
from repro.models import lm as j_lm
from repro.obs import Tracer as JTracer
from repro.serving.sched import Scheduler as JScheduler
from repro.serving.sched import synthetic_workload as j_workload
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import ContinuousBatcher
from repro_torch.models import convert
from repro_torch.obs import Tracer
from repro_torch.serving.sched import Scheduler, synthetic_workload

# small tensors: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)


def _trace_tool():
    path = os.path.join(HERE, os.pardir, "tools", "trace_report.py")
    spec = importlib.util.spec_from_file_location("trace_report", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _drop_probes(evs):
    return [{k: v for k, v in e.items() if k != "keys_probed"} for e in evs]


@pytest.mark.parametrize(
    "fused,strategy",
    [(False, "linear"), (True, "linear"), (True, "robinhood"),
     (True, "hopscotch")],
    ids=["False", "True", "robinhood", "hopscotch"])
def test_batcher_matches_reference(tmp_path, fused, strategy):
    kw = dict(dtype="float32", fused_kernel=fused, probe_strategy=strategy)
    jc = dataclasses.replace(j_smoke("qwen2.5-32b"), **kw)
    tc = dataclasses.replace(get_smoke_config("qwen2.5-32b"), **kw)
    jp, _ = j_lm.init(jc, jax.random.PRNGKey(0))
    tp = convert.from_numpy_tree(jax.tree.map(np.asarray, jp), tc, "cpu")
    geo = dict(batch=2, max_len=24, page_size=4, megastep_k=4,
               verify_block_table=True, auto_refill=False, n_pages=10)
    sched = dict(slots=2, page_size=4, max_len=24, megastep_k=4)
    load = dict(vocab_size=jc.vocab_size, max_len=24, seed=3,
                slo_fraction=0.5)

    jtr = JTracer(str(tmp_path / "ref.jsonl"))
    ref = JBatcher(jc, jp, scheduler=JScheduler(**sched), tracer=jtr, **geo)
    ref.sched.submit_many(j_workload(4, **load))
    assert ref.run_until_drained(200)
    ref.emit_summary()
    jtr.close()

    ttr = Tracer(str(tmp_path / "port.jsonl"))
    port = ContinuousBatcher(tc, tp, scheduler=Scheduler(**sched),
                             tracer=ttr, device="cpu", **geo)
    port.sched.submit_many(synthetic_workload(4, **load))
    assert port.run_until_drained(200)
    port.emit_summary()
    ttr.close()

    assert port.strategy == strategy
    np.testing.assert_array_equal(
        np.asarray(ref.state["table"].table),
        port.state["table"].table.numpy().astype(np.int64).astype(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(ref.state["table"].meta),
        port.state["table"].meta.numpy().astype(np.int64).astype(np.uint32))
    assert port.sched.stats.completed == ref.sched.stats.completed == 4
    assert port.sched.stats.aborts == ref.sched.stats.aborts == 0
    want = {r.req_id: r.sampled for r in ref.sched.finished}
    got = {r.req_id: r.sampled for r in port.sched.finished}
    assert got == want
    tool = _trace_tool()
    path = str(tmp_path / "port.jsonl")
    evs = tool.load(path)
    assert tool.check_invariants(path, evs) == []
    assert _drop_probes(evs) == _drop_probes(
        tool.load(str(tmp_path / "ref.jsonl")))


@pytest.mark.parametrize("strategy", ["robinhood", "hopscotch"])
def test_cli_probe_strategy(monkeypatch, capsys, strategy):
    """``python -m repro_torch.launch.serve --probe-strategy S --smoke
    --device cpu`` drains its workload with 0 aborts under each strategy
    and reports the strategy it ran."""
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen2.5-32b", "--smoke", "--device", "cpu",
        "--batch", "2", "--max-len", "24", "--page-size", "4",
        "--megastep", "4", "--requests", "3", "--rounds", "20",
        "--verify-block-table", "--fused-kernel", "--fail-on-abort",
        "--probe-strategy", strategy])
    assert serve.main() == 0
    out = capsys.readouterr().out
    assert f"'probe_strategy': '{strategy}: " in out
    assert "completed=3" in out and "aborts=0" in out
