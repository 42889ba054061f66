"""The port's ContinuousBatcher against the JAX package's.

Four requests, batch 2, max_len 24, K=4, block-table verification every
round, on the dense smoke config in f32 with the reference's parameters
converted, under each probe strategy (``cfg.probe_strategy``), and on the
gemma3 (window 8: the rings wrap, and the re-seated lanes' rings are
reset) and granite-moe smoke configs: the same
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
    "fused,strategy,arch",
    [(False, "linear", "qwen2.5-32b"), (True, "linear", "qwen2.5-32b"),
     (True, "robinhood", "qwen2.5-32b"), (True, "hopscotch", "qwen2.5-32b"),
     (True, "linear", "gemma3-12b"), (True, "linear", "granite-moe-1b-a400m")],
    ids=["False", "True", "robinhood", "hopscotch", "gemma3", "granite"])
def test_batcher_matches_reference(tmp_path, fused, strategy, arch):
    kw = dict(dtype="float32", fused_kernel=fused, probe_strategy=strategy)
    jc = dataclasses.replace(j_smoke(arch), **kw)
    tc = dataclasses.replace(get_smoke_config(arch), **kw)
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
    ttr = Tracer(str(tmp_path / "port.jsonl"))
    port = ContinuousBatcher(tc, tp, scheduler=Scheduler(**sched),
                             tracer=ttr, device="cpu", **geo)
    port.sched.submit_many(synthetic_workload(4, **load))
    # in lockstep: the block table and the rings' positions (reset on
    # re-seated lanes) equal after every round
    rounds = 0
    while not (ref.sched.drained and port.sched.drained):
        assert rounds < 200
        ref.step_round()
        port.step_round()
        rounds += 1
        for k in ("block_table", "ring_pos"):
            if k in port.state:
                np.testing.assert_array_equal(
                    port.state[k].numpy(), np.asarray(ref.state[k]),
                    err_msg=f"{k} after round {rounds}")
    for b, tr in ((ref, jtr), (port, ttr)):
        b.emit_summary()
        tr.close()

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


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "gemma3-12b",
                                  "qwen2-vl-7b"])
def test_cli_serves_the_families(monkeypatch, capsys, arch):
    """``python -m repro_torch.launch.serve --arch A --smoke --device cpu
    --fused-kernel`` drains its workload with 0 aborts for the moe,
    gemma3 and vlm configs."""
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--smoke", "--device", "cpu",
        "--batch", "2", "--max-len", "24", "--page-size", "4",
        "--megastep", "4", "--requests", "3", "--rounds", "20",
        "--verify-block-table", "--fused-kernel", "--fail-on-abort"])
    assert serve.main() == 0
    out = capsys.readouterr().out
    assert "'fused_kernel': 'ok'" in out
    assert "completed=3" in out and "aborts=0" in out


def test_cli_refuses_a_depth_off_the_superblocks(monkeypatch, capsys):
    """gemma3 decodes whole 5:1 superblocks: ``--layers 8`` is refused (the
    reference asserts it; its decode would drop the leftover layers)."""
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "gemma3-12b", "--smoke", "--device", "cpu",
        "--layers", "8"])
    with pytest.raises(SystemExit) as e:
        serve.main()
    assert e.value.code == 2
    assert "not a multiple" in capsys.readouterr().err
