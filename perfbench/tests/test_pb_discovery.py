"""Driven by data: a configuration, a traffic mix, a per-layer metric and
a configuration's model modules added as files, and named in
BENCHMARK.json or the configuration, are found by name and run, with no
existing file edited."""
import json
import shutil
import time

import torch

from perfbench import harness, modules
from perfbench.tests import small


def test_new_config_mix_and_metric_are_found_by_name(tmp_path, monkeypatch):
    pb = tmp_path / "perfbench"
    shutil.copytree(harness.HERE, pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())
    cfg = small.config("granite-moe-1b-a400m.unscaled")
    cfg["name"] = "granite-moe-small.test"
    (pb / "configs" / "granite-moe-small.test.json").write_text(
        json.dumps(cfg))
    (pb / "traffic" / "burst-test.json").write_text(
        json.dumps(small.mix("chat", requests=100)))
    (pb / "metrics" / "rounds_in_window.py").write_text(
        "def read(w):\n    return float(len(w.rounds))\n")
    bench["configs"].append({"name": cfg["name"], "source": "test",
                             "file": "perfbench/configs/"
                             "granite-moe-small.test.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "granite-moe-small.burst",
                               "config": cfg["name"],
                               "traffic": "burst-test", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "rounds_in_window.open", "unit": "1",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "batcher", "moves": "tpot_p95_ms",
                               "workloads": ["granite-moe-small.burst"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("ttft_p95_s", "tpot_p95_ms"):
            m["workloads"].append("granite-moe-small.burst")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "HERE", pb)
    monkeypatch.setattr(modules, "HERE", pb)
    for trace, want in ((False, "tpot_p95_ms"),
                        (True, "rounds_in_window.open")):
        cell = harness.load_cell(tmp_path, "granite-moe-small.burst", trace)
        assert cell.config["name"] == "granite-moe-small.test"
        out = harness.run_cell(cell, 5, 1.5, trace, "cpu",
                               time.perf_counter())
        assert want in out["metrics"], out["metrics"]
        assert out["correct"]


# A model pair added as files: the decoder with its read-out's vocabulary
# rolled by the configuration's ``head_roll``, on both sides.  Were either
# side the plain decoder's, the served tokens would be judged against
# another model's and the run would not be correct.
REFERENCE = """
import torch
from perfbench.reference import decoder
from perfbench.reference.decoder import (hidden, matmul_params_per_token,
                                         paged_layers, plan)
CALLS = {"head": 0}


def head(cfg, w):
    CALLS["head"] += 1
    return torch.roll(decoder.head(cfg, w), cfg["head_roll"], dims=1)
"""

LAYOUT = """
import torch
from perfbench.layouts import decoder
from perfbench.layouts.decoder import forward, model_config, small
CALLS = {"params": 0}


def params(cfg, w):
    CALLS["params"] += 1
    p = decoder.params(cfg, w)
    p["lm_head"] = {"w": torch.roll(p["lm_head"]["w"], cfg["head_roll"],
                                    dims=1)}
    return p
"""


def test_new_model_modules_are_found_by_name(tmp_path, monkeypatch):
    pb = tmp_path / "perfbench"
    shutil.copytree(harness.HERE, pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (pb / "reference" / "decoder_rolled.py").write_text(REFERENCE)
    (pb / "layouts" / "decoder_rolled.py").write_text(LAYOUT)
    bench = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())
    cfg = small.config("qwen2.5-32b.stage16")
    cfg.update(name="qwen-rolled.test", model="decoder_rolled", head_roll=7)
    (pb / "configs" / "qwen-rolled.test.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": cfg["name"], "source": "test",
                             "file": "perfbench/configs/qwen-rolled.test.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "qwen-rolled.chat",
                               "config": cfg["name"], "traffic": "chat",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("ttft_p95_s", "tpot_p95_ms"):
            m["workloads"].append("qwen-rolled.chat")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "HERE", pb)
    monkeypatch.setattr(modules, "HERE", pb)
    cell = harness.load_cell(tmp_path, "qwen-rolled.chat", False)
    cell.mix = small.mix("chat", requests=100)
    ref, lay = modules.reference(cell.config), modules.layout(cell.config)
    assert ref.__file__ == str(pb / "reference" / "decoder_rolled.py")
    w = {"lm_head": torch.eye(4)}
    assert not torch.equal(ref.head(cell.config, w), w["lm_head"])
    out = harness.run_cell(cell, 2**31 + 11, 1.5, False, "cpu",
                           time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["checks"]["tokens_compared"]["value"] > 0
    assert ref.CALLS["head"] > 1 and lay.CALLS["params"] == 1
    assert "tpot_p95_ms" in out["metrics"]
