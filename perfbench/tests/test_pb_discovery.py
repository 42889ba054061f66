"""Driven by data: a configuration, a traffic mix and a per-layer metric
added as files, and named in BENCHMARK.json, are found by name and run,
with no existing file edited."""
import json
import shutil
import time

from perfbench import harness
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
    for trace, want in ((False, "tpot_p95_ms"),
                        (True, "rounds_in_window.open")):
        cell = harness.load_cell(tmp_path, "granite-moe-small.burst", trace)
        assert cell.config["name"] == "granite-moe-small.test"
        out = harness.run_cell(cell, 5, 1.5, trace, "cpu",
                               time.perf_counter())
        assert want in out["metrics"], out["metrics"]
        assert out["correct"]
