"""Small cells for the CPU tests: the benchmark's configurations and
mixes with every size cut down, the keys and the code paths the same."""
from __future__ import annotations

import json
import pathlib

import torch

from perfbench import harness

HERE = pathlib.Path(__file__).resolve().parents[1]


def config(name: str) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    if cfg["model_type"] == "qwen2":
        sizes = dict(hidden_size=80, intermediate_size=96, vocab_size=256,
                     num_hidden_layers=2, num_attention_heads=10,
                     num_key_value_heads=2, rope_theta=10000.0)
        port = dict(d_model=80, d_ff=96, vocab_size=256, num_layers=2,
                    num_heads=10, num_kv_heads=2, head_dim=8,
                    pad_heads_to=12, rope_theta=10000.0)
    else:
        sizes = dict(hidden_size=64, intermediate_size=32, vocab_size=256,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, num_local_experts=4,
                     num_experts_per_tok=2, attention_multiplier=0.125)
        port = dict(d_model=64, d_ff=32, vocab_size=256, num_layers=2,
                    num_heads=4, num_kv_heads=2, head_dim=16,
                    num_experts=4, experts_per_token=2,
                    moe_capacity_factor=2.0)
        sizes["attention_multiplier"] = 16 ** -0.5
    cfg.update(sizes)
    cfg["port"].update(port)
    cfg["serving"] = {"page_size": 4, "megastep_k": 4}
    cfg["check"] = dict(cfg["check"], requests=64, min_tokens_compared=8)
    return cfg


def mix(name: str, **over) -> dict:
    m = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    if m["loop"] == "open":
        m.update(lanes=4, max_len=64, requests=200, warmup_s=0.5,
                 arrivals={"process": "poisson", "rate_per_s": 6.0})
        m["prompt"] = dict(m["prompt"], median=8, min=2, max=24)
        m["output"] = dict(m["output"], median=8, min=2, max=24)
    else:
        m.update(lanes=4, max_len=64, requests=1000, warmup_rounds=1)
        m["prompt"] = dict(m["prompt"], min=2, max=8)
        m["output"] = dict(m["output"], median=24, min=8, max=40)
    m.update(over)
    return m


def cell(workload: str, trace: bool = False, **mix_over) -> harness.Cell:
    """The benchmark's cell ``workload`` at the small sizes.  One host
    thread, as ``run.py`` sets: test workers side by side would otherwise
    each start a thread a core and slow every round many times over."""
    torch.set_num_threads(1)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    w = {x["name"]: x for x in bench["workloads"]}[workload]
    return harness.Cell(name=workload, config=config(w["config"]),
                        mix=mix(w["traffic"], **mix_over),
                        metrics=harness.cell_metrics(bench, workload, trace),
                        chips=w["chips"])
