"""Small cells for the CPU tests: the benchmark's configurations and
mixes with every size cut down, the keys and the code paths the same (a
configuration's cut is its model's, ``layouts/<model>.py``'s ``small``)."""
from __future__ import annotations

import json
import pathlib

import torch

from perfbench import harness, modules

HERE = pathlib.Path(__file__).resolve().parents[1]


def config(name: str) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg = modules.layout(cfg).small(cfg)
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
