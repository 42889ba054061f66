"""The system under test, set up from a configuration file: the port's
``ModelConfig`` and its parameter tree laid out from the benchmark's
draws (by the configuration's ``layouts/<model>.py``), the
``ContinuousBatcher`` that serves a cell, and the program's counters and
spans.  With the layouts, the only modules of the harness that import
``repro_torch``; they import it when a run sets up, never when they are
themselves imported."""
from __future__ import annotations

from typing import Dict

import torch

from perfbench import modules


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration (its model's
    ``layouts/<model>.py``)."""
    return modules.layout(cfg).model_config(cfg)


def params(cfg: dict, w: Dict[str, torch.Tensor]) -> dict:
    """The port's parameter tree from the benchmark's draws (its model's
    ``layouts/<model>.py``)."""
    return modules.layout(cfg).params(cfg, w)


def batcher(cfg: dict, mix: dict, prm: dict, device):
    """The port's ``ContinuousBatcher`` for a cell: the mix's lanes and
    ``max_len``, the configuration's page size and megastep, the pool at
    the engine's default plan (1.25 x the worst case), FCFS with proactive
    admission control, no auto refill (the harness submits)."""
    from repro_torch.launch.serve import ContinuousBatcher
    from repro_torch.serving.sched import Scheduler
    sv = cfg["serving"]
    sched = Scheduler(slots=mix["lanes"], page_size=sv["page_size"],
                      max_len=mix["max_len"], megastep_k=sv["megastep_k"])
    return ContinuousBatcher(
        model_config(cfg), prm, batch=mix["lanes"], max_len=mix["max_len"],
        page_size=sv["page_size"], megastep_k=sv["megastep_k"],
        scheduler=sched, auto_refill=False, device=device)


def request(req_id: int, draw):
    from repro_torch.serving.sched import Request
    return Request(req_id=req_id, prompt=draw.prompt,
                   max_new_tokens=draw.max_new)


def counters() -> dict:
    """The program's host-sync count (``repro_torch.device.SYNC_STATS``)."""
    from repro_torch.device import SYNC_STATS
    return {"host_syncs": SYNC_STATS["host_syncs"]}


def record_spans():
    """The program's span recorder (``repro_torch.obs.trace
    .record_spans``): a context that yields the list every span inside it
    is recorded into."""
    from repro_torch.obs.trace import record_spans as rec
    return rec()
