"""Request lifecycle for the serving scheduler.

A ``Request`` is the unit of admission: it arrives (virtual-clock step
``arrival``), waits in the queue, is ADMITTED into a decode slot (its prompt
is chunked-prefilled through the megastep's teacher-forcing path —
``engine.make_serve_megastep`` ``forced``/``forced_mask``), DECODEs greedy
tokens, and finishes (slot evicted, pages tombstoned and reclaimed).  A
running request can be PREEMPTED by the headroom controller: its pages are
freed, its generated-so-far tokens fold into ``known_tokens`` and it
re-queues — on re-admission the whole history is recomputed via chunked
prefill (vLLM-style recompute preemption; the model is deterministic, so
the continuation is unaffected).

All timing is in VIRTUAL-CLOCK decode steps (the scheduler advances the
clock by K per megastep round), so queue-wait / TTFT / latency accounting
is machine-independent and deterministic — the SLO field ``max_latency``
is a step budget from arrival.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

QUEUED = "queued"       # waiting for admission (incl. after a preemption)
RUNNING = "running"     # owns a decode slot (prefill or decode phase)
DONE = "done"


@dataclasses.dataclass
class Request:
    """One serving request.  ``prompt`` must hold at least one token (the
    first feed).  ``max_new_tokens`` counts the sampled tokens after the
    prompt; the target total length is clamped to the engine's ``S_max`` by
    the scheduler at admission."""
    req_id: int
    prompt: np.ndarray                       # int32 [Lp >= 1]
    max_new_tokens: int
    priority: int = 0                        # higher = more important
    max_latency: Optional[int] = None        # SLO: steps from arrival
    arrival: int = 0                         # virtual-clock arrival step

    # -- lifecycle (scheduler-owned) --------------------------------------
    state: str = QUEUED
    slot: Optional[int] = None
    admitted_at: Optional[int] = None        # first admission
    first_token_at: Optional[int] = None     # first sampled (non-forced) tok
    finished_at: Optional[int] = None
    sampled: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        assert self.prompt.size >= 1, "a request needs >= 1 prompt token"

    # -- derived ----------------------------------------------------------

    @property
    def total_len(self) -> int:
        """Target sequence length: prompt + budgeted new tokens."""
        return int(self.prompt.size) + int(self.max_new_tokens)

    @property
    def deadline(self) -> Optional[int]:
        return (None if self.max_latency is None
                else self.arrival + int(self.max_latency))

    def known_tokens(self) -> np.ndarray:
        """Everything decodable by teacher forcing: the prompt plus every
        token sampled before a preemption — the re-admission 'prompt'."""
        if not self.sampled:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.sampled, np.int32)])

    @property
    def done(self) -> bool:
        return self.state == DONE

    @property
    def missed_deadline(self) -> Optional[bool]:
        """None until finished; then whether the SLO was violated."""
        if self.finished_at is None or self.deadline is None:
            return None
        return self.finished_at > self.deadline

    def queue_wait(self) -> Optional[int]:
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.arrival

    def ttft(self) -> Optional[int]:
        """Time to first token (steps from arrival)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.arrival

    def tpot(self) -> Optional[float]:
        """Time per output token after the first (steps/token), preemption
        stalls included — the decode-phase SLO companion to TTFT.  None
        until finished with at least two sampled tokens."""
        if (self.finished_at is None or self.first_token_at is None
                or len(self.sampled) < 2):
            return None
        return ((self.finished_at - self.first_token_at)
                / (len(self.sampled) - 1))
