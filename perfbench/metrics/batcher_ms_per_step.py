"""batcher_ms_per_step: host time of ``step_round`` outside ``mega_fn``
(forcing, absorb, the scheduler's plan and its application, frees,
admissions), per token step, over the window's rounds outside the traced
run's samples."""
from perfbench.stats import unsampled


def read(w):
    rounds = unsampled(w.rounds)
    steps = w.K * len(rounds)
    if not steps:
        return None
    return sum(r["t1"] - r["t0"] - r["mega_s"] for r in rounds) \
        / steps * 1e3
