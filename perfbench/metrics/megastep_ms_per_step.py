"""megastep_ms_per_step: wall time of ``mega_fn`` (the K-token megastep:
allocation, every layer, sampling) up to the device's end of it, per token
step, over the window's rounds outside the traced run's samples."""
from perfbench.stats import unsampled


def read(w):
    rounds = unsampled(w.rounds)
    steps = w.K * len(rounds)
    if not steps:
        return None
    return sum(r["mega_s"] for r in rounds) / steps * 1e3
