"""keys_probed_per_step: keys the page table probed (the batcher's scoped
``PROBE_STATS`` count of each round) per token step of the window."""


def read(w):
    steps = w.K * len(w.rounds)
    if not steps:
        return None
    return sum(r["keys_probed"] for r in w.rounds) / steps
