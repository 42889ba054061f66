"""output_tokens_per_s: sampled (not teacher-forced) tokens delivered to
requests inside the window, over the window's seconds (first round start
to last round end)."""


def read(w):
    if not w.rounds:
        return None
    return sum(r["delivered"] for r in w.rounds) / (w.we - w.ws)
