"""mfu: the whole step's share of the card's peak, in percent: the model
FLOPs (``yardstick.window_flops``: 2 per published matmul weight a lane
token step uses, the LM head included, plus q.k and p.v over the attended
tokens) of the window's rounds outside the traced run's samples, over
(those rounds' wall time x the card's 989 TFLOP/s dense bf16).  Taken
outside the samples, so that the profiler's own cost does not dilute it."""
from perfbench import yardstick as Y
from perfbench.stats import unsampled


def read(w):
    rounds = unsampled(w.rounds)
    secs = sum(r["t1"] - r["t0"] for r in rounds)
    if secs <= 0:
        return None
    steps = attended = 0
    for r in rounds:
        s, a = Y.lane_steps(r["p0"], r["p1"])
        steps, attended = steps + s, attended + a
    return Y.window_flops(w.cfg, steps, attended) / (secs * Y.H100_BF16_FLOPS) \
        * 100.0
