"""k1_roofline: the fused decode attention K1's share of its roofline, in
percent: the bytes the benchmark's formula counts for the lane token steps
of the traced run's samples (``yardstick.k1_bytes``: each attended token's
K and V once, q, the f32 partials, the block-table row and the position),
over the card's 3.35 TB/s, divided by K1's device time in the samples'
traces (its split and merge kernels).  Nothing without a trace or without
K1 in it."""
from perfbench import yardstick as Y


def read(w):
    if w.trace is None or not w.trace["k1_s"]:
        return None
    steps = attended = 0
    for r in w.rounds:
        if r.get("sampled"):
            s, a = Y.lane_steps(r["p0"], r["p1"])
            steps, attended = steps + s, attended + a
    need = Y.k1_bytes(w.cfg, steps, attended, w.max_pages)
    return need / Y.H100_HBM_BYTES_PER_S / w.trace["k1_s"] * 100.0
