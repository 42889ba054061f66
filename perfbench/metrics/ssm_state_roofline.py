"""ssm_state_roofline: the mamba state's least traffic as a share of the
card's memory rate over the device's busy time, in percent: the bytes the
configuration's model module counts for the lane token steps of the
traced run's samples (``ssm_state_bytes``: each mamba layer's ``h`` read
once and written once in float32, its conv tails read and written once;
only lanes that moved are counted), over 3.35 TB/s, divided by the
samples' device busy seconds.  Nothing without a trace or for a model
without a mamba state."""
from perfbench import modules
from perfbench import yardstick as Y


def read(w):
    if w.trace is None or not w.trace["busy_s"]:
        return None
    count = getattr(modules.reference(w.cfg), "ssm_state_bytes", None)
    if count is None:
        return None
    steps = sum(Y.lane_steps(r["p0"], r["p1"])[0] for r in w.rounds
                if r.get("sampled"))
    if not steps:
        return None
    return (count(w.cfg, steps) / Y.H100_HBM_BYTES_PER_S
            / w.trace["busy_s"] * 100.0)
