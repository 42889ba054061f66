"""device_idle_share: the share of the traced run's samples, in percent, in
which no operation ran on the device: 1 - (union of the device's
intervals) / (the samples' length), summed over the samples."""


def read(w):
    if w.trace is None:
        return None
    return (1.0 - w.trace["busy_s"] / w.window_s) * 100.0
