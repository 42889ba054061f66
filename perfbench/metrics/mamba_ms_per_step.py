"""mamba_ms_per_step: host time in the program's ``model.mamba`` spans (a
mamba layer's in-projection, conv, state update and gated out-projection),
per token step of the traced run's sampled rounds, where the spans are
recorded.  Nothing without spans or without mamba layers in them."""


def read(w):
    if not w.spans or "model.mamba" not in w.spans:
        return None
    steps = w.K * sum(1 for r in w.rounds if r.get("sampled"))
    if not steps:
        return None
    return w.spans["model.mamba"]["total_s"] / steps * 1e3
