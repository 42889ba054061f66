"""moe_ms_per_step: host time in the program's ``model.moe`` spans (the
MoE block with its router, dispatch, experts and combine), per token step
of the traced run's sampled rounds, where the spans are recorded.
Nothing without spans or without the MoE block in them."""


def read(w):
    if not w.spans or "model.moe" not in w.spans:
        return None
    steps = w.K * sum(1 for r in w.rounds if r.get("sampled"))
    if not steps:
        return None
    return w.spans["model.moe"]["total_s"] / steps * 1e3
