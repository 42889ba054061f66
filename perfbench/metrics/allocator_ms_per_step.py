"""allocator_ms_per_step: host time in the program's outermost
``allocator.*`` spans (``alloc_step``, ``free``, ``headroom``,
``rebuild``; one inside another counts once), per token step of the
traced run's sampled rounds, where the spans are recorded.  Nothing
without spans or without an allocator span in them."""


def read(w):
    if not w.spans:
        return None
    secs = [e["outer_s"] for name, e in w.spans.items()
            if name.split(".")[0] == "allocator"]
    steps = w.K * sum(1 for r in w.rounds if r.get("sampled"))
    if not secs or not steps:
        return None
    return sum(secs) / steps * 1e3
