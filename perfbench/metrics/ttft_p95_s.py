"""ttft_p95_s: 95th percentile, over every request due inside the window,
of (first sampled token on the host) - (due time).  A request with no
first token by the window's end counts at (window end - due): a lower
bound, so that a stall shows and a faster system can only read lower."""
from perfbench.stats import percentile


def read(w):
    due = [r for r in w.recs if w.ws <= r.due < w.ws + w.seconds]
    return percentile([(r.first_t if r.first_t is not None
                        and r.first_t <= w.we else w.we) - r.due
                       for r in due], 95)
