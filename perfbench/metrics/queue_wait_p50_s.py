"""queue_wait_p50_s: median, over the requests due inside the window, of
(due time) -> (the round end at which the request holds a lane); one not
seated by the window's end counts at (window end - due)."""
from perfbench.stats import percentile


def read(w):
    due = [r for r in w.recs if w.ws <= r.due < w.ws + w.seconds]
    return percentile([(r.admit_t if r.admit_t is not None
                        and r.admit_t <= w.we else w.we) - r.due
                       for r in due], 50)
