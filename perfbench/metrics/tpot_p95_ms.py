"""tpot_p95_ms: 95th percentile, over every request with sampled tokens
delivered at two or more round ends inside the window, of (last token -
first token) / (tokens - 1), counting the window's tokens only.  Tokens
reach the host at the end of the round that made them, up to K at once:
the first delivery counts as the first token, so the divisor is the
tokens delivered after it.  Preemption stalls are included."""
from perfbench.stats import percentile


def read(w):
    per = {}
    for rd in w.rounds:
        for rec, n in rd.get("got", ()):
            per.setdefault(id(rec), []).append((rd["t1"], n))
    vals = []
    for got in per.values():
        if len(got) < 2:
            continue
        (t_first, _), (t_last, _) = got[0], got[-1]
        n_tok = sum(n for _, n in got) - got[0][1] + 1
        vals.append((t_last - t_first) / (n_tok - 1) * 1e3)
    return percentile(vals, 95)
