#!/usr/bin/env python3
"""Readings that set the correctness limits and the traffic's rate; run on
the card, never by the benchmark's own runs.

    python3 perfbench/calibrate.py control --workload <cell> \\
        --seeds 11 12 13 --seconds 30
        each seed: one run of the cell as the benchmark makes it, then the
        served sample judged by the float32 reference and, at the same
        positions, by the fp8 control (the reference with its weights,
        matmul inputs and K/V rounded to float8 e4m3): the widest gap of
        the program's tokens and of the control's first choices.
    python3 perfbench/calibrate.py sweep --workload <open cell> \\
        --rates 4 6 8 10 --seconds 30
        the open loop at each arrival rate in turn (one set-up): requests
        due, seated and waiting at the window's end, the tails; the knee
        is the highest rate whose queue does not grow through the window.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, set_environment  # noqa: E402


def gap_stats(gaps) -> dict:
    import numpy as np
    g = np.concatenate(gaps) if gaps else np.zeros(0)
    return {"max": float(g.max(initial=0.0)),
            "mean": float(g.mean()) if g.size else 0.0,
            "p99": float(np.percentile(g, 99)) if g.size else 0.0,
            "share_nonzero": float((g > 0).mean()) if g.size else 0.0,
            "n": int(g.size)}


def control(cell, seeds, seconds, device):
    from perfbench import check as CK
    from perfbench import harness
    from perfbench.reference import served as RS
    import torch
    for seed in seeds:
        captured = {}
        orig = CK.judge

        def spy(cfg, seed_, dev, snap, served, stops):
            captured["served"] = served
            return orig(cfg, seed_, dev, snap, served, stops)
        CK.judge = spy
        try:
            t0 = time.perf_counter()
            out = harness.run_cell(cell, seed, seconds, False, device, t0)
        finally:
            CK.judge = orig
        served = captured["served"]
        idx = CK.sample(served, int(cell.config["check"]["requests"]), seed)
        t1 = time.perf_counter()
        res = RS.served_gaps(cell.config, seed, device,
                             [served[i] for i in idx], control=True)
        t_ref = time.perf_counter() - t1
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "checks": out["checks"],
                          "program": gap_stats(res["gaps"]),
                          "control": gap_stats(res["control_gaps"]),
                          "reference_s": t_ref,
                          "metrics": out["metrics"]}), flush=True)
        torch.cuda.empty_cache()


def sweep(cell, rates, seconds, device, seed):
    from perfbench import harness
    for rate in rates:
        c = copy.deepcopy(cell)
        c.mix["arrivals"]["rate_per_s"] = rate
        got = {}
        orig = harness.Driver.run_open

        def spy(self, *a, **kw):
            ws = orig(self, *a, **kw)
            got["queue"] = len(self.srv.sched.queue)
            got["running"] = len(self.srv.sched.running())
            got["rounds"] = len(self.rounds)
            got["round_s"] = ((self.rounds[-1]["t1"] - self.rounds[0]["t0"])
                              / max(len(self.rounds), 1))
            return ws
        harness.Driver.run_open = spy
        try:
            out = harness.run_cell(c, seed, seconds, False, device,
                                   time.perf_counter())
        finally:
            harness.Driver.run_open = orig
        print(json.dumps({"rate": rate, **got, "requests": out["requests"],
                          "metrics": out["metrics"],
                          "correct": out["correct"]}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("control", "sweep"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--rates", type=float, nargs="+", default=[])
    ap.add_argument("--seconds", type=float, default=30)
    args = ap.parse_args()
    set_environment()
    import torch
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import harness
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    cell = harness.load_cell(ROOT, args.workload, False)
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    if args.mode == "control":
        control(cell, args.seeds, args.seconds, "cuda:0")
    else:
        sweep(cell, args.rates, args.seconds, "cuda:0", args.seeds[0])


if __name__ == "__main__":
    main()
