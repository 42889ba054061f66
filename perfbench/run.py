#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print one JSON line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  ``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics (``torch.profiler`` and host spans in short samples
spread over the window, so that the traced run serves the same load).  Without a
CUDA card, with fewer cards than the cell asks for, or without the
program beside it, it exits non-zero and prints no result.  Every number
the correctness check compared is printed beside its limit as the last
lines of standard error and under ``checks``, the last key of the line.

Caches stay inside the checkout, at fixed paths under ``build/``: the
port's kernel library (``REPRO_TORCH_BUILD_DIR``), and Triton's, torch's
extension and CUDA's JIT caches should anything use them.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_environment() -> None:
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    # the profiler's CUPTI torn down at each stop: left attached, it slows
    # every later launch of a traced run by about a third, samples or not
    os.environ["TEARDOWN_CUPTI"] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process, one host thread: the port's host path is a single
    # Python thread, and idle worker threads only take cores from it
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def shm() -> set:
    try:
        return set(os.listdir("/dev/shm"))
    except OSError:
        return set()


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def fail(msg: str, code: int = 2):
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("the program (src/repro_torch) is not in this checkout")
    set_environment()
    shm0 = shm()
    import torch
    torch.set_num_threads(1)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import harness
    cell = harness.load_cell(ROOT, args.workload, bool(args.trace))
    if not torch.cuda.is_available():
        fail("no CUDA card: the benchmark runs only on the card", 3)
    if torch.cuda.device_count() < cell.chips:
        fail(f"the cell asks for {cell.chips} cards, "
             f"{torch.cuda.device_count()} present", 3)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda:0", T_PROCESS)
    out_checks = out.pop("checks")
    out["card"] = power_limit()
    out["checks"] = out_checks
    bad = forbidden_modules()
    if bad:
        fail(f"modules loaded that the port must not use: {bad}", 4)
    new_shm = shm() - shm0
    if new_shm:
        fail(f"the run wrote to /dev/shm: {sorted(new_shm)}", 5)
    print(json.dumps(out), flush=True)
    for name, n in out_checks.items():
        print(f"check {name}: {n['value']} {n['rule']} {n['limit']}",
              file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)


if __name__ == "__main__":
    main()
