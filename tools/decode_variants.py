#!/usr/bin/env python3
"""Where the time of the port's decode kernels K1/K2 goes, on a CUDA card.

    python3 tools/decode_variants.py

Builds ``src/repro_torch/csrc/paged_decode.cu`` several times, each copy
with one part of the split kernel cut out, and times K1 (``partials=True``,
as the engine calls it) from CUDA-graph replay at two states:

* serve: B=8, KH=8, G=6, D=128, PS=16, MP=64, bf16, ~150-310 tokens a lane
  (the shape of ``chip_smoke.py``'s serve state with the most live pages);
* long:  ``chip_smoke.py``'s long-context case (B=64, PS=16, MP=256, bf16,
  up to 4096 tokens a lane).

Variants (the cut-down copies compute wrong results; only their time is
read):

* full        — the kernel as shipped;
* copies_only — the tile loop copies K/V through the ring, computes nothing;
* no_pv       — no p.v accumulation;
* no_copies   — no cp.async: the arithmetic on whatever the ring holds;
* empty       — every split exits at once: two launches and the merge.

Prints one JSON line per variant, then the card's name and power limit.
Every build goes into ``build/decode_variants/`` (git-ignored).
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = os.path.join(ROOT, "src", "repro_torch", "csrc", "paged_decode.cu")
OUT = os.path.join(ROOT, "build", "decode_variants")

VARIANTS = {
    "full": [],
    "copies_only": [("    if (vmask == 0) continue;", "    continue;")],
    "no_pv": [("    for (int t = 0; t < TPW; ++t) {\n      const KV* vr",
               "    for (int t = 0; t < 0; ++t) {\n      const KV* vr")],
    "no_copies": [("        cp_async16(kst + r * RS + ch * 16,",
                   "        if (0) cp_async16(kst + r * RS + ch * 16,"),
                  ("        cp_async16(vst + r * RS + ch * 16,",
                   "        if (0) cp_async16(vst + r * RS + ch * 16,")],
    "empty": [("  if (p0 >= p1) {", "  if (true) {")],
}


def build(name, edits, nvcc, flags):
    src = open(CU).read()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{name}: source text not found: {old!r}")
        src = src.replace(old, new)
    cu = os.path.join(OUT, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(OUT, f"{name}.so")
    probe = os.path.join(ROOT, "src", "repro_torch", "csrc", "probe.cu")
    return so, subprocess.Popen([nvcc, *flags, "-shared", cu, probe, "-o",
                                 so], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as C
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_decode import fused_decode_kernel
    os.makedirs(OUT, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = {n: build(n, e, _build.nvcc(), flags) for n, e in VARIANTS.items()}
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(so)
        for fn, args in _build._SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    q, k, v, bt, _, _ = C.attention_inputs(8, 16, 64, torch.bfloat16, seed=5)
    pos = torch.tensor([300, 290, 250, 200, 310, 280, 150, 305],
                       dtype=torch.int32, device="cuda")
    long_in = C.attention_inputs(64, 16, 256, torch.bfloat16, seed=8)
    ql, kl, vl, btl, posl, _ = long_in
    res = {n: [] for n in libs}
    for _ in range(2):                      # two rounds, in turns
        for name, lib in libs.items():
            _build._LIB = lib
            res[name].append({
                "serve_ms": C.graph_ms(lambda: fused_decode_kernel(
                    q, k, v, bt, pos, partials=True), 100),
                "long_ms": C.graph_ms(lambda: fused_decode_kernel(
                    ql, kl, vl, btl, posl, partials=True), 10)})
    _build._LIB = None
    for name, runs in res.items():
        print(json.dumps({"variant": name, "runs": runs}), flush=True)
    print(C.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
