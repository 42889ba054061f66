#!/usr/bin/env python3
"""K3 (the probe-lookup kernel) at each lane count, beside the earlier
design and cut-down copies of itself, on a CUDA card.

    python3 tools/probe_variants.py

Times, warm (CUDA-graph replay of back-to-back calls) and cold (L2 flushed
by writing 256 MB before each call, each call timed with CUDA events):

* ``L4`` .. ``L32`` — ``probe_lookup_kernel`` at each lane count L in
  {4, 8, 16, 32} (one launch a call: the hash in the kernel): the shipped
  library at its L (``LANES`` of ``src/repro_torch/csrc/probe.cu``), and
  copies of that source with ``LANES`` edited at the others;
* ``torch_hash`` — the earlier design: the hash computed by PyTorch ops
  in the wrapper (``BT._hash``), the keys copied to int32, one warp a
  key, an int32 ``found`` converted to bool.  Its kernel is a copy of
  ``probe.cu`` edited to read the precomputed hash and write int32
  ``found``, at L = 32 (so a round reads 128 aligned cells, where the
  earlier kernel read 32 from h);
* cut-down copies of the shipped kernel at the shipped L, which compute
  wrong results and are only timed: ``key_only`` (each group loads its
  key and hashes it, then stops: the launch, key reads and hash) and
  ``one_round`` (each group stops after its first round);

at four shapes:

* rebuild: the rebuild's lookup in ``chip_smoke.py`` — the block-table
  keys of 8 sequences x 64 logical pages (512 keys) on a 192-cell table
  holding about 100 live pages (the rebuild there holds fewer);
* probe: ``chip_smoke.py``'s probe phase — 2^18 lookups, half present, on
  a churned 2^20-cell table at load 0.9;
* probe_present, probe_absent: its present and its absent half.

For each shape it also prints the mean and largest run a lookup covers
(``probe.run_cells``) and, from the plain model of the kernel's rounds
(``ref.probe_walk_plain``, run on the card and held to ``find_batch``),
the mean rounds a key and the table bytes the groups read at each L.

The variants run in turns (torch_hash, L4 .. L32, key_only, one_round,
then the same in reverse).  First every L and torch_hash are checked
against ``find_batch``, and ``one_round`` against the plain model at the
shipped L: the keys the model decides in its first round get
``find_batch``'s answer, the others (False, -1), so the kernel's first
round covers the cells the model's does.  Prints one JSON line per variant (both turns and
their mean), one with each shape's byte bound, then the card's name and
power limit.  The edited copies are built into ``build/probe_variants/``
(git-ignored).  Its edits are exact source strings: change them with the
kernel.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = os.path.join(ROOT, "src", "repro_torch", "csrc", "probe.cu")
OUT = os.path.join(ROOT, "build", "probe_variants")
LANES = (4, 8, 16, 32)
LANES_LINE = "constexpr int LANES = {};"

EDITS = {
    # the earlier design's kernel: the hash read from an int32 array passed
    # in the seed's place, found written as int32
    "torch_hash": [
        ("  const int h = bucket(key, (uint32_t)__ldg(seed), a0, m, shift);",
         "  const int h = active ? __ldg(seed + i) : 0;"),
        ("    uint8_t* __restrict__ found, int* __restrict__ slot) {",
         "    int* __restrict__ found, int* __restrict__ slot) {"),
        ("      shift, (uint8_t*)found, (int*)slot);",
         "      shift, (int*)found, (int*)slot);")],
    "key_only": [("  bool active = i < n;\n", "  bool active = false;\n")],
    "one_round": [("      } else if ((r + 1) * L >= nv) {",
                   "      } else if (true) {")],
}


def build(name, nvcc, flags):
    """Start compiling an edited copy of probe.cu; returns a function that
    waits for the compiler and loads the library."""
    src = open(CU).read()
    for old, new in EDITS[name]:
        if old not in src:
            raise SystemExit(f"{name}: source text not found: {old!r}")
        src = src.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.Popen([nvcc, *flags, "-shared", cu, "-o", so],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)

    def load() -> ctypes.CDLL:
        from repro_torch.kernels import _build
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(so)
        lib.probe_lookup_launch.argtypes = _build._SIGNATURES[
            "probe_lookup_launch"]
        lib.probe_lookup_launch.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        return lib
    return load


def with_lib(lib, fn):
    """``fn`` run with ``lib`` as the port's kernel library."""
    from repro_torch.kernels import _build

    def call(*args):
        saved, _build._LIB = _build._LIB, lib
        try:
            return fn(*args)
        finally:
            _build._LIB = saved
    return call


def torch_hash_call(lib, ht, keys):
    """The earlier wrapper's device work: PyTorch hash, int32 key copy,
    one warp a key, bool conversion of found."""
    import torch
    from repro_torch.core import batched as BT
    from repro_torch.kernels import _build
    from repro_torch.kernels.probe.probe import hash_constants
    keys = BT._keys(ht, keys)
    hv = BT._hash(ht, keys).contiguous()
    keys.to(torch.int32).contiguous()      # the earlier kernel's key input
    n, m = keys.shape[0], BT.size(ht)
    found = torch.empty((n,), dtype=torch.int32, device=keys.device)
    slot = torch.empty((n,), dtype=torch.int32, device=keys.device)
    a0, shift = hash_constants(m)
    rc = lib.probe_lookup_launch(
        _build.ptr(ht.table), m, _build.ptr(keys), n, _build.ptr(hv), a0,
        shift, _build.ptr(found), _build.ptr(slot),
        _build.stream(keys.device))
    if rc:
        raise RuntimeError(f"torch_hash launch: CUDA error {rc}")
    return found.to(torch.bool), slot


def rebuild_like(rng):
    """8 sequences' block-table keys (64 logical pages each) on a 192-cell
    table holding 5-20 live pages of each."""
    import torch
    from repro_torch.core import batched as BT
    from repro_torch.serving.page_table import page_key
    seq_ids = torch.from_numpy(rng.choice(1000, size=8, replace=False))
    live = torch.cat([page_key(s, torch.arange(int(rng.integers(5, 21))))
                      for s in seq_ids.tolist()]).cuda()
    ht = BT.create(192, seed=0, device="cuda")
    ht, ret = BT.insert_batch(ht, live)
    if bool((ret == 2).any()):
        raise SystemExit("rebuild-like table: insert ABORTed")
    keys = page_key(seq_ids[:, None], torch.arange(64)[None, :]).reshape(
        -1).cuda()
    return ht, keys


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as C
    from repro_torch.core import batched as BT
    from repro_torch.kernels import _build
    from repro_torch.kernels.probe import (lookup_bytes, probe_lookup_kernel,
                                           probe_walk_plain)
    from repro_torch.kernels.probe.probe import LANES as SHIPPED, run_cells
    shipped = LANES_LINE.format(SHIPPED)
    EDITS["torch_hash"].append((shipped, LANES_LINE.format(32)))
    for lanes in LANES:
        if lanes != SHIPPED:
            EDITS[f"L{lanes}"] = [(shipped, LANES_LINE.format(lanes))]
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    loads = {name: build(name, _build.nvcc(), flags) for name in EDITS}
    _build.library()
    libs = {name: load() for name, load in loads.items()}
    rng = np.random.default_rng(0)
    shapes = {"rebuild": rebuild_like(rng)}
    ht, queries, _ = C.churned_table(rng)
    half = queries.shape[0] // 2
    shapes["probe"] = (ht, queries)
    shapes["probe_present"] = (ht, queries[:half].contiguous())
    shapes["probe_absent"] = (ht, queries[half:].contiguous())
    calls = {"torch_hash": lambda t, k: torch_hash_call(libs["torch_hash"],
                                                        t, k)}
    for lanes in LANES:
        calls[f"L{lanes}"] = probe_lookup_kernel if lanes == SHIPPED \
            else with_lib(libs[f"L{lanes}"], probe_lookup_kernel)
    checked = list(calls)
    for name in ("key_only", "one_round"):
        calls[name] = with_lib(libs[name], probe_lookup_kernel)
    bounds, walks = {}, {}
    for shape, (t, k) in shapes.items():
        fp, sp = BT.find_batch(t, k)
        hv = BT._hash(t, k)
        bounds[shape] = lookup_bytes(t.table, hv, sp, fp) \
            / C.HBM_BYTES_PER_S * 1e3
        cells = run_cells(t.table, hv, sp, fp).float()
        walks[shape] = {"cells_mean": float(cells.mean()),
                        "cells_max": int(cells.max())}
        for name in checked:
            fk, sk = calls[name](t, k)
            if not (torch.equal(fk, fp) and torch.equal(sk, sp)):
                raise SystemExit(f"{name} != find_batch at {shape}")
        for lanes in LANES:
            fw, sw, rounds = probe_walk_plain(t.table, k, t.seed, lanes)
            if not (torch.equal(fw, fp) and torch.equal(sw, sp)):
                raise SystemExit(f"probe_walk_plain != find_batch at {shape}")
            if lanes == SHIPPED:
                first = rounds == 1
                f1, s1 = calls["one_round"](t, k)
                if not (torch.equal(f1, fp & first) and torch.equal(
                        s1, torch.where(first, sp, -1))):
                    raise SystemExit(f"one_round != the plain model's first "
                                     f"round at {shape}")
            walks[shape][f"L{lanes}"] = {
                "rounds_mean": float(rounds.float().mean()),
                "rounds_max": int(rounds.max()),
                "table_mb_read": int(rounds.sum()) * 16 * lanes / 1e6}
    order = list(calls)
    res = {n: [] for n in calls}
    for turn in (order, order[::-1]):
        for name in turn:
            fn, run = calls[name], {}
            for shape, (t, k) in shapes.items():
                n = 100 if shape == "rebuild" else 10
                run[f"{shape}_ms"] = C.graph_ms(lambda: fn(t, k), n)
                run[f"{shape}_cold_ms"] = C.cold_ms(lambda: fn(t, k), 20)
            res[name].append(run)
    for name, runs in res.items():
        mean = {key: sum(r[key] for r in runs) / len(runs) for key in runs[0]}
        print(json.dumps({"variant": name, "mean": mean, "runs": runs}),
              flush=True)
    print(json.dumps({"shipped_lanes": SHIPPED, "bound_ms": bounds,
                      "walks": walks,
                      "lookups": {s: int(k.shape[0])
                                  for s, (_, k) in shapes.items()},
                      "m": {s: BT.size(t) for s, (t, _) in shapes.items()}}),
          flush=True)
    print(C.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
