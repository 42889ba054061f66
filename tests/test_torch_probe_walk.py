"""K3's walk on the CPU: the plain model of the CUDA kernel's rounds.

``kernels/probe/ref.py probe_walk_plain`` runs the kernel's structure
(aligned 4-cell vectors, L-lane groups, the cells before h masked, the
wrap at m) in PyTorch; it is held bit for bit to the port's
``find_batch`` and to the JAX ``probe_lookup`` in interpret mode, on the
same tables (built by the JAX package, copied cell for cell).  Also here:
the constants the wrapper hands the kernel against ``_hash`` in numpy
uint32, ``lookup_bytes`` (K3's byte bound), the port's ``probe_bytes``
note, and the low-32-bit reading of int64 keys.  The kernel itself runs
only on the card (``test_torch_kernels.py``, ``chip_smoke.py``).
"""
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as JBT
from repro.kernels.probe import probe_lookup as j_probe
from repro_torch.core import batched as TBT
from repro_torch.core import encoding as E
from repro_torch.kernels import stats as TKS
from repro_torch.kernels.probe import (hash_constants, lookup_bytes,
                                       probe_lookup, probe_lookup_kernel,
                                       probe_walk_plain)
from repro_torch.kernels.probe import probe as probe_mod
from repro_torch.kernels.probe.probe import SEED_MIX

torch.set_num_threads(1)

LANES = (4, 8, 16, 32)
# the JAX kernel runs when m % TB == 0 and m // TB >= 2; other tables take
# its jnp fallback, which is the reference's find_batch
TB = {512: 256, 4096: 2048}


def _port(ht) -> TBT.HashTable:
    i32 = torch.int32
    return TBT.HashTable(
        table=torch.from_numpy(np.asarray(ht.table).astype(np.int32)),
        num_keys=torch.tensor(int(ht.num_keys), dtype=i32),
        num_tombs=torch.tensor(int(ht.num_tombs), dtype=i32),
        seed=torch.tensor(int(ht.seed), dtype=i32),
        meta=torch.zeros(0, dtype=i32))


def _table(m, n_keys, seed, rng_seed, delete_every=3):
    """A JAX table with ``n_keys`` keys, every ``delete_every``-th deleted
    (tombstones), its port copy, and the inserted keys."""
    rng = np.random.default_rng(rng_seed)
    ht = JBT.create(m, seed=seed)
    keys = rng.choice(1 << 26, size=n_keys, replace=False).astype(np.uint32)
    ht, ret = JBT.insert_batch(ht, jnp.asarray(keys))
    assert not np.any(np.asarray(ret) == 2)
    if delete_every and n_keys >= delete_every:
        ht, _ = JBT.delete_batch(ht, jnp.asarray(keys[::delete_every]))
    return ht, _port(ht), keys


def _check(ht, port, qk, lanes=LANES):
    """find_batch == the JAX probe_lookup (interpret) == the walk at every
    L.  Returns the walk's rounds at each L."""
    m = TBT.size(port)
    fj, sj = j_probe(ht, jnp.asarray(qk.astype(np.uint32)),
                     TB=TB.get(m, 2048), interpret=True)
    fp, sp = TBT.find_batch(port, torch.from_numpy(qk.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(fj), fp.numpy())
    np.testing.assert_array_equal(np.asarray(sj), sp.numpy())
    rounds = {}
    for L in lanes:
        fw, sw, rounds[L] = probe_walk_plain(port.table, torch.from_numpy(
            qk.astype(np.int64)), port.seed, L)
        assert torch.equal(fw, fp) and torch.equal(sw, sp), L
    return rounds


@pytest.mark.parametrize("m", [1, 2, 3, 5, 192, 512, 4096, 200000])
@pytest.mark.parametrize("load", [0.3, 0.9])
def test_walk_matches_find_batch_and_jax_probe(m, load):
    """Tables of 1 to 200000 cells (a full table at m = 3 and 5, the
    general hash branch above 2^16 at 200000 with 4096 keys), tombstones,
    present, deleted and absent keys, every lane count."""
    n = min(4096, max(1, math.ceil(load * m)))
    ht, port, keys = _table(m, n, seed=m % 7, rng_seed=m + int(10 * load))
    rng = np.random.default_rng(m)
    qk = np.concatenate([keys, rng.integers(1 << 26, 1 << 27, size=64)])
    rounds = _check(ht, port, qk)
    # a larger group never takes more rounds
    for a, b in zip(LANES, LANES[1:]):
        assert bool((rounds[b] <= rounds[a]).all())


@pytest.fixture(scope="module")
def long_run():
    """m = 4096 with 1100 keys homed in the last 64 buckets: one run of
    more than 32 x 32 cells that crosses the end of the table."""
    m, seed = 4096, 5
    rng = np.random.default_rng(11)
    cand = rng.choice(1 << 26, size=1 << 17, replace=False)
    hv = TBT._hash(TBT.create(m, seed=seed, device="cpu"),
                   torch.from_numpy(cand)).numpy()
    band = cand[hv >= m - 64]
    assert band.size >= 1164
    ht = JBT.create(m, seed=seed)
    ht, ret = JBT.insert_batch(ht, jnp.asarray(band[:1100].astype(np.uint32)))
    assert not np.any(np.asarray(ret) == 2)
    ht, _ = JBT.delete_batch(ht, jnp.asarray(band[:1100:9].astype(np.uint32)))
    return ht, _port(ht), band[:1164]


@pytest.mark.parametrize("lanes", LANES)
def test_walk_long_run_across_the_end(long_run, lanes):
    ht, port, qk = long_run
    tab = port.table
    assert tab[0] != E.EMPTY and tab[-1] != E.EMPTY
    empty = torch.nonzero(tab == E.EMPTY).flatten()
    run = int(torch.diff(empty, append=empty[:1] + tab.shape[0]).max()) - 1
    assert run > 32 * 32
    rounds = _check(ht, port, qk, lanes=(lanes,))[lanes]
    assert int(rounds.max()) >= (run - 64) // (4 * lanes)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 192, 384, 4096, 65536, 65537,
                               200000, 1 << 20])
@pytest.mark.parametrize("seed", [0, 7, -3])
def test_hash_constants_reproduce_hash(m, seed):
    """The kernel's arithmetic on the wrapper's constants, in numpy
    uint32, is ``BT._hash`` bit for bit (the JAX package's and the
    port's), both branches, including the uint32 wrap above 2^16."""
    a0, shift = hash_constants(m)
    keys = np.random.default_rng(m).integers(0, 1 << 32, size=4096,
                                             dtype=np.uint64).astype(np.uint32)
    with np.errstate(over="ignore"):
        mix = np.uint32(seed & 0xFFFFFFFF) * np.uint32(SEED_MIX)
        x = (keys ^ mix) * np.uint32(a0)
        if shift >= 32:
            h = np.zeros_like(x)
        elif shift >= 0:
            h = x >> np.uint32(shift)
        else:
            h = ((x >> np.uint32(16)) * np.uint32(m)) >> np.uint32(16)
    assert (shift >= 0) == (m & (m - 1) == 0)
    port = TBT.create(m, seed=seed, device="cpu")
    np.testing.assert_array_equal(
        h.astype(np.int64), TBT._hash(port, torch.from_numpy(
            keys.astype(np.int64))).numpy())
    jt = JBT.create(m, seed=seed)
    np.testing.assert_array_equal(h, np.asarray(
        JBT._hash(jt, jnp.asarray(keys))).astype(np.uint32))


def test_lookup_bytes_counts_a_shared_run_once():
    """Two keys on one run read its cells once; a run across the end
    counts its cells on both sides; a hit ends a run."""
    tab = torch.full((16,), E.EMPTY, dtype=torch.int32)
    tab[2:8] = E.enc_final(torch.arange(6))
    per_key = 8 + 1 + 4
    miss = torch.zeros(2, dtype=torch.bool)
    # runs 2..8 and 4..8 (to and with the EMPTY at 8): 7 cells
    assert lookup_bytes(tab, [2, 4], [-1, -1], miss) \
        == 4 * 7 + 2 * per_key + 4
    # alone, each counts its own cells
    assert lookup_bytes(tab, [4], [-1], miss[:1]) == 4 * 5 + per_key + 4
    # found at 5 from 2: cells 2..5
    assert lookup_bytes(tab, [2], [5], torch.ones(1, dtype=torch.bool)) \
        == 4 * 4 + per_key + 4
    wrap = torch.full((16,), E.EMPTY, dtype=torch.int32)
    wrap[14:] = E.enc_final(torch.arange(2))
    wrap[:2] = E.enc_final(torch.arange(2, 4))
    # 14, 15, 0, 1, 2 and 15, 0, 1, 2: five cells
    assert lookup_bytes(wrap, [14, 15], [-1, -1], miss) \
        == 4 * 5 + 2 * per_key + 4


def test_int64_keys_are_read_by_their_low_32_bits():
    """Keys >= 2^32 and negative keys hash and match as their low 32 bits
    in the plain model of the kernel's walk, as the reference's uint32
    view takes them.  The kernel's own reading of such keys is checked
    only on the card (``test_torch_kernels.py``, ``chip_smoke.py``)."""
    ht, port, keys = _table(512, 400, seed=9, rng_seed=4)
    low = torch.from_numpy(keys.astype(np.int64))
    fp, sp = TBT.find_batch(port, low)
    assert bool(fp[1::3].all())
    for k in (low + (1 << 32), low + (123 << 32), low - (1 << 32),
              low - (7 << 32)):
        fw, sw, _ = probe_walk_plain(port.table, k, port.seed, 16)
        assert torch.equal(fw, fp) and torch.equal(sw, sp)
    assert bool((low - (1 << 32) < 0).all())


def test_probe_bytes_notes_keys_results_and_seed():
    """A kernel call notes 8 B of int64 key, 1 B of found and 4 B of slot
    per lookup and the 4-byte seed, whatever the table holds; the plain
    path notes nothing."""
    _, port, keys = _table(512, 300, seed=1, rng_seed=5)
    qk = torch.from_numpy(keys.astype(np.int64))
    with TKS.kernel_stats_scope() as st:
        probe_lookup(port, qk)
        assert st["probe_bytes"] == 13 * 300 + 4
        probe_lookup(port, qk[:7].to(torch.int32))
        assert st["probe_bytes"] == 13 * 307 + 8
        probe_lookup(port, qk, use_kernel=False)
        assert st["probe_bytes"] == 13 * 307 + 8
        assert st["attn_bytes"] == 0


def test_kernel_lane_count_is_the_wrappers():
    """csrc/probe.cu builds and launches one L, and it is the wrapper's
    ``LANES`` (which the CPU tests of the walk cover)."""
    src = (pathlib.Path(probe_mod.__file__).resolve().parents[2] / "csrc"
           / "probe.cu").read_text()
    got = re.findall(r"^constexpr int LANES = (\d+);", src, re.M)
    assert got == [str(probe_mod.LANES)] and probe_mod.LANES in LANES
    assert "probe_kernel<LANES><<<" in src


def test_kernel_wrapper_refuses_bad_keys():
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    ht = TBT.HashTable(torch.empty(16, **i32), torch.empty((), **i32),
                       torch.empty((), **i32), torch.zeros((), **i32),
                       torch.empty(0, **i32))
    keys = torch.empty(4, dtype=torch.int64, **meta)
    with pytest.raises(ValueError):
        probe_lookup_kernel(ht, keys.reshape(2, 2))
