"""The PyTorch port's table (``repro_torch.core``) against the JAX package.

Integer state must match bit for bit: hashes, table cells, counters and
returns.  Inputs come from seeded numpy generators and go to both sides.
The port's int32 table holds the reference's uint32 bit patterns; it is
cast to uint32 (counters to int32) before any comparison or digest.
"""
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as JBT
from repro.core import hashing as JH
from repro_torch.core import batched as TBT
from repro_torch.core import encoding as TE
from repro_torch.core import hashing as TH
from repro_torch.core.probe_strategies import get_strategy
from repro_torch.core.spec import (OP_DELETE, OP_INSERT, OP_LOOKUP,
                                   RET_ABORT, RET_TRUE, step_spec)
from repro_torch.serving import page_table as TPT

# small tensors: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)


def _parity_tool():
    path = os.path.join(HERE, os.pardir, "tools", "record_probe_parity.py")
    spec = importlib.util.spec_from_file_location("record_probe_parity",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def u32(t) -> np.ndarray:
    return np.asarray(t).astype(np.int64).astype(np.uint32)


def assert_same_table(j, t):
    np.testing.assert_array_equal(np.asarray(j.table), u32(t.table))
    assert int(j.num_keys) == int(t.num_keys)
    assert int(j.num_tombs) == int(t.num_tombs)
    assert int(j.seed) == int(t.seed)


def tkeys(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# ---------------------------------------------------------------------------
# Hashing.

@pytest.mark.parametrize("m", [1, 2, 64, 4096, 1 << 20, 3, 100, 320,
                               65537, 200000])
def test_hash_keys_bitwise(m):
    """hash_keys and the seeded table hash equal the reference for random
    uint32 keys and seeds, on both the power-of-two and the general-m
    branch (including the uint32 wrap of the general branch above 2^16)."""
    rng = np.random.default_rng(m)
    keys = rng.integers(0, 2**32, size=2000, dtype=np.uint64).astype(
        np.uint32)
    for seed in (0, 7, 123456, 2**31 - 1):
        np.testing.assert_array_equal(
            np.asarray(JH.hash_keys(jnp.asarray(keys), m, seed)),
            TH.hash_keys(tkeys(keys), m, seed).numpy())
    for seed in (0, 3, 99):
        j = JBT.create(m, seed=seed)
        t = TBT.create(m, seed=seed, device="cpu")
        np.testing.assert_array_equal(
            np.asarray(JBT._hash(j, jnp.asarray(keys))),
            TBT._hash(t, tkeys(keys)).numpy())


# ---------------------------------------------------------------------------
# The linear table, op for op.

def test_linear_ops_bitwise_under_churn():
    """apply_batch (delete < insert < lookup), the no-reuse insert,
    duplicate-heavy inserts, find_batch and delete_batch: same cells,
    counters and returns as the reference after every batch."""
    rng = np.random.default_rng(1)
    j, t = JBT.create(64, seed=5), TBT.create(64, seed=5, device="cpu")
    for _ in range(10):
        ops = rng.integers(0, 3, size=16).astype(np.int32)
        keys = rng.integers(0, 200, size=16).astype(np.uint32)
        j, rj = JBT.apply_batch(j, jnp.asarray(ops), jnp.asarray(keys))
        t, rt = TBT.apply_batch(t, torch.from_numpy(ops), tkeys(keys))
        assert_same_table(j, t)
        np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
    keys = rng.integers(0, 200, size=16).astype(np.uint32)
    jn, rj = JBT.insert_batch(j, jnp.asarray(keys), claim_tombstones=False)
    tn, rt = TBT.insert_batch(t, tkeys(keys), claim_tombstones=False)
    assert_same_table(jn, tn)
    np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
    dup = np.repeat(rng.integers(200, 400, size=4), 4).astype(np.uint32)
    act = rng.random(16) < 0.7
    j, rj = JBT.insert_batch(j, jnp.asarray(dup), active=jnp.asarray(act))
    t, rt = TBT.insert_batch(t, tkeys(dup), active=torch.from_numpy(act))
    assert_same_table(j, t)
    np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
    probe = rng.integers(0, 400, size=32).astype(np.uint32)
    fj, sj = JBT.find_batch(j, jnp.asarray(probe))
    ft, st = TBT.find_batch(t, tkeys(probe))
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    j, rj = JBT.delete_batch(j, jnp.asarray(probe))
    t, rt = TBT.delete_batch(t, tkeys(probe))
    assert_same_table(j, t)
    np.testing.assert_array_equal(np.asarray(rj), rt.numpy())


def test_abort_rebuild_and_live_keys_bitwise():
    """A full table ABORTs the same lanes; live_keys packs the same keys in
    the same (stable) order; rebuild gives the same larger table."""
    m = 16
    j, t = JBT.create(m, seed=2), TBT.create(m, seed=2, device="cpu")
    keys = np.arange(100, 100 + m + 4, dtype=np.uint32)
    j, rj = JBT.insert_batch(j, jnp.asarray(keys))
    t, rt = TBT.insert_batch(t, tkeys(keys))
    np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
    assert (rt.numpy() == RET_ABORT).sum() == 4
    j, _ = JBT.delete_batch(j, jnp.asarray(keys[:5]))
    t, _ = TBT.delete_batch(t, tkeys(keys[:5]))
    kj, nj = JBT.live_keys(j)
    kt, nt = TBT.live_keys(t)
    np.testing.assert_array_equal(np.asarray(kj), u32(kt))
    assert int(nj) == int(nt)
    for new_m, seed in ((32, None), (48, 9)):
        assert_same_table(JBT.rebuild(j, new_m, seed),
                          TBT.rebuild(t, new_m, seed))


# ---------------------------------------------------------------------------
# The recorded linear-probe digests.

def _state_digest(tool, ht):
    return tool.digest(u32(ht.table), np.int32(ht.num_keys),
                       np.int32(ht.num_tombs), np.int32(ht.seed))


def _replay_port(tool):
    """``tools/record_probe_parity.replay``'s workload through the port."""
    dg = tool.digest
    LPT = TPT.for_strategy("linear")
    records = []
    rng = np.random.default_rng(0)
    ht = TBT.create(64, seed=3, device="cpu")
    records.append({"leg": "create", "state": _state_digest(tool, ht)})
    for step in range(12):
        ops = torch.from_numpy(rng.integers(0, 3, size=16).astype(np.int32))
        keys = tkeys(rng.integers(0, 4096, size=16))
        ht, ret = TBT.apply_batch(ht, ops, keys)
        records.append({"leg": "apply", "step": step,
                        "state": _state_digest(tool, ht),
                        "ret": dg(ret.numpy())})
    keys = tkeys(rng.integers(0, 4096, size=16))
    ht_nr, ret = TBT.insert_batch(ht, keys, claim_tombstones=False)
    records.append({"leg": "insert_noreuse",
                    "state": _state_digest(tool, ht_nr),
                    "ret": dg(ret.numpy())})
    dup = tkeys(np.repeat(rng.integers(0, 4096, size=4), 4))
    ht, ret = TBT.insert_batch(ht, dup)
    records.append({"leg": "insert_dup", "state": _state_digest(tool, ht),
                    "ret": dg(ret.numpy())})
    records.append({"leg": "rebuild",
                    "state": _state_digest(tool, TBT.rebuild(ht, 128))})

    table = LPT.create_table(32, seed=1, device="cpu")
    B, max_pages, page_size = 4, 8, 2
    seq_ids = torch.arange(B, dtype=torch.int32)
    positions = torch.zeros((B,), dtype=torch.int32)
    block = torch.full((B, max_pages), -1, dtype=torch.int32)
    for step in range(10):
        res, block = LPT.alloc_step_incremental(
            table, seq_ids, positions, block, page_size=page_size)
        table = res.table
        records.append({"leg": "alloc", "step": step,
                        "state": _state_digest(tool, table),
                        "ret": dg(res.write_slot.numpy(),
                                  res.aborted.numpy(), block.numpy())})
        positions = positions + 1
    evict = torch.tensor([False, True, True, False])
    table = LPT.free_sequences(table, seq_ids, positions,
                               page_size=page_size, max_pages=max_pages,
                               active=evict)
    block = LPT.invalidate_block_rows(block, evict)
    records.append({"leg": "free", "state": _state_digest(tool, table),
                    "ret": dg(block.numpy())})
    res = LPT.alloc_step(table, seq_ids, positions, page_size=page_size)
    table = res.table
    records.append({"leg": "alloc_plain", "state": _state_digest(tool, table),
                    "ret": dg(res.write_slot.numpy(), res.aborted.numpy())})
    pages = LPT.lookup_pages(table, seq_ids, positions, page_size=page_size,
                             max_pages=max_pages)
    rebuilt = LPT.rebuild_block_table(table, seq_ids, max_pages)
    records.append({"leg": "lookup",
                    "ret": dg(pages.numpy(), rebuilt.numpy())})
    fresh, old_slots, new_slots, live = LPT.rehash(table, 64)
    records.append({"leg": "rehash", "state": _state_digest(tool, fresh),
                    "ret": dg(old_slots.numpy(), new_slots.numpy(),
                              live.numpy())})
    return records


def test_port_replays_recorded_linear_digests():
    """Every digest of tests/fixtures/probe_linear_parity.json, replayed
    through the port: the batched table legs and the page-table legs."""
    tool = _parity_tool()
    with open(os.path.join(HERE, "fixtures",
                           "probe_linear_parity.json")) as f:
        golden = json.load(f)["records"]
    got = _replay_port(tool)
    assert len(got) == len(golden)
    for g, w in zip(got, golden):
        assert g == w, f"digest mismatch at {w}"


# ---------------------------------------------------------------------------
# The test_batched properties, against the copied spec.

def _spec_grouped(state, ops, keys, m):
    rets = [None] * len(ops)
    for grp in (OP_DELETE, OP_INSERT, OP_LOOKUP):
        for b, (o, k) in enumerate(zip(ops, keys)):
            if o != grp:
                continue
            if o == OP_INSERT and k not in state and len(state) >= m:
                rets[b] = RET_ABORT
                continue
            state, r = step_spec(state, o, k)
            rets[b] = r
    return state, rets


def _table_keys(ht):
    k = ht.table.numpy() >> 2
    return set(int(x) for x in k[k != TE.RESERVED_KEY])


@pytest.mark.parametrize("seed", range(6))
def test_apply_batch_matches_spec(seed):
    """apply_batch == the documented sequential serialization, with ABORT
    exactly when the table has no room; counters track the cells."""
    m = 16
    rng = np.random.default_rng(seed)
    ht = TBT.create(m, seed=seed, device="cpu")
    state = set()
    for _ in range(int(rng.integers(2, 6))):
        n = int(rng.integers(1, 24))
        ops = rng.integers(0, 3, size=n)
        keys = rng.integers(0, 20, size=n)
        ht, ret = TBT.apply_batch(ht, torch.from_numpy(ops.astype(np.int32)),
                                  tkeys(keys))
        state, expect = _spec_grouped(state, list(ops), list(keys), m)
        assert list(ret.numpy()) == expect
        assert _table_keys(ht) == state
        assert int(ht.num_keys) == len(state)
        assert int(ht.num_tombs) == int((ht.table == TE.TOMBSTONE).sum())


def test_roundtrip_duplicates_and_reuse():
    """Insert/lookup/delete round trip; exactly one of a batch of equal
    keys wins (the lowest index); churn reuses tombstones and never
    aborts."""
    ht = TBT.create(64, seed=1, device="cpu")
    keys = torch.arange(10)
    ht, ret = TBT.insert_batch(ht, keys)
    assert (ret == RET_TRUE).all()
    assert TBT.lookup_batch(ht, keys).all()
    assert not TBT.lookup_batch(ht, torch.arange(100, 110)).any()
    ht, ret = TBT.delete_batch(ht, keys[:5])
    present = TBT.lookup_batch(ht, keys)
    assert not present[:5].any() and present[5:].all()
    assert int(ht.num_keys) == 5 and int(ht.num_tombs) == 5
    d = TBT.create(16, device="cpu")
    d, ret = TBT.insert_batch(d, torch.tensor([7, 7, 7, 7]))
    assert ret.tolist() == [1, 0, 0, 0] and int(d.num_keys) == 1
    small = TBT.create(8, device="cpu")
    for i in range(9):
        k = torch.tensor([1000 + i])
        small, r = TBT.insert_batch(small, k)
        assert int(r[0]) == RET_TRUE
        small, _ = TBT.delete_batch(small, k)


def test_unported_strategies_raise():
    """Every strategy of the reference is ported now: robinhood and
    hopscotch build working tables and facades (never a linear stand-in:
    hopscotch carries its bitmap), and only a name the reference does not
    know raises, with the reference's ValueError."""
    for name in ("robinhood", "hopscotch"):
        assert get_strategy(name).name == name
        ht = TBT.create(8, strategy=name, device="cpu")
        assert ht.meta.numel() == (8 if name == "hopscotch" else 0)
        assert TPT.PageTable(name).strategy == name
    with pytest.raises(ValueError):
        get_strategy("cuckoo")
    with pytest.raises(ValueError):
        TBT.create(8, strategy="cuckoo", device="cpu")


def test_cuda_request_without_card_raises():
    """Entry points run on the card unless asked for the CPU; without a
    card they raise instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TBT.create(8)
