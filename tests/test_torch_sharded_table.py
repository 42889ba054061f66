"""The port's sharded page table (``repro_torch.dist.table_shard``,
``repro_torch.serving.sharded_table``, ``serving.sched.router``) against
the JAX package: analogs of ``tests/test_sharded_table.py``, its sharded
checkpoint included (each shard's saved key set equal to the reference's).

Routing is held owner for owner, the lazy resize round by round (each
round's ``found`` array equal to the JAX shard's, tables bit for bit), and
the small multi-host storm summary for summary against the reference's
``tests/_multihost.py``.
"""
from __future__ import annotations

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _multihost as MH
from repro.dist import table_shard as JTS
from repro.serving.sched import synthetic_workload as j_workload
from repro_torch.core import batched as BT
from repro_torch.core import encoding as E
from repro_torch.dist import table_shard as TS
from repro_torch.launch import shard_soak as SOAK
from repro_torch.obs import counters as OC
from repro_torch.serving import page_table as PT
from repro_torch.serving.sched import synthetic_workload
from repro_torch.serving.sharded_table import (ShardedPageTable,
                                               checkpoint_sharded,
                                               plan_table_shards,
                                               restore_sharded_table)

# small tensors: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

CPU = dict(device="cpu")


def u32(t) -> np.ndarray:
    return np.asarray(t).astype(np.int64).astype(np.uint32)


def tk(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def same_table(j, t, meta=True):
    np.testing.assert_array_equal(np.asarray(j.table), u32(t.table))
    if meta:
        np.testing.assert_array_equal(np.asarray(j.meta), u32(t.meta))
    assert int(j.num_keys) == int(t.num_keys)
    assert int(j.num_tombs) == int(t.num_tombs)


# --- manifest routing ------------------------------------------------------

def test_manifest_balanced_routing():
    man = TS.ShardManifest.balanced(4)
    seqs = np.arange(1, 1025, dtype=np.uint32)
    owners = man.owner_of_seq(seqs)
    counts = np.bincount(owners, minlength=4)
    assert counts.sum() == 1024 and (counts > 128).all(), counts
    assert (man.owner_of_seq(seqs) == owners).all()
    # owner for owner the reference's, prefixes included
    np.testing.assert_array_equal(
        owners, JTS.ShardManifest.balanced(4).owner_of_seq(seqs))
    big = np.random.default_rng(0).integers(0, 2**32, 4096,
                                            dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(TS.seq_prefix(big, 6),
                                  np.asarray(JTS.seq_prefix(big, 6)))


def test_manifest_reassign_keeps_survivor_prefixes():
    man = TS.ShardManifest.balanced(4)
    new = man.reassign(2)
    assert 2 not in new.live_shards() and new.live_shards() == (0, 1, 3)
    for p, o in enumerate(man.owners):
        if o != 2:
            assert new.owners[p] == o
        else:
            assert new.owners[p] in (0, 1, 3)
    assert new.owners == JTS.ShardManifest.balanced(4).reassign(2).owners
    last = new.reassign(0).reassign(1)
    assert last.live_shards() == (3,)
    with pytest.raises(ValueError):
        last.reassign(3)


def test_manifest_json_roundtrip():
    man = TS.ShardManifest.balanced(3).reassign(1)
    back = TS.ShardManifest.from_json(man.to_json())
    assert back == man
    assert man.to_json() == JTS.ShardManifest.balanced(3).reassign(1).to_json()


def test_plan_table_shards():
    class FakeMesh:
        def __init__(self, shape):
            self.shape = shape
    assert plan_table_shards(FakeMesh({"pod": 2, "data": 16})) == 2
    assert plan_table_shards(FakeMesh({"data": 16, "model": 16})) == 1
    assert plan_table_shards(object()) == 1


# --- lazy incremental resize ----------------------------------------------

def _trace_replay(TSmod, grow_at, strategy, port):
    """One shard through a deterministic mixed op trace, growing lazily at
    round ``grow_at`` (None = never, big table from the start).  Returns
    each round's lookup answers over a fixed probe set, the number of
    rounds a migration was in flight, and the final shard."""
    rng = np.random.default_rng(7)
    m0 = 256 if grow_at is None else 64
    kw = CPU if port else {}
    shard = TSmod.TableShard.create(0, m0, seed=3, strategy=strategy, **kw)
    arr = tk if port else (lambda a: jnp.asarray(a, jnp.uint32))
    universe = rng.choice(4096, size=96, replace=False).astype(np.uint32)
    live: set = set()
    founds, shards = [], []
    migrating_rounds = 0
    for rnd in range(14):
        if rnd == grow_at:
            shard = shard.begin_migration(256)
        fresh = [k for k in universe if k not in live][:6]
        shard, ret, _ = shard.insert(arr(fresh))
        assert not int(np.asarray(ret == 2).sum()), "unexpected ABORT"
        live |= set(int(k) for k in fresh)
        drops = rng.choice(sorted(live), size=3, replace=False)
        shard, _, _ = shard.delete(arr(drops))
        live -= set(int(k) for k in drops)
        shard, _ = shard.sweep_migrate(8)
        migrating_rounds += int(shard.migrating)
        found, _, _ = shard.find(arr(universe))
        found = np.asarray(found)
        assert set(universe[found].tolist()) == live
        founds.append(found)
        shards.append(shard)
    return founds, migrating_rounds, shards


def _hopscotch_membership(ht) -> np.ndarray:
    """The neighbourhood bitmap recomputed from a hopscotch table's cells
    (uint32 words)."""
    tab = ht.table.numpy()
    m = tab.size
    idx = np.nonzero(tab != E.EMPTY)[0]
    home = BT._hash(ht, tk(tab[idx] >> 2)).numpy()
    meta = np.zeros(m, np.uint64)
    np.add.at(meta, home, np.uint64(1) << ((idx - home) % m).astype(
        np.uint64))
    return meta.astype(np.uint32)


@pytest.mark.parametrize("strategy", ["linear", "hopscotch"])
def test_lazy_resize_recorded_trace_parity(strategy):
    """Lookups answer identically throughout the migration: the lazily
    growing shard's per-round answers equal those of a shard with full
    capacity from round 0, and each round's answers, tables and counters
    equal the JAX shard's.  Under hopscotch the old table's meta stays its
    true neighbourhood bitmap: the port sets no marker bits there (the
    reference ORs them into the bitmap, ROADMAP §3)."""
    lazy, mig_rounds, shards = _trace_replay(TS, 2, strategy, True)
    eager, _, _ = _trace_replay(TS, None, strategy, True)
    ref, ref_rounds, jshards = _trace_replay(JTS, 2, strategy, False)
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in lazy] == \
        [hashlib.sha256(f.tobytes()).hexdigest() for f in eager]
    for rnd, (f, g) in enumerate(zip(lazy, ref)):
        np.testing.assert_array_equal(f, g, err_msg=f"round {rnd}")
    assert mig_rounds == ref_rounds and mig_rounds >= 3
    assert not shards[-1].migrating
    for t, j in zip(shards, jshards):
        same_table(j.table, t.table)
        assert (t.old is None) == (j.old is None)
        assert (t.cursor, t.migrated) == (j.cursor, j.migrated)
        if t.old is not None:
            same_table(j.old, t.old, meta=strategy != "hopscotch")
            if strategy == "hopscotch":
                np.testing.assert_array_equal(u32(t.old.meta),
                                              _hopscotch_membership(t.old))


def test_migration_headroom_invariant():
    """``free_cells = m_new - live_new - live_old`` through the whole
    migration, and inserting exactly ``free_cells`` fresh keys never
    ABORTs."""
    shard = TS.TableShard.create(0, 32, seed=1, **CPU)
    shard, _, _ = shard.insert(torch.arange(100, 120))
    shard = shard.begin_migration(64)
    assert shard.free_cells() == 64 - 20
    fresh = iter(range(200, 400))
    while shard.migrating:
        shard, _ = shard.sweep_migrate(4)
        shard, ret, _ = shard.insert(torch.tensor([next(fresh)
                                                   for _ in range(2)]))
        assert not bool((ret == 2).any())
        live_new = int(shard.table.num_keys)
        live_old = 0 if shard.old is None else int(shard.old.num_keys)
        assert shard.free_cells() == 64 - live_new - live_old
    room = shard.free_cells()
    shard, ret, _ = shard.insert(torch.tensor([next(fresh)
                                               for _ in range(room)]))
    assert int((ret == 1).sum()) == room
    assert shard.free_cells() == 0


def test_moved_markers():
    """Every migrated entry leaves its marker — TOMBSTONE + meta bit for
    the metadata-free strategies, the EMPTY cell under hopscotch — and the
    marker words equal the reference's, including the bit of a slot with
    slot % 32 == 31 (the int32 carrier's sign bit)."""
    keys = np.arange(50, 110, dtype=np.uint32)
    shard = TS.TableShard.create(0, 64, seed=2, **CPU)
    jshard = JTS.TableShard.create(0, 64, seed=2)
    shard, _, _ = shard.insert(tk(keys))
    jshard, _, _ = jshard.insert(jnp.asarray(keys))
    shard, jshard = shard.begin_migration(128), jshard.begin_migration(128)
    _, old_slots = BT.find_batch(shard.old, tk(keys))
    old_slots = old_slots.numpy()
    sign = np.nonzero(old_slots % 32 == 31)[0]
    assert sign.size, "no key sits in a slot with slot % 32 == 31"
    first = np.concatenate([sign, [i for i in range(4) if i not in sign]])
    shard, moves = shard.migrate_keys(tk(keys[first]))
    jshard, jmoves = jshard.migrate_keys(jnp.asarray(keys[first]))
    assert moves.n == first.size == jmoves.n
    np.testing.assert_array_equal(moves.old_slots, jmoves.old_slots)
    np.testing.assert_array_equal(moves.new_slots, jmoves.new_slots)
    same_table(jshard.old, shard.old)
    tab, meta = shard.old.table.numpy(), u32(shard.old.meta)
    for s in old_slots[first]:
        assert tab[s] == E.TOMBSTONE
        assert meta[s // 32] & (1 << (s % 32))
    assert (shard.old.meta < 0).any()       # bit 31 lands as the sign bit
    rest = [i for i in range(keys.size) if i not in set(first.tolist())]
    for s in old_slots[rest]:               # unmigrated: no marker yet
        assert not (meta[s // 32] & (1 << (s % 32)))

    hop = TS.TableShard.create(0, 32, seed=2, strategy="hopscotch", **CPU)
    hop, _, _ = hop.insert(tk(keys[:10]))
    hop = hop.begin_migration(64)
    _, hslots = BT.find_batch(hop.old, tk(keys[:10]), strategy="hopscotch")
    hop, moves = hop.migrate_keys(tk(keys[:4]))
    assert moves.n == 4
    tab = hop.old.table.numpy()
    assert all(tab[s] == E.EMPTY for s in hslots.numpy()[:4])
    np.testing.assert_array_equal(u32(hop.old.meta),
                                  _hopscotch_membership(hop.old))


def test_migration_moves_carry_pages():
    """Applying the (src, dst) moves to a shadow page map keeps every
    key's page at the slot ``find`` reports; host counters note them."""
    shard = TS.TableShard.create(0, 64, seed=5, **CPU)
    keys = torch.arange(300, 340)
    shard, _, _ = shard.insert(keys)
    _, slots = BT.find_batch(shard.table, keys)
    old_pages = {int(s): int(k) for s, k in zip(slots, keys)}
    shard = shard.begin_migration(128)
    new_pages: dict = {}
    with OC.host_counters_scope() as hc:
        while shard.migrating:
            shard, mv = shard.sweep_migrate(8)
            for src, dst in zip(mv.old_slots, mv.new_slots):
                new_pages[int(dst)] = old_pages.pop(int(src))
        assert hc["migration_moved"] == 40
    assert not old_pages and len(new_pages) == 40
    found, slots, in_old = shard.find(keys)
    assert found.all() and not in_old.any()
    for s, k in zip(slots, keys):
        assert new_pages[int(s)] == int(k)


# --- the routed facade -----------------------------------------------------

def test_sharded_alloc_routes_to_owners():
    spt = ShardedPageTable(4, 32, page_size=4, max_pages=8, **CPU)
    seqs = np.arange(1, 13, dtype=np.uint32)
    owners = spt.owner_of_seq(seqs)
    ws, ab, moves = spt.alloc_step(seqs, np.zeros(12, np.int64))
    assert not moves and not ab.any() and (ws >= 0).all()
    assert np.unique(ws).size == 12
    for slot, sid in zip(ws, owners):
        st = spt._shards[int(sid)]
        assert st.cur.start <= slot < st.cur.start + st.cur.size
    for sid in spt.live_shards():
        h = spt.headroom(sid)
        assert h.free_cells == 32 - h.live_pages and h.strategy == "linear"


def test_sharded_lose_shard_reroutes():
    spt = ShardedPageTable(3, 32, page_size=4, max_pages=8, **CPU)
    seqs = np.arange(1, 10, dtype=np.uint32)
    spt.alloc_step(seqs, np.zeros(9, np.int64))
    lost = spt.live_shards()[-1]
    lost_live = spt._shards[lost].shard.live_pages()
    before = spt.total_live_pages()
    spt.lose_shard(lost)
    assert lost not in spt.live_shards()
    assert spt.total_live_pages() == before - lost_live
    assert lost not in set(spt.owner_of_seq(seqs).tolist())


def test_insert_keys_grow_and_health_match_reference():
    """Raw page keys routed to their owners (the restore path), a lazy
    grow with a service sweep, then counters, headroom, health and routed
    lookups — each equal to the JAX facade's."""
    from repro.serving.sharded_table import ShardedPageTable as JSPT
    keys = np.asarray([s * PT.MAX_LOGICAL_PAGES + p for s in range(1, 9)
                       for p in range(3)], np.uint32)
    spt = ShardedPageTable(3, 32, page_size=4, max_pages=4, **CPU)
    jspt = JSPT(3, 32, page_size=4, max_pages=4)
    assert spt.insert_keys(keys) == jspt.insert_keys(keys) == keys.size
    sid = spt.live_shards()[0]
    spt.grow_shard(sid, 64)
    jspt.grow_shard(sid, 64)
    assert spt.service_migration(4) == jspt.service_migration(4)
    assert spt.counters() == jspt.counters()
    assert spt.n_slots == jspt.n_slots and spt.migrating() == jspt.migrating()
    seqs, pos = np.arange(1, 9, dtype=np.uint32), np.full(8, 11, np.int64)
    np.testing.assert_array_equal(spt.lookup_pages(seqs, pos),
                                  jspt.lookup_pages(seqs, pos))
    for s in spt.live_shards():
        assert spt.headroom(s) == jspt.headroom(s)
        assert spt.health(s) == jspt.health(s)


def test_probe_stats_cover_routed_ops():
    PT.probe_stats_reset()
    spt = ShardedPageTable(2, 16, page_size=4, max_pages=4, **CPU)
    seqs = np.arange(1, 5, dtype=np.uint32)
    spt.alloc_step(seqs, np.zeros(4, np.int64))
    spt.lookup_pages(seqs, np.zeros(4, np.int64))
    assert PT.PROBE_STATS["keys_probed"] > 0
    PT.probe_stats_reset()


# --- sharded checkpoint ----------------------------------------------------

def test_checkpoint_restore_other_shard_count(tmp_path):
    """Saved mid-migration, restored onto 2 and 3 shards: every live page
    re-homed, each sequence's block table whole.  Each shard's saved key
    set and extras equal the reference's on the same traffic."""
    from repro.serving import sharded_table as JST
    from repro.training import checkpoint as JCKPT
    from repro_torch.training import checkpoint as CKPT
    seqs = np.arange(1, 17, dtype=np.uint32)
    spt = ShardedPageTable(4, 48, page_size=4, max_pages=8, **CPU)
    jspt = JST.ShardedPageTable(4, 48, page_size=4, max_pages=8)
    for t in (spt, jspt):
        for pos in range(8):
            t.alloc_step(seqs, np.full(16, pos, np.int64))
        t.grow_shard(t.live_shards()[0], 96)   # save MID-migration
    n_live = spt.total_live_pages()
    checkpoint_sharded(spt, str(tmp_path / "port"), step=5)
    JST.checkpoint_sharded(jspt, str(tmp_path / "ref"), step=5)
    got, gman, _ = CKPT.restore_sharded(str(tmp_path / "port"))
    want, wman, _ = JCKPT.restore_sharded(str(tmp_path / "ref"))
    assert gman == wman and len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["_extra"] == w["_extra"]
        np.testing.assert_array_equal(g["keys"], w["keys"])

    for n_shards in (2, 3):
        back, step = restore_sharded_table(str(tmp_path / "port"), n_shards,
                                           96, page_size=4, max_pages=8,
                                           **CPU)
        assert step == 5 and back.total_live_pages() == n_live
        bt = back.lookup_pages(seqs, np.full(16, 7, np.int64))
        assert (bt[:, :2] >= 0).all() and (bt[:, 2:] == -1).all()


def test_checkpoint_recommit_after_remesh(tmp_path):
    """The re-save path: losing a shard after the commit re-commits the
    SAME step with the reassigned manifest (atomic shards.json replace)."""
    import json
    import os
    spt = ShardedPageTable(3, 32, page_size=4, max_pages=8, **CPU)
    spt.alloc_step(np.arange(1, 7, dtype=np.uint32), np.zeros(6, np.int64))
    checkpoint_sharded(spt, str(tmp_path), step=1)
    spt.lose_shard(spt.live_shards()[-1])
    path = checkpoint_sharded(spt, str(tmp_path), step=1)
    with open(path) as f:
        doc = json.load(f)
    man = TS.ShardManifest(int(doc["shard_manifest"]["prefix_bits"]),
                           tuple(doc["shard_manifest"]["owners"]))
    assert man == spt.manifest and len(man.live_shards()) == 2
    assert os.path.basename(path) == "shards.json"


# --- the simulated multi-host storm ---------------------------------------

@pytest.mark.parametrize("strategy", ["linear", "hopscotch"])
def test_multihost_storm_grow_and_loss(strategy):
    """Small edition of the shard soak: a 2x-overcommitted storm with a
    forced lazy resize and a host-group loss; every request completes, 0
    proactive aborts, shadow map and counters consistent (checked every
    other round) — and the summary equals the reference harness's."""
    kw = dict(hosts=2, pages_per_shard=24, slots_per_shard=3, page_size=4,
              max_len=16, megastep_k=4, fail_on_abort=True,
              strategy=strategy)
    load = dict(vocab_size=64, max_len=16, seed=0, prompt_len=(2, 4),
                max_new=(6, 10))
    run = dict(max_rounds=200, grow_round=1, lose_round=3)
    cluster = SOAK.SimCluster(**kw, **CPU)
    s = cluster.run_storm(synthetic_workload(10, **load), **run)
    assert int(s["completed"]) == int(s["submitted"]) == 10
    assert int(s["aborts_observed"]) == 0
    assert int(s["live_shards"]) == 1 and s["migrations_finished"] >= 1
    ref = MH.SimCluster(**kw).run_storm(j_workload(10, **load), **run)
    np.testing.assert_equal({k: s[k] for k in ref}, ref)   # NaN == NaN
