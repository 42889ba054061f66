"""The port's probe strategies (``repro_torch.core.probe_strategies``) and
the no-reuse baseline against the JAX package.

Each strategy of the port runs the same numpy batches, made from a seed,
as the JAX one; table cells (as uint32), ``meta`` (as uint32), counters and
return codes must be equal after every batch.  Then the analogs of every
case of ``tests/test_probe_strategies.py`` run on the port alone, plus
hopscotch's bit 31 (a key 31 cells from home: the int32 carrier's sign
bit), robinhood's int32 priority bound, and the Gao no-reuse baseline.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as JBT
from repro.core.baselines import gao_noreuse as JGN
from repro.core.probe_strategies import get_strategy as j_get_strategy
from repro.serving import page_table as JPT
from repro_torch.core import batched as TBT
from repro_torch.core import encoding as TE
from repro_torch.core.baselines import gao_noreuse as TGN
from repro_torch.core.linearizability import check_history
from repro_torch.core.probe_strategies import (H_NEIGHBORHOOD, STRATEGIES,
                                               get_strategy)
from repro_torch.core.spec import (OP_DELETE, OP_INSERT, OP_LOOKUP,
                                   RET_ABORT, RET_TRUE, step_spec)
from repro_torch.serving import page_table as TPT

# small tensors: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

ALL = sorted(STRATEGIES)


def u32(t) -> np.ndarray:
    return np.asarray(t).astype(np.int64).astype(np.uint32)


def tkeys(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def assert_same(j, t):
    """Cells, meta (as uint32), counters and seed bit for bit."""
    np.testing.assert_array_equal(np.asarray(j.table), u32(t.table))
    np.testing.assert_array_equal(np.asarray(j.meta), u32(t.meta))
    assert int(j.num_keys) == int(t.num_keys)
    assert int(j.num_tombs) == int(t.num_tombs)
    assert int(j.seed) == int(t.seed)


def table_keys(ht):
    k = ht.table.numpy() >> 2
    return set(int(x) for x in k[k != TE.RESERVED_KEY])


def home_of(ht, key):
    return int(TBT._hash(ht, torch.tensor([key]))[0])


def check_hopscotch_meta(ht):
    """Both directions of the bitmap invariant: bit d of meta[h] is set iff
    cell (h+d)%m holds a key homed at h."""
    tab = ht.table.numpy()
    meta = u32(ht.meta)
    m = tab.size
    Hn = min(H_NEIGHBORHOOD, m)
    for h in range(m):
        w = int(meta[h])
        assert w >> Hn == 0, f"meta[{h}] has bits beyond the neighbourhood"
        for d in range(Hn):
            if (w >> d) & 1:
                j = (h + d) % m
                assert tab[j] != TE.EMPTY, (h, d, "bit set on EMPTY cell")
                assert home_of(ht, int(tab[j]) >> 2) == h
    for j in range(m):
        if tab[j] == TE.EMPTY:
            continue
        assert tab[j] != TE.TOMBSTONE, "hopscotch table holds a TOMBSTONE"
        h = home_of(ht, int(tab[j]) >> 2)
        d = (j - h) % m
        assert d < Hn, (j, h, "resident outside its home neighbourhood")
        assert (int(meta[h]) >> d) & 1, (j, h, "home bit missing")


def spec_apply_grouped(state, ops, keys, m):
    """deletes < inserts < lookups, each by batch index; ABORT when the
    table has no room (exact for hopscotch when m <= H)."""
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


# ---------------------------------------------------------------------------
# Bit for bit against the JAX strategies.

@pytest.mark.parametrize("m", [16, 64, 256])
@pytest.mark.parametrize("strategy", ALL)
def test_strategy_bitwise_against_reference(strategy, m):
    """apply_batch churn with duplicate keys and inactive lanes, then the
    strategy's own find/insert/delete and a rebuild: same cells, meta,
    counters and returns after every batch (m = 64 and 256 exceed the
    neighbourhood, so hopscotch displaces)."""
    rng = np.random.default_rng(m + len(strategy))
    j = JBT.create(m, seed=3, strategy=strategy)
    t = TBT.create(m, seed=3, strategy=strategy, device="cpu")
    assert_same(j, t)
    for _ in range(10):
        # few distinct batch sizes: each compiles the eager JAX loops once
        B = int(rng.choice([8, 16, 32]))
        ops = rng.integers(0, 3, size=B).astype(np.int32)
        keys = rng.integers(0, 3 * m, size=B).astype(np.uint32)
        j, rj = JBT.apply_batch(j, jnp.asarray(ops), jnp.asarray(keys),
                                strategy=strategy)
        t, rt = TBT.apply_batch(t, torch.from_numpy(ops), tkeys(keys),
                                strategy=strategy)
        assert_same(j, t)
        np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
    ji, ti = j_get_strategy(strategy), get_strategy(strategy)
    dup = np.repeat(rng.integers(3 * m, 4 * m, size=6), 3).astype(np.uint32)
    act = rng.random(dup.size) < 0.8
    j, rj = ji.insert_batch(j, jnp.asarray(dup), jnp.asarray(act))
    t, rt = ti.insert_batch(t, tkeys(dup), torch.from_numpy(act))
    assert_same(j, t)
    np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
    probe = rng.integers(0, 4 * m, size=48).astype(np.uint32)
    fj, sj = ji.find_batch(j, jnp.asarray(probe))
    ft, st = ti.find_batch(t, tkeys(probe))
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    j, rj = ji.delete_batch(j, jnp.asarray(probe[::2]))
    t, rt = ti.delete_batch(t, tkeys(probe[::2]))
    assert_same(j, t)
    np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
    assert_same(JBT.rebuild(j, 2 * m, 5, strategy=strategy),
                TBT.rebuild(t, 2 * m, 5, strategy=strategy))


def _keys_homed_at(ht, home, n, lo=0):
    """The first ``n`` keys from ``lo`` whose home bucket is ``home``."""
    cand = torch.arange(lo, lo + 200000)
    hv = TBT._hash(ht, cand)
    return cand[hv == home][:n].numpy()


def test_hopscotch_bit31_sign_bit():
    """32 keys homed at one bucket fill its whole neighbourhood: the last
    lands 31 cells from home and sets bit 31 (the int32 word is negative).
    Insert, find, and a delete batch clearing bit 31 together with other
    bits of the same word — each bit for bit the reference's."""
    m = 128
    j = JBT.create(m, seed=1, strategy="hopscotch")
    t = TBT.create(m, seed=1, strategy="hopscotch", device="cpu")
    home = 40
    keys = _keys_homed_at(t, home, 32).astype(np.uint32)
    assert keys.size == 32
    S = get_strategy("hopscotch")
    JS = j_get_strategy("hopscotch")
    j, rj = JS.insert_batch(j, jnp.asarray(keys))
    t, rt = S.insert_batch(t, tkeys(keys))
    assert_same(j, t)
    assert (rt == RET_TRUE).all()
    assert int(t.meta[home]) < 0 and int(u32(t.meta)[home]) == 0xFFFFFFFF
    f, s = S.find_batch(t, tkeys(keys))
    assert f.all() and int(s[-1]) == (home + 31) % m
    check_hopscotch_meta(t)
    # a 33rd key homed there hops: its neighbourhood is full
    extra = _keys_homed_at(t, home, 1, lo=int(keys.max()) + 1)
    j, rj = JS.insert_batch(j, jnp.asarray(extra.astype(np.uint32)))
    t, rt = S.insert_batch(t, tkeys(extra))
    assert_same(j, t)
    np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
    drop = keys[[0, 5, 31]]
    j, rj = JS.delete_batch(j, jnp.asarray(drop))
    t, rt = S.delete_batch(t, tkeys(drop))
    assert_same(j, t)
    assert (rt == 1).all() and int(t.meta[home]) >= 0
    check_hopscotch_meta(t)
    assert TBT.ROUND_STATS["hops"] > 0


def test_robinhood_priority_bound_raises_like_reference():
    """m * B must stay below 2^31 (the int32 priority key): both sides
    assert on m = 2^20 with 2048 keys and accept 2047."""
    m = 1 << 20
    keys = np.arange(2048, dtype=np.uint32)
    j = JBT.create(m, strategy="robinhood")
    t = TBT.create(m, strategy="robinhood", device="cpu")
    with pytest.raises(AssertionError, match="overflows int32"):
        JBT.insert_batch(j, jnp.asarray(keys), strategy="robinhood")
    with pytest.raises(AssertionError, match="overflows int32"):
        TBT.insert_batch(t, tkeys(keys), strategy="robinhood")
    t, ret = TBT.insert_batch(t, tkeys(keys[:2047]), strategy="robinhood")
    assert (ret == RET_TRUE).all() and int(t.num_keys) == 2047


def test_gao_noreuse_baseline_against_reference():
    """test_batched's churn: the reuse table never aborts; the no-reuse
    baseline fills with tombstones, aborts and needs a rebuild at 0.9;
    rebuild drops the tombstones — each state bit for bit the
    reference's."""
    m = 8
    jg, tg = JGN.create(m), TGN.create(m, device="cpu")
    ht = TBT.create(m, device="cpu")
    aborted = False
    for step in range(m + 1):
        k = np.array([1000 + step], np.uint32)
        ht, r = TBT.insert_batch(ht, tkeys(k))
        assert int(r[0]) == RET_TRUE
        ht, _ = TBT.delete_batch(ht, tkeys(k))
        if aborted:
            continue
        jg, rj = JGN.insert_batch(jg, jnp.asarray(k))
        tg, rt = TGN.insert_batch(tg, tkeys(k))
        assert_same(jg, tg)
        assert int(rj[0]) == int(rt[0])
        aborted = int(rt[0]) == RET_ABORT
        if not aborted:
            jg, _ = JGN.delete_batch(jg, jnp.asarray(k))
            tg, _ = TGN.delete_batch(tg, tkeys(k))
            assert_same(jg, tg)
    assert aborted
    assert bool(TGN.needs_rebuild(tg, slack=0.9)) \
        == bool(JGN.needs_rebuild(jg, slack=0.9)) is True
    jr, tr = JGN.rebuild(jg), TGN.rebuild(tg)
    assert_same(jr, tr)
    assert int(tr.num_tombs) == 0 and not bool(TGN.needs_rebuild(tr))


# ---------------------------------------------------------------------------
# Analogs of tests/test_probe_strategies.py on the port.

@pytest.mark.parametrize("strategy", ALL)
def test_roundtrip(strategy):
    impl = get_strategy(strategy)
    ht = TBT.create(64, seed=1, strategy=strategy, device="cpu")
    keys = torch.arange(10)
    ht, ret = impl.insert_batch(ht, keys)
    assert (ret == RET_TRUE).all()
    found, slots = impl.find_batch(ht, keys)
    assert found.all() and (slots >= 0).all()
    miss, _ = impl.find_batch(ht, torch.arange(100, 110))
    assert not miss.any()
    ht, ret = impl.delete_batch(ht, keys[:5])
    assert (ret == 1).all()
    present, _ = impl.find_batch(ht, keys)
    assert not present[:5].any() and present[5:].all()
    assert int(ht.num_keys) == 5
    if impl.uses_tombstones:
        assert int(ht.num_tombs) == 5
    else:
        assert int(ht.num_tombs) == 0
        check_hopscotch_meta(ht)


@pytest.mark.parametrize("strategy", ALL)
def test_duplicate_inserts_one_winner(strategy):
    impl = get_strategy(strategy)
    ht = TBT.create(16, strategy=strategy, device="cpu")
    ht, ret = impl.insert_batch(ht, torch.tensor([7, 7, 7, 7]))
    assert ret.tolist() == [1, 0, 0, 0]
    assert int(ht.num_keys) == 1
    assert int(((ht.table >> 2) == 7).sum()) == 1


@pytest.mark.parametrize("strategy", ALL)
def test_apply_batch_matches_spec(strategy):
    """apply_batch == the documented serialization (m = 16 <= H keeps the
    spec's ABORT condition exact for hopscotch too)."""
    m = 16
    rng = np.random.default_rng(7)
    for seed in range(3):
        ht = TBT.create(m, seed=seed, strategy=strategy, device="cpu")
        state = set()
        for _ in range(8):
            B = int(rng.integers(1, 24))
            ops = rng.integers(0, 3, size=B).astype(np.int32)
            keys = rng.integers(0, 10, size=B)
            ht, ret = TBT.apply_batch(ht, torch.from_numpy(ops), tkeys(keys),
                                      strategy=strategy)
            state, expect = spec_apply_grouped(state, list(ops), list(keys),
                                               m)
            assert ret.tolist() == expect, (strategy, seed, ops, keys)
        assert table_keys(ht) == state
        assert int(ht.num_keys) == len(state)


@pytest.mark.parametrize("strategy", ALL)
def test_linearizable_history(strategy):
    """Each batch is one concurrent window; the history must be
    linearizable per the locality-theorem checker."""
    rng = np.random.default_rng(3)
    ht = TBT.create(16, seed=2, strategy=strategy, device="cpu")
    rows = []
    for step in range(10):
        ops = rng.integers(0, 3, size=8).astype(np.int32)
        keys = rng.integers(0, 8, size=8)
        ht, ret = TBT.apply_batch(ht, torch.from_numpy(ops), tkeys(keys),
                                  strategy=strategy)
        for b in range(8):
            rows.append((b, step, int(ops[b]), int(keys[b]), int(ret[b]),
                         2 * step, 2 * step + 1))
    ok, bad = check_history(rows)
    assert ok, f"{strategy}: non-linearizable keys {bad}"


@pytest.mark.parametrize("strategy", ALL)
def test_counts_track_state(strategy):
    rng = np.random.default_rng(5)
    ht = TBT.create(128, seed=2, strategy=strategy, device="cpu")
    for _ in range(8):
        ks = tkeys(rng.integers(0, 60, size=32))
        ops = torch.from_numpy(rng.integers(0, 3, size=32).astype(np.int32))
        ht, _ = TBT.apply_batch(ht, ops, ks, strategy=strategy)
    assert int(ht.num_keys) == len(table_keys(ht))
    assert int(ht.num_tombs) == int((ht.table == TE.TOMBSTONE).sum())
    if strategy == "hopscotch":
        assert int(ht.num_tombs) == 0
        check_hopscotch_meta(ht)


def test_hopscotch_displacement_churn():
    """m > H: under heavy churn the table stays tombstone-free, counters
    exact, every live key found, the bitmap invariant holds both ways, and
    every batch is the reference's."""
    impl, jimpl = get_strategy("hopscotch"), j_get_strategy("hopscotch")
    m = 64
    assert m > H_NEIGHBORHOOD
    rng = np.random.default_rng(11)
    ht = TBT.create(m, seed=4, strategy="hopscotch", device="cpu")
    j = JBT.create(m, seed=4, strategy="hopscotch")
    live = set()
    for _ in range(25):
        ks = rng.integers(0, 96, size=16)
        ins = rng.random(16) < 0.6
        ht, ret = impl.insert_batch(ht, tkeys(ks), torch.from_numpy(ins))
        j, rj = jimpl.insert_batch(j, jnp.asarray(ks.astype(np.uint32)),
                                   jnp.asarray(ins))
        np.testing.assert_array_equal(np.asarray(rj), ret.numpy())
        for b in range(16):
            if ins[b] and int(ret[b]) == 1:
                live.add(int(ks[b]))
        dk = rng.integers(0, 96, size=8)
        ht, dret = impl.delete_batch(ht, tkeys(dk))
        j, _ = jimpl.delete_batch(j, jnp.asarray(dk.astype(np.uint32)))
        for b in range(8):
            if int(dret[b]) == 1:
                live.discard(int(dk[b]))
        assert int(ht.num_tombs) == 0
        assert_same(j, ht)
    assert table_keys(ht) == live
    assert int(ht.num_keys) == len(live)
    found, _ = impl.find_batch(ht, torch.tensor(sorted(live)))
    assert found.all()
    check_hopscotch_meta(ht)


@pytest.mark.parametrize("strategy", ALL)
def test_facade_alloc_free_cycle(strategy):
    """alloc -> lookup -> free -> re-alloc through the page-table facade,
    each step bit for bit the JAX facade's."""
    pt, jpt = TPT.for_strategy(strategy), JPT.for_strategy(strategy)
    B, psize, maxP = 4, 2, 4
    table = pt.create_table(32, seed=1, device="cpu")
    jt = jpt.create_table(32, seed=1)
    seq = torch.arange(B, dtype=torch.int32)
    bt = torch.full((B, maxP), -1, dtype=torch.int32)
    jbt = jnp.full((B, maxP), -1, jnp.int32)
    pos = torch.zeros((B,), dtype=torch.int32)
    for _ in range(psize * maxP):
        st, bt = pt.alloc_step_incremental(table, seq, pos, bt,
                                           page_size=psize)
        jst, jbt = jpt.alloc_step_incremental(
            jt, jnp.asarray(seq.numpy()), jnp.asarray(pos.numpy()), jbt,
            page_size=psize)
        table, jt = st.table, jst.table
        assert_same(jt, table)
        np.testing.assert_array_equal(np.asarray(jbt), bt.numpy())
        assert not st.aborted.any() and (st.write_slot >= 0).all()
        pos = pos + 1
    rows = pt.lookup_pages(table, seq, pos, page_size=psize, max_pages=maxP)
    assert (rows >= 0).all()
    assert int(pt.verify_block_table(table, seq, pos, bt,
                                     page_size=psize)) == 0
    table = pt.free_sequences(table, seq, pos, page_size=psize,
                              max_pages=maxP)
    jt = jpt.free_sequences(jt, jnp.asarray(seq.numpy()),
                            jnp.asarray(pos.numpy()), page_size=psize,
                            max_pages=maxP)
    assert_same(jt, table)
    hr = pt.headroom(table)
    assert hr == jpt.headroom(jt)
    assert hr.live_pages == 0 and hr.free_cells == hr.n_pages
    assert hr.strategy == strategy
    if strategy == "hopscotch":
        assert hr.tombstones == 0


def test_headroom_slack_per_strategy():
    assert TPT.for_strategy("linear").forecast_slack(256) == 0
    assert TPT.for_strategy("robinhood").forecast_slack(256) == 0
    hop = TPT.for_strategy("hopscotch")
    assert hop.forecast_slack(H_NEIGHBORHOOD) == 0
    assert hop.forecast_slack(256) == H_NEIGHBORHOOD
    table = hop.create_table(256, device="cpu")
    assert hop.headroom(table).slack == H_NEIGHBORHOOD
    assert hop.headroom(table) == JPT.for_strategy("hopscotch").headroom(
        JPT.for_strategy("hopscotch").create_table(256))


def test_unknown_strategy_rejected():
    with pytest.raises(ValueError, match="unknown probe strategy"):
        get_strategy("quadratic")
    with pytest.raises(ValueError, match="unknown probe strategy"):
        TPT.PageTable("quadratic")
    with pytest.raises(ValueError, match="unknown probe strategy"):
        TBT.create(8, strategy="quadratic", device="cpu")


def test_probe_kernel_guard():
    """K3 serves exactly the linear-order strategies: robinhood is
    accepted (its lookups are the linear scan), hopscotch raises as the
    reference does."""
    from repro_torch.kernels.probe import ops as PK
    ht = TBT.create(64, strategy="linear", device="cpu")
    keys = torch.arange(4)
    for use_kernel in (False, True):
        found, _ = PK.probe_lookup(ht, keys, use_kernel=use_kernel,
                                   strategy="robinhood")
        assert not found.any()
        with pytest.raises(ValueError, match="linear order"):
            PK.probe_lookup(ht, keys, use_kernel=use_kernel,
                            strategy="hopscotch")
