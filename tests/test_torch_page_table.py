"""The PyTorch port's page-table facade against the JAX facade, bit for bit,
under churn, exhaustion and abort (the analogues of the allocator tests in
tests/test_serving.py).  Every operation runs on both sides with the same
numpy inputs; tables, block tables, write slots and abort flags must be
equal after every step."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import page_table as JPT
from repro_torch.serving import page_table as TPT

# small tensors: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

J = JPT.for_strategy("linear")
T = TPT.for_strategy("linear")


def u32(t) -> np.ndarray:
    return np.asarray(t).astype(np.int64).astype(np.uint32)


def same_table(j, t):
    np.testing.assert_array_equal(np.asarray(j.table), u32(t.table))
    assert int(j.num_keys) == int(t.num_keys)
    assert int(j.num_tombs) == int(t.num_tombs)


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


class Twin:
    """One allocator state per side, driven with the same numpy inputs."""

    def __init__(self, n_pages, B, maxP, page_size, seed=0):
        self.j = J.create_table(n_pages, seed=seed)
        self.t = T.create_table(n_pages, seed=seed, device="cpu")
        self.bj = jnp.full((B, maxP), -1, jnp.int32)
        self.bt = torch.full((B, maxP), -1, dtype=torch.int32)
        self.ps, self.maxP = page_size, maxP
        # the reference side is jitted once per shape: eager while_loops
        # would recompile on every call
        kw = dict(page_size=page_size)
        self.j_alloc = jax.jit(functools.partial(J.alloc_step_incremental,
                                                 **kw))
        self.j_free = jax.jit(functools.partial(J.free_sequences,
                                                max_pages=maxP, **kw))
        self.j_lookup = jax.jit(functools.partial(J.lookup_pages,
                                                  max_pages=maxP, **kw))
        self.j_rebuild = jax.jit(functools.partial(J.rebuild_block_table,
                                                   max_pages=maxP))
        self.j_verify = jax.jit(functools.partial(J.verify_block_table,
                                                  **kw))

    def alloc(self, seq, pos, active=None):
        a = (jnp.ones(seq.shape, bool) if active is None
             else jnp.asarray(active))
        b = None if active is None else torch.from_numpy(active)
        (self.j, wj, abj), self.bj = self.j_alloc(
            self.j, jnp.asarray(seq), jnp.asarray(pos), self.bj, active=a)
        (self.t, wt, abt), self.bt = T.alloc_step_incremental(
            self.t, torch.from_numpy(seq), torch.from_numpy(pos), self.bt,
            page_size=self.ps, active=b)
        same_table(self.j, self.t)
        same(wj, wt)
        same(abj, abt)
        same(self.bj, self.bt)
        return wt.numpy(), abt.numpy()

    def free(self, seq, pos, mask):
        self.j = self.j_free(self.j, jnp.asarray(seq), jnp.asarray(pos),
                             active=jnp.asarray(mask))
        self.t = T.free_sequences(self.t, torch.from_numpy(seq),
                                  torch.from_numpy(pos), page_size=self.ps,
                                  max_pages=self.maxP,
                                  active=torch.from_numpy(mask))
        self.bj = J.invalidate_block_rows(self.bj, jnp.asarray(mask))
        self.bt = T.invalidate_block_rows(self.bt, torch.from_numpy(mask))
        same_table(self.j, self.t)
        same(self.bj, self.bt)

    def reads(self, seq, pos):
        same(self.j_lookup(self.j, jnp.asarray(seq), jnp.asarray(pos)),
             T.lookup_pages(self.t, torch.from_numpy(seq),
                            torch.from_numpy(pos), page_size=self.ps,
                            max_pages=self.maxP))
        same(self.j_rebuild(self.j, jnp.asarray(seq)),
             T.rebuild_block_table(self.t, torch.from_numpy(seq), self.maxP))
        vj = int(self.j_verify(self.j, jnp.asarray(seq), jnp.asarray(pos),
                               self.bj))
        vt = int(T.verify_block_table(self.t, torch.from_numpy(seq),
                                      torch.from_numpy(pos), self.bt,
                                      page_size=self.ps))
        assert vj == vt
        return vt


def test_churn_matches_reference_every_step():
    """Admit / decode / evict / re-admit churn (test_serving.py:300): the
    port's allocator state, block table and reads equal the reference's
    at every step, and the cache stays coherent with the lookup."""
    n_pages, B, ps, maxP = 64, 4, 4, 8
    rng = np.random.default_rng(0)
    tw = Twin(n_pages, B, maxP, ps, seed=1)
    seq = np.arange(B, dtype=np.int32)
    pos = np.zeros(B, np.int32)
    next_id = B
    for round_ in range(28):
        _, ab = tw.alloc(seq, pos)
        assert not ab.any()
        assert tw.reads(seq, pos) == 0
        pos = pos + 1
        if round_ % 7 == 6:
            mask = np.zeros(B, bool)
            mask[int(rng.integers(B))] = True
            tw.free(seq, pos, mask)
            seq = np.where(mask, next_id, seq).astype(np.int32)
            next_id += 1
            pos = np.where(mask, 0, pos).astype(np.int32)
    assert int(tw.t.num_tombs) > 0


def test_evict_readmit_invalidation_matches_reference():
    """test_serving.py:259: evicting a lane invalidates its row; the
    re-admitted lane reclaims tombstones; an un-invalidated row would
    disagree with the lookup — on both sides alike."""
    n_pages, B, ps, maxP = 16, 2, 2, 4
    tw = Twin(n_pages, B, maxP, ps)
    seq = np.arange(B, dtype=np.int32)
    for p in range(6):
        tw.alloc(seq, np.full(B, p, np.int32))
    stale = tw.bt[0].clone()
    tw.free(seq, np.full(B, 6, np.int32), np.array([True, False]))
    assert (tw.bt[0] == -1).all()
    seq = np.array([B, 1], np.int32)
    for p in range(6):
        ws, ab = tw.alloc(seq, np.full(B, p, np.int32))
        assert (ws >= 0).all() and not ab.any()
        assert tw.reads(seq, np.full(B, p, np.int32)) == 0
    bad = tw.bt.clone()
    bad[0] = stale
    assert int(T.verify_block_table(tw.t, torch.from_numpy(seq),
                                    torch.zeros(B, dtype=torch.int32), bad,
                                    page_size=ps)) > 0


def test_exhaustion_abort_and_tombstone_reclaim():
    """test_serving.py:444: fill the pool, the next boundary ABORTs every
    lane (write_slot -1, never wrapped), evicting half frees tombstones
    that the next allocations reclaim — bitwise the reference throughout,
    including inactive lanes that must not allocate."""
    n_pages, B, ps, maxP = 16, 4, 2, 16
    tw = Twin(n_pages, B, maxP, ps)
    seq = np.arange(B, dtype=np.int32)
    fill = (n_pages // B) * ps
    for p in range(fill):
        ws, ab = tw.alloc(seq, np.full(B, p, np.int32))
        assert (ws >= 0).all() and not ab.any()
    ws, ab = tw.alloc(seq, np.full(B, fill, np.int32))
    assert ab.all() and (ws == -1).all()
    tw.free(seq, np.full(B, fill, np.int32),
            np.array([True, True, False, False]))
    assert int(tw.t.num_tombs) == n_pages // 2
    seq = np.array([B, B + 1, 2, 3], np.int32)
    act = np.array([True, True, False, False])
    for p in range(fill):
        ws, ab = tw.alloc(seq, np.full(B, p, np.int32), active=act)
        assert (ws[:2] >= 0).all() and (ws[2:] == -1).all()
        assert not ab.any()
    assert int(tw.t.num_tombs) == 0


@pytest.mark.parametrize("new_pages,seed", [(32, None), (48, 5)])
def test_rehash_and_plain_alloc_match_reference(new_pages, seed):
    """Section 4.3 rehash (page permutation), the non-incremental
    alloc_step, prefill_alloc and the headroom view, bitwise."""
    n_pages, B, ps, maxP = 24, 3, 2, 8
    tw = Twin(n_pages, B, maxP, ps, seed=2)
    seq = np.arange(B, dtype=np.int32)
    for p in range(7):
        tw.alloc(seq, np.full(B, p, np.int32))
    tw.free(seq, np.full(B, 7, np.int32), np.array([False, True, False]))
    rj = J.rehash(tw.j, new_pages, seed)
    rt = T.rehash(tw.t, new_pages, seed)
    same_table(rj[0], rt[0])
    for a, b in zip(rj[1:], rt[1:]):
        same(a, b)
    pos = np.full(B, 7, np.int32)
    aj = J.alloc_step(tw.j, jnp.asarray(seq), jnp.asarray(pos), page_size=ps)
    at = T.alloc_step(tw.t, torch.from_numpy(seq), torch.from_numpy(pos),
                      page_size=ps)
    same_table(aj.table, at.table)
    same(aj.write_slot, at.write_slot)
    same(aj.aborted, at.aborted)
    lens = np.array([3, 0, 5], np.int32)
    fj, sj = J.prefill_alloc(rj[0], jnp.asarray(seq + 10), jnp.asarray(lens),
                             page_size=ps, max_pages=maxP)
    ft, st = T.prefill_alloc(rt[0], torch.from_numpy(seq + 10),
                             torch.from_numpy(lens), page_size=ps,
                             max_pages=maxP)
    same_table(fj, ft)
    same(sj, st)
    assert J.headroom(fj) == T.headroom(ft)
    assert J.probe_p99(fj) == T.probe_p99(ft)


def test_probe_stats_scope_nests():
    """PROBE_STATS scopes isolate and restore their counts."""
    table = T.create_table(16, device="cpu")
    with TPT.probe_stats_scope() as outer:
        T.lookup_pages(table, torch.arange(2), torch.zeros(2, dtype=torch.int32),
                       page_size=2, max_pages=4)
        with TPT.probe_stats_scope() as inner:
            assert inner["keys_probed"] == 0
            T.lookup_pages(table, torch.arange(3),
                           torch.zeros(3, dtype=torch.int32), page_size=2,
                           max_pages=4)
            assert inner["keys_probed"] == 12
        assert outer["keys_probed"] == 8


def test_paged_kv_functions_match_reference():
    """serving/paged: compact_local, write_token_kv (a -1 write slot is
    dropped, never wrapped), quantize_kv and attend_local (f32 and int8
    pools with scales) against the JAX functions on random pools."""
    from repro.serving import paged as JP
    from repro_torch.serving import paged as TP
    rng = np.random.default_rng(0)
    B, maxP, NP, PS, KH, G, D = 3, 4, 12, 4, 2, 2, 8
    slots = np.full((B, maxP), -1, np.int32)
    slots[0, :3] = [5, 0, 7]
    slots[1, :1] = [3]
    slots[2, :4] = [11, 1, 2, 9]
    pos = np.array([9, 2, 15], np.int32)
    cap = 8
    jl = JP.compact_local(jnp.asarray(slots), 0, NP, cap)
    tl = TP.compact_local(torch.from_numpy(slots), 0, NP, cap)
    for a, b in zip(jl, tl):
        same(a, b)
    pk = rng.standard_normal((NP, PS, KH, D)).astype(np.float32)
    pv = rng.standard_normal((NP, PS, KH, D)).astype(np.float32)
    kn = rng.standard_normal((B, KH, D)).astype(np.float32)
    vn = rng.standard_normal((B, KH, D)).astype(np.float32)
    ws = np.array([7, -1, 9], np.int32)
    jk, jv, _ = JP.write_token_kv(jnp.asarray(pk), jnp.asarray(pv),
                                  jnp.asarray(kn), jnp.asarray(vn),
                                  jnp.asarray(ws), jnp.asarray(pos), 0, NP,
                                  PS)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    TP.write_token_kv(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                      torch.from_numpy(ws), torch.from_numpy(pos), 0, NP, PS)
    same(jk, tk)
    same(jv, tv)
    q = rng.standard_normal((B, KH, G, D)).astype(np.float32)
    for a, b in zip(JP.attend_local(jnp.asarray(q), jk, jv, jl,
                                    jnp.asarray(pos), PS),
                    TP.attend_local(torch.from_numpy(q), tk, tv, tl,
                                    torch.from_numpy(pos), PS)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    jq, js = JP.quantize_kv(jnp.asarray(kn))
    tq, ts = TP.quantize_kv(torch.from_numpy(kn))
    same(jq, tq)
    np.testing.assert_array_equal(np.asarray(js, np.float32), ts.float())
    k8 = rng.integers(-127, 128, pk.shape).astype(np.int8)
    v8 = rng.integers(-127, 128, pk.shape).astype(np.int8)
    sc = rng.uniform(0.01, 0.1, (2, NP, PS, KH)).astype(np.float32)
    jsc = tuple(jnp.asarray(s, jnp.bfloat16) for s in sc)
    tsc = tuple(torch.from_numpy(s).to(torch.bfloat16) for s in sc)
    for a, b in zip(JP.attend_local(jnp.asarray(q), jnp.asarray(k8),
                                    jnp.asarray(v8), jl, jnp.asarray(pos),
                                    PS, scales=jsc),
                    TP.attend_local(torch.from_numpy(q), torch.from_numpy(k8),
                                    torch.from_numpy(v8), tl,
                                    torch.from_numpy(pos), PS, scales=tsc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    assert JP.capacity(3, 4, 1) == TP.capacity(3, 4, 1)


# ---------------------------------------------------------------------------
# The other probe strategies through the facade.

@pytest.mark.parametrize("strategy", ["robinhood", "hopscotch"])
def test_strategy_churn_and_rebuild_rows_match_reference(strategy):
    """Admit / decode / evict churn through each strategy's facade: table,
    meta, block table and write slots equal the JAX facade's every step;
    ``note_free``'s counters equal the reference's (hopscotch frees to
    EMPTY: pages freed, no tombstone created); and ``rebuild_block_table``
    — K3's plain version for robinhood, the strategy's find_batch for
    hopscotch — gives the reference's rows."""
    from repro.obs import counters as JOC
    from repro_torch.obs import counters as TOC
    jpt, tpt = JPT.for_strategy(strategy), TPT.for_strategy(strategy)
    n_pages, B, ps, maxP = 64, 4, 2, 12
    j = jpt.create_table(n_pages, seed=1)
    t = tpt.create_table(n_pages, seed=1, device="cpu")
    bj = jnp.full((B, maxP), -1, jnp.int32)
    bt = torch.full((B, maxP), -1, dtype=torch.int32)
    jc, tc = JOC.Counters.zeros(), TOC.Counters.zeros()
    seq = np.arange(B, dtype=np.int32)
    pos = np.zeros(B, np.int32)
    rng = np.random.default_rng(3)
    for round_ in range(20):
        (j, wj, _), bj = jpt.alloc_step_incremental(
            j, jnp.asarray(seq), jnp.asarray(pos), bj, page_size=ps)
        (t, wt, _), bt = tpt.alloc_step_incremental(
            t, torch.from_numpy(seq), torch.from_numpy(pos), bt,
            page_size=ps)
        same_table(j, t)
        np.testing.assert_array_equal(np.asarray(j.meta), u32(t.meta))
        same(wj, wt)
        same(bj, bt)
        pos = pos + 1
        if round_ % 5 == 4:
            mask = np.zeros(B, bool)
            mask[int(rng.integers(B))] = True
            j2 = jpt.free_sequences(j, jnp.asarray(seq), jnp.asarray(pos),
                                    page_size=ps, max_pages=maxP,
                                    active=jnp.asarray(mask))
            t2 = tpt.free_sequences(t, torch.from_numpy(seq),
                                    torch.from_numpy(pos), page_size=ps,
                                    max_pages=maxP,
                                    active=torch.from_numpy(mask))
            jc = JOC.note_free(jc, table_before=j, table_after=j2)
            tc = TOC.note_free(tc, table_before=t, table_after=t2)
            j, t = j2, t2
            same_table(j, t)
            bj = jpt.invalidate_block_rows(bj, jnp.asarray(mask))
            bt = tpt.invalidate_block_rows(bt, torch.from_numpy(mask))
            seq = np.where(mask, seq + 100, seq).astype(np.int32)
            pos = np.where(mask, 0, pos).astype(np.int32)
    assert TOC.snapshot(tc) == JOC.snapshot(jc)
    assert TOC.snapshot(tc)["pages_freed"] > 0
    if strategy == "hopscotch":
        assert TOC.snapshot(tc)["tombstones_created"] == 0
    want = jpt.rebuild_block_table(j, jnp.asarray(seq), maxP)
    same(want, tpt.rebuild_block_table(t, torch.from_numpy(seq), maxP,
                                       use_kernel=True))
    same(want, tpt.rebuild_block_table(t, torch.from_numpy(seq), maxP))
    assert jpt.headroom(j) == tpt.headroom(t)


def test_hopscotch_rebuild_falls_back_logs_once_and_reports(caplog):
    """``rebuild_block_table(use_kernel=True)`` on a hopscotch table serves
    the rows from the strategy's find_batch (K3 never launches), logs the
    fallback once, and ``fallback_report`` gives the reference's string;
    linear and robinhood report ok."""
    import dataclasses
    import logging

    from repro.configs import get_smoke_config as j_smoke
    from repro.serving import engine as JEG
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.probe_strategies import get_strategy
    from repro_torch.kernels.probe import probe_lookup_kernel
    from repro_torch.serving import engine as TEG
    pt = TPT.PageTable("hopscotch")          # a fresh facade: log state
    table = pt.create_table(64, seed=2, device="cpu")
    seq = torch.arange(3, dtype=torch.int32)
    table, _ = pt.prefill_alloc(table, seq, torch.tensor([5, 9, 1]),
                                page_size=2, max_pages=8)
    launches = probe_lookup_kernel.launches
    with caplog.at_level(logging.WARNING, logger=TPT.__name__):
        rows = [pt.rebuild_block_table(table, seq, 8, use_kernel=True)
                for _ in range(2)]
    fallbacks = [r for r in caplog.records if "fallback" in r.getMessage()]
    assert len(fallbacks) == 1
    assert probe_lookup_kernel.launches == launches
    plain = pt.rebuild_block_table(table, seq, 8)
    assert torch.equal(rows[0], plain) and torch.equal(rows[1], plain)
    keys = TPT.page_key(seq[:, None].long(), torch.arange(8)[None, :])
    found, slots = get_strategy("hopscotch").find_batch(table,
                                                        keys.reshape(-1))
    assert torch.equal(plain.reshape(-1), torch.where(found, slots, -1))
    for name in ("linear", "robinhood", "hopscotch"):
        jc = dataclasses.replace(j_smoke("qwen2.5-32b"), probe_strategy=name)
        tc = dataclasses.replace(get_smoke_config("qwen2.5-32b"),
                                 probe_strategy=name)
        assert TEG.fallback_report(tc) == JEG.fallback_report(jc)
        ok = TEG.fallback_report(tc)["probe_strategy"] == f"{name}: ok"
        assert ok == (name != "hopscotch")
