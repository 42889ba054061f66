"""The port's simulator (``repro_torch.core.simulator``, Algorithms 1-6 in
the LL/SC and the CAS variant) against the JAX package's.

Analogs of every ``tests/test_simulator.py`` case, in both modes.  Beyond
the reference's own assertions, every run is held bit for bit to
``repro.core.simulator.simulate`` on the same workload, schedule and hash
seed: the table, owner and version words, every register, the results,
``t_inv``, ``t_rsp``, ``steps``, ``t``, ``pair_ok`` and ``inv_ok``, and the
``history_arrays`` rows.  That is stronger than the reference's check
(linearizability and the invariants alone), so the bitwise comparison runs
fewer random trials than ``test_simulator.py``: 3 of its 10 (sequential,
same-key) or 8 (concurrent) per case; the port alone runs all of them
against the reference's assertions.  The JAX side compiles once per hash
seed, which is most of this file's time.
"""
import zlib

import numpy as np
import pytest
import torch

from repro.core import encoding as JE
from repro.core import hashing as JH
from repro.core import simulator as JSIM
from repro_torch.core import encoding as E
from repro_torch.core import hashing as H
from repro_torch.core import schedulers as S
from repro_torch.core import simulator as sim
from repro_torch.core.linearizability import check_history
from repro_torch.core.spec import (OP_DELETE, OP_INSERT, RET_ABORT,
                                   RET_PENDING, RET_TRUE, apply_sequential)

# small tensors: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)

MODES = [sim.MODE_LLSC, sim.MODE_CAS]
BITWISE_TRIALS = 3


def as_i64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


def assert_same_state(js, ts):
    for f in ("table", "owner", "ver", "results", "t_inv", "t_rsp", "steps",
              "t", "pair_ok", "inv_ok"):
        np.testing.assert_array_equal(as_i64(getattr(js, f)),
                                      as_i64(getattr(ts, f)), err_msg=f)
    for f in JSIM.Regs._fields:
        np.testing.assert_array_equal(as_i64(getattr(js.regs, f)),
                                      as_i64(getattr(ts.regs, f)),
                                      err_msg=f"regs.{f}")


def run(wl, m, schedule, mode, seed=0, check_inv=False, bitwise=True):
    """The port's run on the CPU; with ``bitwise`` also the reference's on
    the same inputs, every field equal."""
    st = sim.simulate(wl, m, schedule, mode=mode, hash_seed=seed,
                      check_inv=check_inv, device="cpu")
    if bitwise:
        jwl = JSIM.Workload(op=wl.op, key=wl.key)
        js = JSIM.simulate(jwl, m, schedule, mode=mode, hash_seed=seed,
                           check_inv=check_inv)
        assert_same_state(js, st)
        assert sim.history_arrays(st, wl) == JSIM.history_arrays(js, jwl)
    return st


def finished(st, wl):
    res = st.results.numpy()
    return np.all((res != RET_PENDING) | (wl.op == -1))


def table_keys(st):
    return st.table.numpy() >> 2


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_sequential_matches_spec(mode):
    """Single process, any schedule = sequential execution: results must
    exactly match the abstract dictionary."""
    rng = np.random.default_rng(0)
    for trial in range(10):
        K = 40
        wl = S.random_workload(rng, P=1, K=K, num_keys=8)
        m = 32
        sched = np.zeros(5000, dtype=np.int32)
        st = run(wl, m, sched, mode, seed=trial,
                 bitwise=trial < BITWISE_TRIALS)
        assert finished(st, wl)
        _, expect = apply_sequential(
            [(int(wl.op[0, k]), int(wl.key[0, k])) for k in range(K)])
        got = list(st.results.numpy()[0])
        assert got == expect, f"trial {trial}: {got} vs {expect}"
        assert bool(st.pair_ok)


@pytest.mark.parametrize("mode", MODES)
def test_sequential_tombstone_reuse(mode):
    """insert/delete churn of distinct keys in a tiny table must never abort:
    tombstones are reused (the paper's headline difference vs [7,14])."""
    m = 8
    K = 64
    ops, keys = [], []
    for t in range(K // 2):
        ops += [OP_INSERT, OP_DELETE]
        keys += [100 + t, 100 + t]
    wl = sim.Workload(op=np.array([ops], dtype=np.int32),
                      key=np.array([keys], dtype=np.uint32))
    st = run(wl, m, np.zeros(4000, dtype=np.int32), mode)
    assert finished(st, wl)
    res = st.results.numpy()[0]
    assert np.all(res == RET_TRUE), res  # every insert & delete succeeds
    assert not np.any(res == RET_ABORT)


@pytest.mark.parametrize("mode", MODES)
def test_solo_insert_never_aborts_with_space(mode):
    """Proposition 2 corollary: a solo insert with a free/tombstone cell
    available does not abort."""
    m = 8
    # fill m-1 keys, delete some, then insert new ones
    ops = [OP_INSERT] * (m - 1) + [OP_DELETE] * 3 + [OP_INSERT] * 3
    keys = list(range(1, m)) + [1, 2, 3] + [50, 51, 52]
    wl = sim.Workload(op=np.array([ops], dtype=np.int32),
                      key=np.array([keys], dtype=np.uint32))
    st = run(wl, m, np.zeros(3000, dtype=np.int32), mode)
    assert finished(st, wl)
    assert np.all(st.results.numpy()[0] == RET_TRUE)


@pytest.mark.parametrize("mode", MODES)
def test_abort_when_full(mode):
    """Insert into a truly full table returns ABORT and changes nothing."""
    m = 4
    ops = [OP_INSERT] * m + [OP_INSERT]
    keys = [1, 2, 3, 4, 99]
    wl = sim.Workload(op=np.array([ops], dtype=np.int32),
                      key=np.array([keys], dtype=np.uint32))
    st = run(wl, m, np.zeros(2000, dtype=np.int32), mode)
    assert finished(st, wl)
    res = st.results.numpy()[0]
    assert list(res[:m]) == [RET_TRUE] * m
    assert res[m] == RET_ABORT


def _schedule(kind, rng, P, T):
    if kind == "uniform":
        return S.uniform_schedule(rng, P, T)
    if kind == "bursty":
        return S.bursty_schedule(rng, P, T)
    if kind == "stalled":
        return S.stalled_schedule(rng, P, T)
    return S.round_robin_schedule(P, T)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sched_kind", ["uniform", "bursty", "stalled", "rr"])
def test_concurrent_linearizable(mode, sched_kind):
    """Random concurrent executions are linearizable and preserve the
    invariants (Lemma 4 + Proposition 3), bit for bit the reference's."""
    rng = np.random.default_rng(zlib.crc32(f"{mode},{sched_kind}".encode()))
    for trial in range(8):
        P, K, m = 3, 5, 16
        wl = S.random_workload(rng, P=P, K=K, num_keys=5)
        sched = _schedule(sched_kind, rng, P, 4000)
        st = run(wl, m, sched, mode, seed=trial, check_inv=True,
                 bitwise=trial < BITWISE_TRIALS)
        assert bool(st.pair_ok), f"LL/SC pairing violated ({mode},{trial})"
        assert bool(st.inv_ok), f"Lemma4/Prop3 violated ({mode},{trial})"
        rows = sim.history_arrays(st, wl)
        ok, bad = check_history(rows)
        assert ok, (f"non-linearizable keys {bad} ({mode},{sched_kind},"
                    f"{trial}): {rows}")


@pytest.mark.parametrize("mode", MODES)
def test_same_key_stress(mode):
    """All processes hammer one key (Figure 2 scenarios): duplicate copies
    must be resolved; history must remain linearizable."""
    rng = np.random.default_rng(7)
    for trial in range(10):
        P, K, m = 3, 4, 8
        wl = S.same_key_workload(P, K, key=5, pattern="insert_delete")
        sched = S.uniform_schedule(rng, P, 6000)
        st = run(wl, m, sched, mode, seed=trial, check_inv=True,
                 bitwise=trial < BITWISE_TRIALS)
        assert bool(st.inv_ok)
        assert bool(st.pair_ok)
        rows = sim.history_arrays(st, wl)
        ok, bad = check_history(rows)
        assert ok, f"({mode}, trial {trial}): {rows}"
        # after everything completes, at most one copy of the key remains
        if finished(st, wl):
            copies = np.sum(table_keys(st) == 5)
            assert copies <= 1, st.table


@pytest.mark.parametrize("mode", MODES)
def test_step_accounting(mode):
    """Each completed op consumed >= 1 memory events (scan + action)."""
    rng = np.random.default_rng(11)
    wl = S.random_workload(rng, P=2, K=6, num_keys=4)
    st = run(wl, 16, S.uniform_schedule(rng, 2, 3000), mode)
    steps = st.steps.numpy()
    res = st.results.numpy()
    assert np.all(steps[res != RET_PENDING] >= 1)
    assert steps.sum() <= 3000


@pytest.mark.parametrize("mode", MODES)
def test_init_state_matches_reference(mode):
    """Op 0 set up process by process, OP_NONE rows halted."""
    rng = np.random.default_rng(5)
    wl = S.random_workload(rng, P=4, K=3, num_keys=9)
    wl.op[2, 0] = -1
    js = JSIM.init_state(mode, 16, 3, wl.op, wl.key)
    ts = sim.init_state(mode, 16, 3, wl.op, wl.key, device="cpu")
    assert_same_state(js, ts)


def test_schedulers_match_reference():
    """The copied schedulers draw the same schedules and workloads."""
    from repro.core import schedulers as JS
    for draw in (lambda m, r: m.uniform_schedule(r, 3, 500),
                 lambda m, r: m.bursty_schedule(r, 3, 500),
                 lambda m, r: m.stalled_schedule(r, 3, 500),
                 lambda m, r: m.random_workload(r, 3, 5, 7),
                 lambda m, r: m.make_cbounded_workload(r, 6, 5, 2, 12),
                 lambda m, r: m.same_key_workload(3, 6, pattern="mixed"),
                 lambda m, r: m.insert_only_distinct(2, 4, start=9)):
        a = draw(S, np.random.default_rng(4))
        b = draw(JS, np.random.default_rng(4))
        parts = lambda x: list(x) if isinstance(x, tuple) else [x]
        for x, y in zip(parts(a), parts(b), strict=True):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# Encoding, space accounting, hashing.

def _words():
    """Every tag of a few keys (0, 1, 12345, MAX_KEY) and the key-less
    words."""
    keys = [0, 1, 12345, E.MAX_KEY]
    return ([(k << 2) | tag for k in keys for tag in range(4)]
            + [E.EMPTY, E.TOMBSTONE, E.DELETED, E.COLLIDED])


def test_encoding_matches_reference():
    words = np.array(_words(), dtype=np.uint32)
    tw = torch.from_numpy(words.astype(np.int32))
    assert (E.TAG_TENTATIVE, E.TAG_FINAL, E.TAG_REVALIDATE, E.TAG_SPECIAL,
            E.KEY_BITS, E.RESERVED_KEY, E.MAX_KEY, E.EMPTY, E.TOMBSTONE,
            E.DELETED, E.COLLIDED, E.NO_OWNER) == (
        JE.TAG_TENTATIVE, JE.TAG_FINAL, JE.TAG_REVALIDATE, JE.TAG_SPECIAL,
        JE.KEY_BITS, JE.RESERVED_KEY, JE.MAX_KEY, JE.EMPTY, JE.TOMBSTONE,
        JE.DELETED, JE.COLLIDED, JE.NO_OWNER)
    for name in ("dec_key", "dec_tag", "val", "is_available", "is_marked",
                 "restart"):
        want = np.asarray(getattr(JE, name)(words)).astype(np.int64)
        got = as_i64(getattr(E, name)(tw))
        np.testing.assert_array_equal(got, want, err_msg=name)
        # the host form (Python ints, as the simulator's registers)
        np.testing.assert_array_equal(
            [int(getattr(E, name)(int(w))) for w in words], want,
            err_msg=f"{name} on ints")
    np.testing.assert_array_equal(
        as_i64(E.has_key(tw, 12345)),
        np.asarray(JE.has_key(words, 12345)).astype(np.int64))
    keys = np.array([0, 1, 12345, E.MAX_KEY], dtype=np.uint32)
    tk = torch.from_numpy(keys.astype(np.int32))
    for name in ("enc_tentative", "enc_final", "enc_revalidate",
                 "enc_marked"):
        want = np.asarray(getattr(JE, name)(keys)).astype(np.int64)
        np.testing.assert_array_equal(as_i64(getattr(E, name)(tk)), want,
                                      err_msg=name)
        np.testing.assert_array_equal(
            [getattr(E, name)(int(k)) for k in keys], want)


def test_encoding_roundtrip():
    for v in [0, 1, 12345, E.MAX_KEY]:
        assert int(E.dec_key(E.enc_tentative(v))) == v
        assert int(E.dec_tag(E.enc_final(v))) == E.TAG_FINAL
        assert bool(E.restart(E.enc_revalidate(v)))
        assert bool(E.is_marked(E.enc_marked(v)))
        assert not bool(E.is_marked(E.enc_revalidate(v)))
    for c in [E.EMPTY, E.TOMBSTONE, E.DELETED, E.COLLIDED]:
        assert int(E.dec_key(torch.tensor(c))) == E.RESERVED_KEY
        assert not bool(E.restart(torch.tensor(c)))
    assert bool(E.is_available(torch.tensor(E.EMPTY)))
    assert bool(E.is_available(torch.tensor(E.TOMBSTONE)))
    assert not bool(E.is_available(torch.tensor(E.DELETED)))


def test_cell_size_accounting():
    """Theorem 1 bit counts, and every function equal to the reference's
    over a grid of U, n and m."""
    cs = E.cell_size_llsc(U=2**20)
    assert cs.total == 21 + 2 == 23  # ceil(log2(2^20+1)) = 21
    cs2 = E.cell_size_cas(U=2**20, n=64, m=2**16)
    assert cs2.owner_bits == 6
    assert cs2.total == 21 + 2 + 6
    for U in (1, 2, 3, 255, 256, 2**20, 2**28 - 2, 2**32, 2**64):
        assert E.cell_size_llsc(U) == JE.cell_size_llsc(U)
        assert E.cell_size_gao(U) == JE.cell_size_gao(U)
        assert E.cell_size_robinhood(U) == JE.cell_size_robinhood(U)
        assert E.cell_size_shun_blelloch(U) == JE.cell_size_shun_blelloch(U)
        for ts in (32, 64):
            assert E.cell_size_purcell_harris_lower_bound(U, ts) == \
                JE.cell_size_purcell_harris_lower_bound(U, ts)
        for m in (1, 2, 100, 2**16, 2**20 + 1):
            assert E.table_bits_llsc(U, m) == JE.table_bits_llsc(U, m)
            for n in (1, 2, 7, 64, 10**6):
                assert E.cell_size_cas(U, n, m) == JE.cell_size_cas(U, n, m)
                assert E.table_bits_cas(U, n, m) == \
                    JE.table_bits_cas(U, n, m)


def test_hashing_range():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**28 - 2, size=1000).astype(np.uint32)
    tk = torch.from_numpy(keys.astype(np.int64))
    for m in [16, 64, 100, 1 << 12]:
        h = H.hash_keys(tk, m, seed=3).numpy()
        assert h.min() >= 0 and h.max() < m
    # determinism + seed sensitivity
    h1 = H.hash_keys(tk, 64, seed=1).numpy()
    h2 = H.hash_keys(tk, 64, seed=2).numpy()
    assert not np.array_equal(h1, h2)


@pytest.mark.parametrize("m", [1, 16, 100])
def test_probe_distance_matches_reference(m):
    idx, start = np.meshgrid(np.arange(m, dtype=np.int32),
                             np.arange(m, dtype=np.int32), indexing="ij")
    want = np.asarray(JH.probe_distance(idx, start, m))
    got = H.probe_distance(torch.from_numpy(idx), torch.from_numpy(start), m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    assert [H.probe_distance(int(i), int(s), m) for i, s in
            zip(idx.ravel(), start.ravel())] == want.ravel().tolist()


def test_check_invariants_matches_reference():
    """The monitors on tables that break Lemma 4 (two finals of one key)
    and Proposition 3 (an EMPTY hole before a key), and on a sound one."""
    m, seed = 8, 2
    base = np.full(m, E.EMPTY, dtype=np.uint32)
    h = int(np.asarray(JH.hash_keys(np.uint32(9), m, seed)))
    sound = base.copy()
    sound[h] = E.enc_final(9)
    two_finals = sound.copy()
    two_finals[(h + 1) % m] = E.enc_final(9)
    hole = base.copy()
    hole[(h + 2) % m] = E.enc_final(9)
    for tab in (sound, two_finals, hole, base):
        want = bool(JSIM.check_invariants(tab, m, seed))
        got = bool(sim.check_invariants(torch.from_numpy(
            tab.astype(np.int32)), m, seed))
        assert got == want
    assert bool(sim.check_invariants(torch.from_numpy(
        sound.astype(np.int32)), m, seed))
    assert not bool(sim.check_invariants(torch.from_numpy(
        hole.astype(np.int32)), m, seed))
