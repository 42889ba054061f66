"""The port's dense model and decode engine against the JAX package.

The reference's own ``lm.init`` parameters are converted through numpy
(``repro_torch.models.convert``), so both sides compute the same function.
Float outputs: f32 smoke config, ``atol=1e-4``.  Integer state (token ids,
table cells, block table, positions) must be equal.  Plus the engine's own
contracts inside the port: a K-token megastep == K single steps bit for
bit, and the abort latch with its rebuild-and-resume.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import lm as j_lm
from repro.serving import engine as JEG
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert
from repro_torch.models import lm
from repro_torch.models.registry import get_model
from repro_torch.serving import engine as EG
from repro_torch.serving import page_table as TPT


def _cfgs(**over):
    jc = dataclasses.replace(j_smoke("qwen2.5-32b"), dtype="float32", **over)
    tc = dataclasses.replace(get_smoke_config("qwen2.5-32b"),
                             dtype="float32", **over)
    return jc, tc

# small tensors: one intra-op thread keeps the parallel test workers
# from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    jc, tc = _cfgs()
    jp, _ = j_lm.init(jc, jax.random.PRNGKey(0))
    tp = convert.from_numpy_tree(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jp, tp


def test_forward_logits_match_reference(params):
    jp, tp = params
    jc, tc = _cfgs()
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 12))
    want, _ = j_lm.forward(jc, jp, jnp.asarray(toks))
    got, _ = lm.forward(tc, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_decode_matches_forward_in_the_port(params, fused):
    """Paged decode (plain attend_local, or K1's plain version) == the
    full forward, token by token."""
    _, tp = params
    _, tc = _cfgs(fused_kernel=fused)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, tc.vocab_size, (2, 12)))
    ref, _ = lm.forward(tc, tp, toks)
    state, _ = EG.make_decode_state(tc, 2, S_max=64, page_size=8,
                                    device="cpu")
    step = EG.make_serve_step(tc, S_max=64, page_size=8)
    for t in range(12):
        logits, state = step(tp, state, toks[:, t:t + 1].to(torch.int32),
                             torch.full((2,), t, dtype=torch.int32))
        np.testing.assert_allclose(logits.numpy(), ref[:, t].numpy(),
                                   atol=1e-4, rtol=1e-4)


def _same_state(js, ts, pools_atol=1e-5):
    np.testing.assert_array_equal(
        np.asarray(js["table"].table),
        ts["table"].table.numpy().astype(np.int64).astype(np.uint32))
    assert int(js["table"].num_keys) == int(ts["table"].num_keys)
    assert int(js["table"].num_tombs) == int(ts["table"].num_tombs)
    for k in ("block_table", "pos", "active", "aborted", "seq_ids"):
        np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy())
    np.testing.assert_allclose(ts["pools"].k.numpy(),
                               np.asarray(js["pools"].k), atol=pools_atol)


@pytest.mark.parametrize("fused", [False, True])
def test_megastep_tokens_and_page_table_match_reference(params, fused):
    """Two K=8 megasteps with teacher forcing and a stop length: token ids,
    table cells, block table and positions equal the reference's."""
    jp, tp = params
    jc, tc = _cfgs(fused_kernel=fused)
    B, S, ps, K = 3, 32, 4, 8
    rng = np.random.default_rng(2)
    tok0 = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
    forced = rng.integers(0, jc.vocab_size, (B, K)).astype(np.int32)
    fmask = np.zeros((B, K), bool)
    fmask[0, :5] = True
    fmask[2, :2] = True
    stop = np.array([S, 11, S], np.int32)
    js, _ = JEG.make_decode_state(jc, B, S_max=S, page_size=ps)
    ts, _ = EG.make_decode_state(tc, B, S_max=S, page_size=ps, device="cpu")
    jm = jax.jit(JEG.make_serve_megastep(jc, S_max=S, K=K, page_size=ps))
    tm = EG.make_serve_megastep(tc, S_max=S, K=K, page_size=ps)
    jt, tt = jnp.asarray(tok0), torch.from_numpy(tok0)
    for r in range(2):
        f = (forced, fmask) if r == 0 else (np.zeros_like(forced),
                                            np.zeros_like(fmask))
        jtoks, js = jm(jp, js, jt, jnp.asarray(stop), jnp.asarray(f[0]),
                       jnp.asarray(f[1]))
        ttoks, ts = tm(tp, ts, tt, torch.from_numpy(stop),
                       torch.from_numpy(f[0]), torch.from_numpy(f[1]))
        np.testing.assert_array_equal(np.asarray(jtoks), ttoks.numpy())
        _same_state(js, ts)
        jt, tt = jtoks[:, -1:], ttoks[:, -1:]
    assert not ts["active"][1]                   # stop length latched


def test_megastep_equals_single_steps_bitwise(params):
    """K=4 megastep == 4 single steps inside the port: same tokens, same
    final state, pools included, for K1's path and the plain path."""
    _, tp = params
    for fused in (False, True):
        _, tc = _cfgs(fused_kernel=fused)
        B, K = 2, 4
        tok0 = torch.from_numpy(np.random.default_rng(3).integers(
            0, tc.vocab_size, (B, 1)).astype(np.int32))
        s1, _ = EG.make_decode_state(tc, B, S_max=32, page_size=2,
                                     device="cpu")
        s2 = EG.clone_state(s1)
        step = EG.make_serve_step(tc, S_max=32, page_size=2)
        tok, outs = tok0, []
        for _ in range(K):
            logits, s1 = step(tp, s1, tok, s1["pos"])
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            tok = torch.where(s1["aborted"][:, None], tok, nxt)
            outs.append(tok[:, 0])
        mtoks, s2 = EG.make_serve_megastep(tc, S_max=32, K=K, page_size=2)(
            tp, s2, tok0)
        assert torch.equal(mtoks, torch.stack(outs, dim=1))
        for k in s1:
            a, b = s1[k], s2[k]
            for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
                assert torch.equal(x, y), k


def test_abort_latch_resume_and_rebuild(params):
    """test_serving.py's abort scenario in the port: a megastep aborts at
    token 4 and latches (pos frozen, refused token pending, suffix frozen);
    after rebuild_page_table the refused suffix re-issues; the stream
    equals a single-step driver that rebuilds the moment the abort shows;
    stop_len latches the lanes done."""
    _, tp = params
    _, tc = _cfgs()
    B, ps, K = 2, 4, 8
    step = EG.make_serve_step(tc, S_max=8, page_size=ps)
    mega = EG.make_serve_megastep(tc, S_max=8, K=K, page_size=ps)
    state, _ = EG.make_decode_state(tc, B, S_max=8, page_size=ps,
                                    device="cpu")
    n_pages = state["pools"].k.shape[1]
    tok = torch.zeros((B, 1), dtype=torch.int32)
    for _ in range(8):
        logits, state = step(tp, state, tok, state["pos"])
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    state["seq_ids"] = state["seq_ids"] + B          # re-admit, no evict
    state["pos"] = torch.zeros((B,), dtype=torch.int32)
    tok0 = torch.zeros((B, 1), dtype=torch.int32)

    stA, tokA, streamA, rebuilds = EG.clone_state(state), tok0, [], 0
    while len(streamA) < 8:
        logits, st2 = step(tp, stA, tokA, stA["pos"])
        if bool(st2["aborted"].any()):
            stA = EG.rebuild_page_table(st2, n_pages=n_pages * 2)
            rebuilds += 1
            continue
        tokA = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        streamA.append(tokA[:, 0])
        stA = st2
    assert rebuilds == 1

    t1, stB = mega(tp, EG.clone_state(state), tok0)
    assert stB["aborted"].all() and (stB["pos"] == 4).all()
    assert (t1[:, 4:] == t1[:, 3:4]).all()
    stB = EG.rebuild_page_table(stB, n_pages=n_pages * 2)
    assert not stB["aborted"].any()
    t2, stB = mega(tp, stB, t1[:, -1:], torch.full((B,), 8,
                                                   dtype=torch.int32))
    assert (stB["pos"] == 8).all() and not stB["active"].any()
    streamB = torch.cat([t1[:, :4], t2[:, :4]], dim=1)
    assert torch.equal(streamB, torch.stack(streamA, dim=1))
    assert int(TPT.for_strategy("linear").verify_block_table(
        stB["table"], stB["seq_ids"], stB["pos"] - 1, stB["block_table"],
        page_size=ps)) == 0


def test_rebuild_matches_reference_and_kernel_path(params):
    """rebuild_page_table moves table, block table and pools exactly as the
    reference's; use_kernel=True (K3's plain version here) gives the same
    state."""
    jp, tp = params
    jc, tc = _cfgs()
    B, S, ps = 2, 16, 4
    toks = np.random.default_rng(4).integers(0, jc.vocab_size, (B, 6))
    js, _ = JEG.make_decode_state(jc, B, S_max=S, page_size=ps)
    ts, _ = EG.make_decode_state(tc, B, S_max=S, page_size=ps, device="cpu")
    jstep = jax.jit(JEG.make_serve_step(jc, S_max=S, page_size=ps))
    tstep = EG.make_serve_step(tc, S_max=S, page_size=ps)
    for t in range(6):
        _, js = jstep(jp, js, jnp.asarray(toks[:, t:t + 1]),
                      jnp.full((B,), t, jnp.int32))
        _, ts = tstep(tp, ts, torch.from_numpy(toks[:, t:t + 1]),
                      torch.full((B,), t, dtype=torch.int32))
    n = ts["pools"].k.shape[1] * 2
    jr = JEG.rebuild_page_table(js, n_pages=n)
    tr = EG.rebuild_page_table(ts, n_pages=n)
    tk = EG.rebuild_page_table(ts, n_pages=n, use_kernel=True)
    _same_state(jr, tr)
    for k in ("block_table", "pos"):
        assert torch.equal(tr[k], tk[k])
    assert torch.equal(tr["table"].table, tk["table"].table)
    assert torch.equal(tr["pools"].k, tk["pools"].k)


@pytest.mark.parametrize("strategy", ["robinhood", "hopscotch"])
def test_rebuild_per_strategy_matches_reference(params, strategy):
    """With ``cfg.probe_strategy`` set, six decode steps and a rebuild
    into a 2x pool equal the reference's state (table, meta, block table,
    pools); ``use_kernel=True`` gives the same state (K3's plain version
    for robinhood, the strategy's find_batch for hopscotch); rebuilding
    with a strategy whose metadata differs raises as in the reference."""
    jp, tp = params
    jc, tc = _cfgs(probe_strategy=strategy)
    B, S, ps = 2, 16, 4
    toks = np.random.default_rng(4).integers(0, jc.vocab_size, (B, 6))
    js, _ = JEG.make_decode_state(jc, B, S_max=S, page_size=ps)
    ts, _ = EG.make_decode_state(tc, B, S_max=S, page_size=ps, device="cpu")
    jstep = jax.jit(JEG.make_serve_step(jc, S_max=S, page_size=ps))
    tstep = EG.make_serve_step(tc, S_max=S, page_size=ps)
    for t in range(6):
        _, js = jstep(jp, js, jnp.asarray(toks[:, t:t + 1]),
                      jnp.full((B,), t, jnp.int32))
        _, ts = tstep(tp, ts, torch.from_numpy(toks[:, t:t + 1]),
                      torch.full((B,), t, dtype=torch.int32))
    _same_state(js, ts)
    n = ts["pools"].k.shape[1] * 2
    jr = JEG.rebuild_page_table(js, n_pages=n, strategy=strategy)
    tr = EG.rebuild_page_table(ts, n_pages=n, strategy=strategy)
    tk = EG.rebuild_page_table(ts, n_pages=n, strategy=strategy,
                               use_kernel=True)
    _same_state(jr, tr)
    np.testing.assert_array_equal(
        np.asarray(jr["table"].meta),
        tr["table"].meta.numpy().astype(np.int64).astype(np.uint32))
    for k in ("block_table", "pos"):
        assert torch.equal(tr[k], tk[k])
    assert torch.equal(tr["table"].table, tk["table"].table)
    assert torch.equal(tr["pools"].k, tk["pools"].k)
    other = "linear" if strategy == "hopscotch" else "hopscotch"
    with pytest.raises(ValueError, match="metadata does not match"):
        EG.rebuild_page_table(ts, n_pages=n, strategy=other)


def test_unported_paths_raise():
    """Every family, encdec included, is served on a mesh now
    (``tests/test_torch_mesh_encdec.py``); rules of another mesh than the
    bound one are refused.  Every family is served on one device and the
    fallback reasons keep the reference's strings, the ssm and encdec ones
    included.  A hybrid depth below one group of mamba layers is refused
    (the reference's decode would find no page table)."""
    from repro.configs import get_smoke_config as j_smoke_cfg
    from repro_torch.configs import get_smoke_config as smoke
    from repro_torch.dist import collectives as C
    from repro_torch.dist import sharding as SH
    _, tc = _cfgs()
    ec = smoke("seamless-m4t-large-v2")
    C.set_mesh(C.Mesh((1, 1), ("data", "model"), "cpu"))
    try:
        other = SH.serve_rules(C.AbstractMesh((1, 1), ("data", "model")))
        with pytest.raises(ValueError, match="bound mesh"):
            EG.make_serve_step(ec, S_max=16, rules=other)
        with pytest.raises(ValueError, match="bound mesh"):
            EG.make_decode_state(ec, 2, 16, rules=other, device="cpu")
    finally:
        C.set_mesh(None)
    jc, _ = _cfgs()
    assert EG.fallback_report(tc) == JEG.fallback_report(jc)
    assert EG.fallback_report(dataclasses.replace(tc, fused_kernel=True)) \
        == JEG.fallback_report(dataclasses.replace(jc, fused_kernel=True))
    for arch, module, reason in (
            ("mamba2-2.7b", "ssm_lm",
             "attention-free SSM stack: no paged decode attention"),
            ("zamba2-1.2b", "hybrid", "ok"),
            ("seamless-m4t-large-v2", "encdec",
             "cross-attention decode state not wired to the fused kernel")):
        t_cfg = dataclasses.replace(smoke(arch), fused_kernel=True)
        j_cfg = dataclasses.replace(j_smoke_cfg(arch), fused_kernel=True)
        assert get_model(t_cfg).__name__ == f"repro_torch.models.{module}"
        EG.make_decode_state(t_cfg, 2, 16, page_size=4, device="cpu")
        rep = EG.fallback_report(t_cfg)
        assert rep == JEG.fallback_report(j_cfg)
        assert rep["fused_kernel"] == reason
    with pytest.raises(ValueError, match="below one group"):
        get_model(dataclasses.replace(smoke("zamba2-1.2b"), num_layers=1))


def test_counter_plane_matches_reference_and_changes_nothing(params):
    """cfg.telemetry: the on-device counters equal the reference's after a
    megastep, and turning them on changes no token and no state leaf."""
    from repro.obs import snapshot as j_snapshot
    from repro_torch.obs import snapshot
    jp, tp = params
    jc, tc = _cfgs(telemetry=True)
    B, S, ps, K = 2, 16, 2, 6
    tok0 = np.random.default_rng(5).integers(0, jc.vocab_size, (B, 1))
    js, _ = JEG.make_decode_state(jc, B, S_max=S, page_size=ps)
    ts, _ = EG.make_decode_state(tc, B, S_max=S, page_size=ps, device="cpu")
    jt, js = jax.jit(JEG.make_serve_megastep(jc, S_max=S, K=K,
                                             page_size=ps))(
        jp, js, jnp.asarray(tok0, jnp.int32))
    tt, ts = EG.make_serve_megastep(tc, S_max=S, K=K, page_size=ps)(
        tp, ts, torch.from_numpy(tok0.astype(np.int32)))
    assert snapshot(ts["counters"]) == j_snapshot(js["counters"])
    assert snapshot(ts["counters"])["pages_allocated"] == B * K // ps
    _, off = _cfgs()
    so, _ = EG.make_decode_state(off, B, S_max=S, page_size=ps, device="cpu")
    to, so = EG.make_serve_megastep(off, S_max=S, K=K, page_size=ps)(
        tp, so, torch.from_numpy(tok0.astype(np.int32)))
    assert torch.equal(tt, to) and "counters" not in so
    assert torch.equal(ts["table"].table, so["table"].table)
    assert torch.equal(ts["pools"].k, so["pools"].k)
