"""The SSM and hybrid families (mamba2, zamba2) against the JAX package.

The reference's own ``init`` parameters are converted through numpy
(``repro_torch.models.convert``); inputs are numpy arrays from a seed.
Tolerances, f32 smoke configs: logits and block outputs ``ATOL`` (1e-4)
absolute; the SSD state ``h`` and the other float state leaves ``H_ATOL``
(1e-5) absolute plus ``H_RTOL`` (1e-5) of the value (``h`` grows to about
10 over a few dozen tokens, where one f32 ulp is 1e-6); integer state
(table cells, block table, positions) and token ids bit for bit.  Inside the port, a K-token megastep equals K single
steps bit for bit; the abort latch leaves the mamba state unchanged; a
re-seated lane decodes from a zero state.  One bf16 case holds the
port's logits to the reference's within ``BF16_REL_TOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch.serve import ContinuousBatcher as JBatcher
from repro.models import ssm as j_ssm
from repro.models.registry import get_model as j_get_model
from repro.serving import engine as JEG
from repro.serving.sched import Request as JRequest
from repro.serving.sched import Scheduler as JScheduler
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import ContinuousBatcher
from repro_torch.models import convert, ssm
from repro_torch.models.registry import get_model
from repro_torch.serving import engine as EG
from repro_torch.serving import page_table as TPT
from repro_torch.serving.sched import Request, Scheduler

ATOL = 1e-4
H_ATOL = 1e-5
H_RTOL = 1e-5
# bf16 on both sides: the two packages round the same products in another
# order (XLA fuses bf16 elementwise chains in f32); ROADMAP's scratch run
# measured 0.009-0.013 for the attention families, mamba2 measures
# 0.011-0.014 (seeds 0-2)
BF16_REL_TOL = 2e-2
# zamba2's bf16 logits sit 0.019-0.031 from its own f32 logits in the
# reference (seeds 0-2): the shared attention block's bf16 error, six times
# over.  The port's sit as far from the reference's (0.020-0.032), so its
# bf16 case is held to this multiple of the reference's own bf16 error
BF16_OWN_ERR_FACTOR = 1.5

ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]

torch.set_num_threads(1)


def _cfgs(arch, dtype="float32", **over):
    jc = dataclasses.replace(j_smoke(arch), dtype=dtype, **over)
    tc = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **over)
    return jc, tc


_PARAMS = {}


def _params(arch, dtype="float32"):
    if (arch, dtype) not in _PARAMS:
        jc, tc = _cfgs(arch, dtype)
        jp, _ = j_get_model(jc).init(jc, jax.random.PRNGKey(0))
        _PARAMS[arch, dtype] = (jp, convert.from_numpy_tree(
            jax.tree.map(np.asarray, jp), tc, "cpu"))
    return _PARAMS[arch, dtype]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol, msg="", rtol=0.0):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               atol=atol, rtol=rtol, err_msg=msg)


# ---------------------------------------------------------------------------
# The block's pieces.

# (S, chunk, Hg, N): tests/test_models.py::test_ssd_matches_recurrence's
# ranges (S 8-64, chunk 4-16 or S itself, Hg 1-4, N 2-8)
SSD_CASES = [(8, 4, 1, 2), (8, 16, 3, 8), (16, 8, 2, 4), (32, 4, 4, 8),
             (32, 16, 1, 4), (64, 8, 3, 2), (64, 16, 4, 8)]


@pytest.mark.parametrize("carry", [False, True], ids=["h0", "carried"])
@pytest.mark.parametrize("S,chunk,Hg,N", SSD_CASES)
def test_ssd_chunked_matches_reference(S, chunk, Hg, N, carry):
    if S % chunk:
        chunk = S
    rng = np.random.default_rng(S + 7 * Hg + N)
    B, G, P = 2, 1, 4
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x, dt_raw = f(B, S, G, Hg, P), f(B, S, G, Hg)
    dt = np.log1p(np.exp(dt_raw)).astype(np.float32)
    A = -np.exp(f(G, Hg) * 0.3).astype(np.float32)
    Bm, Cm, D = f(B, S, G, N), f(B, S, G, N), f(G, Hg)
    h0 = f(B, G, Hg, P, N) if carry else None
    jy, jh = j_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)),
                               chunk=chunk,
                               h0=None if h0 is None else jnp.asarray(h0))
    ty, th = ssm.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm, D)), chunk=chunk,
                             h0=None if h0 is None else _t(h0))
    _close(ty, jy, ATOL, "y")
    _close(th, jh, H_ATOL, "h", H_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_causal_conv_and_decode_step_match_reference(arch):
    """``_causal_conv`` over a sequence with a history tail, and three
    ``mamba_decode_step`` calls from a random state: outputs within ATOL,
    the new state within H_ATOL."""
    jp, tp = _params(arch)
    jc, tc = _cfgs(arch)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["mamba"])
    tl = {k: v[0] for k, v in tp["layers"]["mamba"].items()}
    rng = np.random.default_rng(5)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    W, C = tc.conv_width, tc.d_inner
    x, tail = f(2, 6, C), f(2, W - 1, C)
    jy, jt = j_ssm._causal_conv(jnp.asarray(x), jl["conv_x_w"],
                                jl["conv_x_b"], jnp.asarray(tail))
    ty, tt = ssm._causal_conv(_t(x), tl["conv_x_w"], tl["conv_x_b"],
                              _t(tail))
    _close(ty, jy, ATOL)
    _close(tt, jt, 0.0)

    B = 3
    one = ssm.init_mamba_state(tc, B, torch.float32, "cpu")
    st = [f(*t.shape) for t in one]
    jst = j_ssm.MambaState(*map(jnp.asarray, st))
    tst = ssm.MambaState(*map(_t, st))
    for step in range(3):
        xin = f(B, 1, tc.d_model)
        jo, jst = j_ssm.mamba_decode_step(jl, jnp.asarray(xin), jc, jst)
        to, tst = ssm.mamba_decode_step(tl, _t(xin), tc, tst)
        _close(to, jo, ATOL, f"step {step}")
        for name, a, b in zip(ssm.MambaState._fields, tst, jst):
            _close(a, b, H_ATOL, f"{name} step {step}", H_RTOL)
    with pytest.raises(NotImplementedError, match="item 22"):
        ssm.mamba_decode_step(tl, _t(xin), tc, tst, tp_axis="model")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """``ssm_lm.forward`` / ``hybrid.forward`` over 2 x 32 tokens (two SSD
    chunks and more) against the reference's."""
    jp, tp = _params(arch)
    jc, tc = _cfgs(arch)
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 32))
    want, _ = j_get_model(jc).forward(jc, jp, jnp.asarray(toks))
    got, aux = get_model(tc).forward(tc, tp, _t(toks))
    _close(got, want, ATOL)
    assert float(aux) == 0.0
    last, _ = get_model(tc).forward(tc, tp, _t(toks), last_only=True)
    _close(last[:, 0], got[:, -1].numpy(), ATOL)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_match_reference(arch):
    """bf16 weights and activations on both sides: mamba2's logits within
    BF16_REL_TOL (relative, in the norm) of the reference's; zamba2's
    within BF16_OWN_ERR_FACTOR times the reference's own distance from
    its f32 logits on the same weights."""
    jp, tp = _params(arch, "bfloat16")
    jc, tc = _cfgs(arch, "bfloat16")
    assert tp["layers"]["mamba"]["w_x"].dtype == torch.bfloat16
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 32))
    want = np.asarray(j_get_model(jc).forward(jc, jp, jnp.asarray(toks))[0],
                      np.float32)
    got = get_model(tc).forward(tc, tp, _t(toks))[0].numpy()
    rel = _rel(got, want)
    if tc.family == "ssm":
        assert rel < BF16_REL_TOL, rel
        return
    jc32 = dataclasses.replace(jc, dtype="float32")
    f32 = np.asarray(j_get_model(jc32).forward(
        jc32, jax.tree.map(lambda a: a.astype(jnp.float32), jp),
        jnp.asarray(toks))[0])
    own = _rel(want, f32)
    assert rel < BF16_OWN_ERR_FACTOR * own, (rel, own)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_keeps_mamba_leaves_f32(arch):
    """A bf16 model: the reference draws ``A_log``, ``dt_bias`` and ``D``
    in f32 and every other leaf in bf16; the conversion keeps exactly that,
    bit for bit, and the port's own ``init`` draws them so too."""
    jc, tc = _cfgs(arch, "bfloat16")
    jp, _ = j_get_model(jc).init(jc, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jp)
    tp = convert.from_numpy_tree(np_tree, tc, "cpu")
    f32 = {"A_log", "dt_bias", "D"}
    for path, a in jax.tree_util.tree_flatten_with_path(np_tree)[0]:
        keys = [p.key for p in path]
        t = tp
        for kk in keys:
            t = t[kk]
        want = (torch.float32 if keys[-2] == "mamba" and keys[-1] in f32
                else torch.bfloat16)
        assert t.dtype == want, keys
        assert (a.dtype == np.float32) == (want == torch.float32), keys
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32))
    own = get_model(tc).init(tc, torch.Generator().manual_seed(0), "cpu")
    for k in f32:
        assert own["layers"]["mamba"][k].dtype == torch.float32
    assert own["layers"]["mamba"]["w_x"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The engine.

def _same_ssm(js, ts):
    for name, a, b in zip(ssm.MambaState._fields, ts["ssm"], js["ssm"]):
        _close(a, b, H_ATOL, name, H_RTOL)


@pytest.mark.parametrize("arch,fused", [("zamba2-1.2b", False),
                                        ("zamba2-1.2b", True),
                                        ("mamba2-2.7b", False)],
                         ids=["zamba2", "zamba2-fused", "mamba2"])
def test_megastep_matches_reference(arch, fused):
    """Three K=8 megasteps (the first with teacher forcing, a stop length
    on lane 1): tokens, positions, table and block table equal the
    reference's, the ``ssm`` leaves within H_ATOL, the pools within
    H_ATOL; mamba2's state has no table."""
    jp, tp = _params(arch)
    jc, tc = _cfgs(arch, fused_kernel=fused)
    B, S, ps, K = 3, 32, 4, 8
    rng = np.random.default_rng(2)
    tok0 = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
    forced = rng.integers(0, jc.vocab_size, (B, K)).astype(np.int32)
    fmask = np.zeros((B, K), bool)
    fmask[0, :5] = True
    fmask[2, :2] = True
    stop = np.array([S, 19, S], np.int32)
    js, _ = JEG.make_decode_state(jc, B, S_max=S, page_size=ps)
    ts, _ = EG.make_decode_state(tc, B, S_max=S, page_size=ps, device="cpu")
    assert set(ts) == set(js)
    assert ("table" in ts) == (tc.family == "hybrid")
    jm = jax.jit(JEG.make_serve_megastep(jc, S_max=S, K=K, page_size=ps))
    tm = EG.make_serve_megastep(tc, S_max=S, K=K, page_size=ps)
    jt, tt = jnp.asarray(tok0), _t(tok0)
    zeros = (np.zeros_like(forced), np.zeros_like(fmask))
    for r in range(3):
        f = (forced, fmask) if r == 0 else zeros
        jtoks, js = jm(jp, js, jt, jnp.asarray(stop), jnp.asarray(f[0]),
                       jnp.asarray(f[1]))
        ttoks, ts = tm(tp, ts, tt, _t(stop), _t(f[0]), _t(f[1]))
        np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
        for k in ("pos", "active", "aborted", "seq_ids", "block_table"):
            if k in ts:
                np.testing.assert_array_equal(ts[k].numpy(),
                                              np.asarray(js[k]), err_msg=k)
        if "table" in ts:
            np.testing.assert_array_equal(
                ts["table"].table.numpy().astype(np.int64).astype(np.uint32),
                np.asarray(js["table"].table))
            _close(ts["pools"].k, js["pools"].k, H_ATOL, "pools")
            _close(ts["pools"].v, js["pools"].v, H_ATOL, "pools")
        _same_ssm(js, ts)
        jt, tt = jtoks[:, -1:], ttoks[:, -1:]
    assert not ts["active"][1]                   # stop length latched


@pytest.mark.parametrize("arch", ARCHS)
def test_megastep_equals_single_steps_bitwise(arch):
    """K=8 megastep == 8 single steps inside the port, for K1's path and
    the plain path: same tokens, same final state (pools and the mamba
    state included)."""
    _, tp = _params(arch)
    for fused in (False, True):
        _, tc = _cfgs(arch, fused_kernel=fused)
        B, K = 2, 8
        tok0 = _t(np.random.default_rng(3).integers(
            0, tc.vocab_size, (B, 1)).astype(np.int32))
        s1, _ = EG.make_decode_state(tc, B, S_max=32, page_size=4,
                                     device="cpu")
        s2 = EG.clone_state(s1)
        step = EG.make_serve_step(tc, S_max=32, page_size=4)
        tok, outs = tok0, []
        for _ in range(K):
            logits, s1 = step(tp, s1, tok, s1["pos"])
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            tok = torch.where(s1["aborted"][:, None], tok, nxt)
            outs.append(tok[:, 0])
        mtoks, s2 = EG.make_serve_megastep(tc, S_max=32, K=K, page_size=4)(
            tp, s2, tok0)
        assert torch.equal(mtoks, torch.stack(outs, dim=1))
        assert set(s1) == set(s2)
        for k in s1:
            a, b = s1[k], s2[k]
            for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
                assert torch.equal(x, y), k
        if "table" in s2:
            assert int(TPT.for_strategy("linear").verify_block_table(
                s2["table"], s2["seq_ids"], s2["pos"], s2["block_table"],
                page_size=4)) == 0


def test_abort_latch_keeps_the_ssm_state():
    """zamba2: test_serving.py's abort scenario.  A megastep aborts at
    token 4 and latches; the refused token leaves every layer's mamba
    state as it was after token 3 (``_freeze_lanes``), where a single-step
    driver stands when the abort shows; after ``rebuild_page_table`` the
    refused suffix re-issues and the stream equals the single-step
    driver's, which rebuilds the moment the abort shows."""
    _, tp = _params("zamba2-1.2b")
    _, tc = _cfgs("zamba2-1.2b")
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

    stA, tokA, streamA, at_abort = EG.clone_state(state), tok0, [], None
    while len(streamA) < 8:
        logits, st2 = step(tp, stA, tokA, stA["pos"])
        if bool(st2["aborted"].any()):
            assert at_abort is None
            for a, b in zip(st2["ssm"], stA["ssm"]):
                assert torch.equal(a, b)          # the refused token froze
            at_abort = EG.clone_state(stA)
            stA = EG.rebuild_page_table(st2, n_pages=n_pages * 2)
            continue
        tokA = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        streamA.append(tokA[:, 0])
        stA = st2
    assert at_abort is not None and (at_abort["pos"] == 4).all()

    t1, stB = mega(tp, EG.clone_state(state), tok0)
    assert stB["aborted"].all() and (stB["pos"] == 4).all()
    assert (t1[:, 4:] == t1[:, 3:4]).all()
    for a, b in zip(stB["ssm"], at_abort["ssm"]):
        assert torch.equal(a, b)
    stB = EG.rebuild_page_table(stB, n_pages=n_pages * 2)
    t2, stB = mega(tp, stB, t1[:, -1:], torch.full((B,), 8,
                                                   dtype=torch.int32))
    assert (stB["pos"] == 8).all() and not stB["active"].any()
    assert torch.equal(torch.cat([t1[:, :4], t2[:, :4]], dim=1),
                       torch.stack(streamA, dim=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_readmission_resets_recurrent_state(arch):
    """tests/test_sched.py's readmission case in the port: the follow-up
    request's sampled tokens in a churned single-slot batcher equal the
    same request alone in a fresh batcher, and both equal the
    reference's."""
    jp, tp = _params(arch)
    jc, tc = _cfgs(arch)
    pc = np.random.default_rng(2).integers(0, tc.vocab_size, 3).astype(
        np.int32)

    def run(workload, ref: bool):
        kw = dict(batch=1, max_len=24, page_size=4, megastep_k=4,
                  auto_refill=False)
        sk = dict(slots=1, page_size=4, max_len=24, megastep_k=4)
        if ref:
            srv = JBatcher(jc, jp, scheduler=JScheduler(**sk), **kw)
            mk = JRequest
        else:
            srv = ContinuousBatcher(tc, tp, scheduler=Scheduler(**sk),
                                    device="cpu", **kw)
            mk = Request
        srv.sched.submit_many([mk(**r) for r in workload])
        assert srv.run_until_drained(max_rounds=200)
        return {r.req_id: r.sampled for r in srv.sched.finished}

    churned_w = [dict(req_id=0, prompt=np.full(2, 5, np.int32),
                      max_new_tokens=10),
                 dict(req_id=9, prompt=pc, max_new_tokens=8)]
    alone_w = [dict(req_id=9, prompt=pc, max_new_tokens=8)]
    churned = run(churned_w, ref=False)
    assert churned[9] == run(alone_w, ref=False)[9]
    assert churned == run(churned_w, ref=True)
