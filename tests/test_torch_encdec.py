"""The encoder-decoder family (seamless-m4t-large-v2) against the JAX
package.

The reference's own ``encdec.init`` parameters are converted through
numpy; ``src_embeds`` (the stub audio frontend's frame embeddings) and
tokens are numpy arrays from a seed.  Tolerances, f32 smoke config:
logits, encoder memory and cross K/V ``ATOL`` (1e-4) absolute; the pools
``STATE_ATOL`` (1e-5); table cells, block table, positions and token ids
bit for bit.  The self attention decodes through the plain
``attend_local`` in both packages (the reference does not wire it to the
fused kernel, and ``fallback_report`` says so in both).  One bf16 case
holds the port's logits to the reference's within ``BF16_REL_TOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import encdec as j_encdec
from repro.models import layers as j_layers
from repro.serving import engine as JEG
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert, encdec, layers
from repro_torch.models.registry import get_model
from repro_torch.serving import engine as EG

ARCH = "seamless-m4t-large-v2"
ATOL = 1e-4
STATE_ATOL = 1e-5
# bf16 on both sides; measured 0.0096-0.0105 (seeds 0-2), the reference's
# own bf16 logits sit 0.0083-0.0085 from its f32 ones
BF16_REL_TOL = 2e-2

torch.set_num_threads(1)


def _cfgs(dtype="float32", **over):
    jc = dataclasses.replace(j_smoke(ARCH), dtype=dtype, **over)
    tc = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype, **over)
    return jc, tc


_PARAMS = {}


def _params(dtype="float32"):
    if dtype not in _PARAMS:
        jc, tc = _cfgs(dtype)
        jp, _ = j_encdec.init(jc, jax.random.PRNGKey(0))
        _PARAMS[dtype] = (jp, convert.from_numpy_tree(
            jax.tree.map(np.asarray, jp), tc, "cpu"))
    return _PARAMS[dtype]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               atol=atol, rtol=0, err_msg=msg)


def _src(B, S_src, d, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (B, S_src, d)).astype(np.float32)


def test_cross_attention_matches_reference():
    """``layers.cross_attention``: q from 5 decoder positions, k/v from 9
    memory rows, no positions, every row attended."""
    jp, tp = _params()
    jc, _ = _cfgs()
    jl = jax.tree.map(lambda a: a[0], jp["decoder"]["cross"])
    tl = {k: v[0] for k, v in tp["decoder"]["cross"].items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, jc.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 9, jc.d_model)).astype(np.float32)
    want = j_layers.cross_attention(jl, jnp.asarray(x), jnp.asarray(mem))
    _close(layers.cross_attention(tl, _t(x), _t(mem)), want, ATOL)


def test_encode_and_forward_match_reference():
    """``encode`` (non-causal self attention, then ``enc_norm``) and the
    teacher-forced ``forward``; ``forward`` refuses a call without
    ``src_embeds`` as the reference does."""
    jp, tp = _params()
    jc, tc = _cfgs()
    src = _src(2, 8, jc.d_model)
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 12))
    _close(encdec.encode(tc, tp, _t(src)),
           j_encdec.encode(jc, jp, jnp.asarray(src)), ATOL)
    want, _ = j_encdec.forward(jc, jp, jnp.asarray(toks),
                               src_embeds=jnp.asarray(src))
    got, aux = get_model(tc).forward(tc, tp, _t(toks), src_embeds=_t(src))
    assert get_model(tc) is encdec and float(aux) == 0.0
    _close(got, want, ATOL)
    with pytest.raises(AssertionError, match="src_embeds"):
        encdec.forward(tc, tp, _t(toks))


def test_prepare_encdec_state_matches_reference():
    """The encoder prefill fills cross K/V ``[L, B, S_src, kv, hd]`` as the
    reference's does."""
    jp, tp = _params()
    jc, tc = _cfgs()
    B, S = 2, 64
    src = _src(B, S // 8, jc.d_model)
    js, _ = JEG.make_decode_state(jc, B, S_max=S, page_size=4)
    ts, _ = EG.make_decode_state(tc, B, S_max=S, page_size=4, device="cpu")
    assert ts["cross_k"].shape == (tc.num_layers, B, S // 8, tc.n_kv, tc.hd)
    js = JEG.prepare_encdec_state(jc, jp, js, jnp.asarray(src))
    ts2 = EG.prepare_encdec_state(tc, tp, ts, _t(src))
    assert not ts["cross_k"].any()                 # the given state stays
    for k in ("cross_k", "cross_v"):
        _close(ts2[k], js[k], ATOL, k)


@pytest.mark.parametrize("fused", [False, True])
def test_megastep_matches_reference(fused):
    """After the encoder prefill, three K=8 megasteps (teacher forcing, a
    stop length on lane 1): tokens, table, block table and positions equal
    the reference's, the pools within STATE_ATOL.  ``fused_kernel=True``
    changes nothing: encdec's self attention stays on ``attend_local`` in
    both packages."""
    jp, tp = _params()
    jc, tc = _cfgs(fused_kernel=fused)
    B, S, ps, K = 3, 32, 4, 8
    rng = np.random.default_rng(2)
    tok0 = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
    forced = rng.integers(0, jc.vocab_size, (B, K)).astype(np.int32)
    fmask = np.zeros((B, K), bool)
    fmask[0, :5] = True
    fmask[2, :2] = True
    stop = np.array([S, 19, S], np.int32)
    src = _src(B, S // 8, jc.d_model)
    js, _ = JEG.make_decode_state(jc, B, S_max=S, page_size=ps)
    ts, _ = EG.make_decode_state(tc, B, S_max=S, page_size=ps, device="cpu")
    assert set(ts) == set(js)
    js = JEG.prepare_encdec_state(jc, jp, js, jnp.asarray(src))
    ts = EG.prepare_encdec_state(tc, tp, ts, _t(src))
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
        np.testing.assert_array_equal(
            ts["table"].table.numpy().astype(np.int64).astype(np.uint32),
            np.asarray(js["table"].table))
        for k in ("block_table", "pos", "active", "aborted", "seq_ids"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                          err_msg=k)
        _close(ts["pools"].k, js["pools"].k, STATE_ATOL, "pools")
        _close(ts["pools"].v, js["pools"].v, STATE_ATOL, "pools")
        jt, tt = jtoks[:, -1:], ttoks[:, -1:]
    assert not ts["active"][1]                   # stop length latched
    rep = EG.fallback_report(tc)
    assert rep == JEG.fallback_report(jc)
    assert rep["fused_kernel"] == (
        "cross-attention decode state not wired to the fused kernel"
        if fused else "off (cfg.fused_kernel=False)")


def test_megastep_equals_single_steps_bitwise():
    """K=8 megastep == 8 single steps inside the port, from a prefilled
    state: same tokens, same final state (pools and cross K/V
    included)."""
    _, tp = _params()
    _, tc = _cfgs()
    B, K = 2, 8
    tok0 = _t(np.random.default_rng(3).integers(
        0, tc.vocab_size, (B, 1)).astype(np.int32))
    s1, _ = EG.make_decode_state(tc, B, S_max=32, page_size=4, device="cpu")
    s1 = EG.prepare_encdec_state(tc, tp, s1, _t(_src(B, 4, tc.d_model)))
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
    for k in s1:
        a, b = s1[k], s2[k]
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert torch.equal(x, y), k


def test_bf16_logits_match_reference():
    """bf16 weights, ``src_embeds`` and activations on both sides: the
    port's logits within BF16_REL_TOL (relative, in the norm) of the
    reference's."""
    jp, tp = _params("bfloat16")
    jc, tc = _cfgs("bfloat16")
    assert tp["decoder"]["cross"]["wq"].dtype == torch.bfloat16
    src = _src(2, 8, jc.d_model)
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 32))
    want = np.asarray(j_encdec.forward(
        jc, jp, jnp.asarray(toks),
        src_embeds=jnp.asarray(src, jnp.bfloat16))[0], np.float32)
    got = encdec.forward(tc, tp, _t(toks),
                         src_embeds=_t(src).bfloat16())[0].numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < BF16_REL_TOL, rel
