"""The families this slice serves, held against the JAX package: the MoE
family (granite-moe), gemma3's local/global ring layers (window 8, so the
ring wraps within 12 tokens), the vlm family's M-RoPE (qwen2-vl) and int8
KV pools (qwen2.5), each on its smoke config in f32 with the reference's
parameters converted.

- forward logits against the JAX ``lm.forward`` (the vlm case with
  ``patch_embeds`` and three distinct M-RoPE streams), ``atol=1e-4``;
- paged decode against the port's own forward, past the window for
  gemma3 (``DECODE_ATOL``; int8 KV quantizes each token's K and V to 127
  levels a head, so it gets ``INT8_DECODE_ATOL``);
- three K=8 megasteps with teacher forcing against the reference's, fused
  (K1's plain version here) and plain: tokens, table, block table and
  ``ring_pos`` equal; pools, int8 scales and rings within ``STATE_ATOL``;
- the port's megastep equal to K single steps bit for bit (the analog of
  ``tests/test_serving.py``'s ``MEGA_CASES``).
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
from repro_torch.models.registry import get_model
from repro_torch.serving import engine as EG
from repro_torch.serving import page_table as TPT

CASES = [("granite-moe-1b-a400m", {}), ("gemma3-12b", {}),
         ("qwen2-vl-7b", {}), ("qwen2.5-32b", {"kv_cache_dtype": "int8"})]
IDS = ["moe", "gemma3", "vlm", "int8"]
DECODE_ATOL = 1e-4
# int8 KV rounds each token's K and V to 127 levels of its head's max; the
# reference's own int8 decode differs from its forward by 0.042 on these
# inputs (logits up to 3.7); 6e-2 is tests/test_serving.py's tolerance for
# decode against forward
INT8_DECODE_ATOL = 6e-2
STATE_ATOL = 1e-5

torch.set_num_threads(1)


def _cfgs(arch, **over):
    jc = dataclasses.replace(j_smoke(arch), dtype="float32", **over)
    tc = dataclasses.replace(get_smoke_config(arch), dtype="float32", **over)
    return jc, tc


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        jc, tc = _cfgs(arch)
        jp, _ = j_lm.init(jc, jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, convert.from_numpy_tree(
            jax.tree.map(np.asarray, jp), tc, "cpu"))
    return _PARAMS[arch]


def _mrope(B, T, distinct):
    """[3,B,T] M-RoPE streams: the position on all three, or three
    distinct streams (t, h, w of a 2-row image grid)."""
    t = np.broadcast_to(np.arange(T)[None], (B, T))
    if not distinct:
        return np.broadcast_to(t[None], (3, B, T)).astype(np.int32)
    return np.stack([t // 4, (t // 2) % 2, t % 2 + t // 3]).astype(np.int32)


@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_forward_logits_match_reference(arch, over):
    jp, tp = _params(arch)
    jc, tc = _cfgs(arch, **over)
    assert get_model(tc).__name__ == "repro_torch.models.lm"
    B, T = 2, 12
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jc.vocab_size, (B, T))
    jkw, tkw = {}, {}
    if jc.family == "vlm":
        patches = rng.standard_normal((B, 3, jc.d_model)).astype(np.float32)
        mr = _mrope(B, T, distinct=True)
        jkw = dict(patch_embeds=jnp.asarray(patches),
                   mrope_positions=jnp.asarray(mr))
        tkw = dict(patch_embeds=torch.from_numpy(patches),
                   mrope_positions=torch.from_numpy(mr))
    want, _ = j_lm.forward(jc, jp, jnp.asarray(toks), **jkw)
    got, _ = get_model(tc).forward(tc, tp, torch.from_numpy(toks), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    if jc.family == "vlm":
        # the streams matter: with the position on all three the logits
        # move
        same, _ = get_model(tc).forward(
            tc, tp, torch.from_numpy(toks),
            patch_embeds=tkw["patch_embeds"],
            mrope_positions=torch.from_numpy(_mrope(B, T, distinct=False)))
        assert not torch.allclose(same, got, atol=1e-3)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_decode_matches_forward_in_the_port(arch, over, fused):
    """Paged decode (and ring decode for gemma3's local layers) token by
    token against the full forward of the same tokens."""
    _, tp = _params(arch)
    _, tc = _cfgs(arch, fused_kernel=fused, **over)
    B, T = 2, 12
    if tc.pattern_local:
        assert tc.local_window < T              # the ring wraps
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, tc.vocab_size, (B, T)))
    kw = {}
    if tc.family == "vlm":
        kw["mrope_positions"] = torch.from_numpy(_mrope(B, T, False))
    ref, _ = get_model(tc).forward(tc, tp, toks, **kw)
    state, _ = EG.make_decode_state(tc, B, S_max=64, page_size=8,
                                    device="cpu")
    step = EG.make_serve_step(tc, S_max=64, page_size=8)
    atol = INT8_DECODE_ATOL if tc.kv_cache_dtype == "int8" else DECODE_ATOL
    for t in range(T):
        pos = torch.full((B,), t, dtype=torch.int32)
        args = (tp, state, toks[:, t:t + 1].to(torch.int32), pos)
        if tc.family == "vlm":
            args += (pos[None, :, None].expand(3, B, 1),)
        logits, state = step(*args)
        np.testing.assert_allclose(logits.numpy(), ref[:, t].numpy(),
                                   atol=atol, rtol=DECODE_ATOL)


def _float_leaves_close(js, ts, keys):
    for k in keys:
        if k not in ts:
            continue
        for a, b in zip(ts[k], js[k]) if isinstance(ts[k], tuple) else [
                (ts[k], js[k])]:
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b).astype(np.float32),
                                       atol=STATE_ATOL, err_msg=k)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_megastep_matches_reference(arch, over, fused):
    """Three K=8 megasteps (the first with teacher forcing, a stop length
    on lane 1): tokens, table, block table, positions and ``ring_pos``
    equal the reference's; the float leaves within STATE_ATOL."""
    jp, tp = _params(arch)
    jc, tc = _cfgs(arch, fused_kernel=fused, **over)
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
    jm = jax.jit(JEG.make_serve_megastep(jc, S_max=S, K=K, page_size=ps))
    tm = EG.make_serve_megastep(tc, S_max=S, K=K, page_size=ps)
    jt, tt = jnp.asarray(tok0), torch.from_numpy(tok0)
    zeros = (np.zeros_like(forced), np.zeros_like(fmask))
    for r in range(3):
        f = (forced, fmask) if r == 0 else zeros
        jtoks, js = jm(jp, js, jt, jnp.asarray(stop), jnp.asarray(f[0]),
                       jnp.asarray(f[1]))
        ttoks, ts = tm(tp, ts, tt, torch.from_numpy(stop),
                       torch.from_numpy(f[0]), torch.from_numpy(f[1]))
        np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
        np.testing.assert_array_equal(
            ts["table"].table.numpy().astype(np.int64).astype(np.uint32),
            np.asarray(js["table"].table))
        for k in ("block_table", "pos", "active", "aborted", "seq_ids",
                  "ring_pos"):
            if k in ts:
                np.testing.assert_array_equal(ts[k].numpy(),
                                              np.asarray(js[k]), err_msg=k)
        _float_leaves_close(js, ts, ("pools", "pool_scales", "ring_k",
                                     "ring_v"))
        jt, tt = jtoks[:, -1:], ttoks[:, -1:]
    assert not ts["active"][1]                   # stop length latched
    if tc.pattern_local:
        assert int(ts["pos"].max()) > 2 * tc.local_window
    if tc.kv_cache_dtype == "int8":
        assert ts["pools"].k.dtype == torch.int8
        assert ts["pool_scales"].k.dtype == torch.bfloat16


@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_megastep_equals_single_steps_bitwise(arch, over):
    """K=8 megastep == 8 single steps inside the port, for K1's path and
    the plain path: same tokens, same final state (pools, scales and rings
    included)."""
    _, tp = _params(arch)
    for fused in (False, True):
        _, tc = _cfgs(arch, fused_kernel=fused, **over)
        B, K = 2, 8
        tok0 = torch.from_numpy(np.random.default_rng(3).integers(
            0, tc.vocab_size, (B, 1)).astype(np.int32))
        s1, _ = EG.make_decode_state(tc, B, S_max=32, page_size=4,
                                     device="cpu")
        s2 = EG.clone_state(s1)
        step = EG.make_serve_step(tc, S_max=32, page_size=4)
        tok, outs = tok0, []
        for _ in range(K):
            pos = s1["pos"]
            args = (tp, s1, tok, pos)
            if tc.family == "vlm":
                args += (pos[None, :, None].expand(3, B, 1),)
            logits, s1 = step(*args)
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
        assert int(TPT.for_strategy("linear").verify_block_table(
            s2["table"], s2["seq_ids"], s2["pos"], s2["block_table"],
            page_size=4)) == 0


def test_rebuild_moves_scales_and_keeps_rings():
    """rebuild_page_table on an int8 state moves the scales with their
    pages as the reference does (fill 1); on a gemma3 state it leaves
    the ring leaves as they are."""
    for arch, over in (("qwen2.5-32b", {"kv_cache_dtype": "int8"}),
                       ("gemma3-12b", {})):
        jp, tp = _params(arch)
        jc, tc = _cfgs(arch, **over)
        B, S, ps = 2, 16, 4
        toks = np.random.default_rng(4).integers(0, jc.vocab_size, (B, 6))
        js, _ = JEG.make_decode_state(jc, B, S_max=S, page_size=ps)
        ts, _ = EG.make_decode_state(tc, B, S_max=S, page_size=ps,
                                     device="cpu")
        jm = jax.jit(JEG.make_serve_megastep(jc, S_max=S, K=6, page_size=ps))
        tm = EG.make_serve_megastep(tc, S_max=S, K=6, page_size=ps)
        forced = np.concatenate([toks[:, 1:], np.zeros((B, 1), np.int64)],
                                1).astype(np.int32)
        fm = np.ones((B, 6), bool)
        _, js = jm(jp, js, jnp.asarray(toks[:, :1], jnp.int32), None,
                   jnp.asarray(forced), jnp.asarray(fm))
        _, ts = tm(tp, ts, torch.from_numpy(toks[:, :1].astype(np.int32)),
                   None, torch.from_numpy(forced), torch.from_numpy(fm))
        n = ts["pools"].k.shape[1] * 2
        jr = JEG.rebuild_page_table(js, n_pages=n)
        tr = EG.rebuild_page_table(ts, n_pages=n, use_kernel=True)
        np.testing.assert_array_equal(tr["block_table"].numpy(),
                                      np.asarray(jr["block_table"]))
        _float_leaves_close(jr, tr, ("pools", "pool_scales", "ring_k",
                                     "ring_v"))
        if "ring_k" in ts:
            assert tr["ring_k"] is ts["ring_k"]
            assert torch.equal(tr["ring_pos"], ts["ring_pos"])
