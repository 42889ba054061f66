"""The port's mesh on the CPU: 8 ``gloo`` ranks per test
(``repro_torch.launch.mesh.run_spmd``, the rank bodies in
``tests/_torch_mesh_ranks.py``), held against the JAX package on the same
numpy inputs.

- decode on a mesh, for the reference's cases of
  ``tests/test_mesh.py::test_manual_decode_matches_gspmd`` under both rule
  sets, 10 steps on the config's bf16 weights (the reference's bf16 init):
  in float32, each step's logits within ``F32_REL_TOL`` (relative, in the
  norm) of the reference's single-device ``make_serve_step`` in float32;
  in bf16, within ``BF16_REL_TOL`` or ``BF16_OWN_ERR_FACTOR`` times the
  reference's own bf16 distance from its float32 logits, whichever is
  larger, of the reference's single-device step in bf16.  Then, in bf16,
  the megastep against K single steps bit for bit on the same mesh,
  tokens and every state leaf, the block table verified against the
  wait-free lookup; every rank with the same logits and page table;
- ``moe_apply`` under ``train_rules`` and ``serve_rules`` and the manual
  ``block_apply_tp`` against the reference's single-shard results
  (``atol=2e-5, rtol=1e-4`` in f32, the reference tests');
- the mesh DHT against the reference's ``core/sharded.py`` on 8 fake CPU
  devices (a subprocess), bit for bit.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_ranks as R
from _subproc import run_python
from repro.configs import get_smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models.registry import get_model as j_get_model
from repro.serving import engine as JEG
from repro_torch.launch.mesh import run_spmd

TIMEOUT_S = 60     # the DHT's reference subprocess; the test took 13 s
B, T, K = 2, 10, 8
# float32: the merge of the ranks' attention partials sums the o partial
# in bf16, as the reference's does, so a mesh is not within 1e-4 of one
# device even in float32; these cases read 1.3e-6 (mamba2, no attention)
# to 6.6e-3 (int8) relative in the norm (CPU, 8 ranks)
F32_REL_TOL = 1e-2
# bf16: the reference test's atol 5e-2 / rtol 1e-2 does not hold across
# the packages: the two round the same products in another order (XLA
# fuses bf16 chains in f32), so the port's one-device bf16 logits already
# exceed it on mamba2 and zamba2, as the reference's own bf16 logits do
# against its float32 ones; and on granite-moe the gspmd layout's bf16
# psum of the FFN-width partials flips router choices, which fails the
# reference's own gspmd-vs-manual check (210 of 5120 elements, as here).
# So the bound is ``tests/test_torch_ssm.py``'s: 2e-2 relative in the
# norm, or 1.5 times the reference's own bf16 error where that is larger
# (readings 9.2e-3 to 2.7e-2; granite-moe's gspmd 0.189 of its 0.205,
# its float32 run 3.9e-3)
BF16_REL_TOL = 2e-2
BF16_OWN_ERR_FACTOR = 1.5

CASES = {
    "dense": ("qwen2.5-32b", (2, 2, 2), ("pod", "data", "model"), {}),
    "moe": ("granite-moe-1b-a400m", (4, 2), ("data", "model"), {}),
    "int8": ("qwen2.5-32b", (4, 2), ("data", "model"),
             {"kv_cache_dtype": "int8"}),
    "kv_rep": ("qwen2.5-32b", (2, 4), ("data", "model"), {}),
    "gemma3": ("gemma3-12b", (2, 2, 2), ("pod", "data", "model"), {}),
    "zamba2": ("zamba2-1.2b", (4, 2), ("data", "model"), {}),
    # beyond the reference test's cases: the vlm family's M-RoPE, and the
    # ssm family, which both rule sets serve on the gspmd step (its mamba
    # state per lane over data and head-sharded over model)
    "vlm": ("qwen2-vl-7b", (4, 2), ("data", "model"), {}),
    "mamba2": ("mamba2-2.7b", (2, 2, 2), ("pod", "data", "model"), {}),
}
# the manual-decode gate's refusal for the ssm family (the reference's)
SSM_REASON = "attention-free SSM stack: no model-axis work in the region"


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _rel(got, want):
    """The largest of the steps' relative errors in the norm."""
    return max(float(np.linalg.norm(g - w) / np.linalg.norm(w))
               for g, w in zip(got, want))


def _reference_logits(cfg, params, toks):
    """The reference's single-device decode: T steps at positions t."""
    state, _ = JEG.make_decode_state(cfg, B, S_max=R.S_MAX,
                                     page_size=R.PAGE_SIZE)
    step = jax.jit(JEG.make_serve_step(cfg, S_max=R.S_MAX,
                                       page_size=R.PAGE_SIZE))
    out = []
    for t in range(T):
        lg, state = step(params, state, toks[:, t:t + 1],
                         jnp.full((B,), t, jnp.int32))
        out.append(np.asarray(lg))
    return np.stack(out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_decode_matches_reference(case):
    import dataclasses
    arch, shape, axes, over = CASES[case]
    cfg_bf = dataclasses.replace(j_smoke(arch), **over)
    cfg = dataclasses.replace(cfg_bf, dtype="float32")
    params_bf, _ = j_get_model(cfg_bf).init(cfg_bf, jax.random.PRNGKey(0))
    params = _f32(params_bf)
    toks = jax.random.randint(jax.random.PRNGKey(1), (B, T), 0,
                              cfg.vocab_size)
    tok0 = jax.random.randint(jax.random.PRNGKey(1), (B, 1), 0,
                              cfg.vocab_size)
    ref = _reference_logits(cfg, params, toks)
    ref_bf = _reference_logits(cfg_bf, params_bf, toks).astype(np.float32)
    bf16_tol = max(BF16_REL_TOL, BF16_OWN_ERR_FACTOR * _rel(ref_bf, ref))
    outs = run_spmd(R.decode_rank, int(np.prod(shape)),
                    (arch, shape, axes, over, params, np.asarray(toks),
                     np.asarray(tok0), K))
    for table in ("serve_rules", "serve_manual_rules"):
        r0 = outs[0][table]
        if table == "serve_manual_rules":
            assert r0["report"]["decode_tp"] == (
                SSM_REASON if cfg.family == "ssm" else "ok"), r0["report"]
        rel = _rel(r0["logits"], ref)
        assert rel <= F32_REL_TOL, (case, table, rel)
        rel = _rel(r0["logits_bf16"], ref_bf)
        assert rel <= bf16_tol, (case, table, rel, bf16_tol)
        for rank, o in enumerate(outs):
            got = o[table]
            for k in ("logits", "logits_bf16", "table", "mega_tokens"):
                np.testing.assert_array_equal(
                    got[k], r0[k], err_msg=f"{case}/{table}/{rank}/{k}")
            assert got["mega_equal"], (case, table, rank)
            assert got["verify"] == 0, (case, table, rank)
    if cfg.family == "ssm":
        return
    # the pools are this rank's pieces: pages over every axis (gspmd) or
    # (pod, data) with heads over model (manual, kv tiled by kv_rep)
    n = int(np.prod(shape))
    g, m = outs[0]["serve_rules"], outs[0]["serve_manual_rules"]
    tp = dict(zip(axes, shape))["model"]
    kv_st = cfg.n_kv * max(1, tp // cfg.n_kv if cfg.n_kv % tp else 1)
    assert g["pool_shape"][3] == cfg.n_kv
    assert m["pool_shape"][1] * n // tp == g["pool_shape"][1] * n
    assert m["pool_shape"][3] == kv_st // tp
    if case == "kv_rep":
        assert m["fused_report"]["fused_kernel"].startswith("kv_rep>1")
    else:
        assert m["fused_report"]["fused_kernel"] == "ok"


def test_moe_and_block_tp_match_reference():
    """The reference's ``test_moe_sharded_matches_single`` (granite-moe's
    4 experts, expert-parallel over a 4-wide model axis) under
    ``train_rules`` and ``serve_rules`` (FFN width sharded over ``data``),
    and ``test_manual_tp_matches_baseline`` (qwen2.5 smoke in f32, tp 2)."""
    import dataclasses
    cfg = j_smoke("granite-moe-1b-a400m")
    key = jax.random.PRNGKey(0)
    p, _ = JMOE.moe_init(key, cfg, jnp.float32)
    x = jax.random.normal(key, (4, 8, cfg.d_model), jnp.float32)
    y0, aux0 = JMOE.moe_apply(p, x, cfg)
    bcfg = dataclasses.replace(j_smoke("qwen2.5-32b"), dtype="float32",
                               tp_impl="manual")
    bp, _ = JL.block_init(key, bcfg, jnp.float32)
    bx = jax.random.normal(jax.random.fold_in(key, 1), (4, 16, bcfg.d_model))
    positions = jnp.arange(16)[None, :]
    ref = JL.block_apply(bp, bx, positions, bcfg)
    outs = run_spmd(R.moe_block_rank, 8,
                    ({}, _f32(p), np.asarray(x), _f32(bp), np.asarray(bx),
                     np.asarray(positions)))
    # the aux loss is the reference's sharded one: each data shard's own
    # (a product of means, so not the full batch's) averaged over data
    aux_train = np.mean([float(JMOE.moe_apply(p, x[i:i + 2], cfg)[1])
                         for i in (0, 2)])
    for o in outs:
        for name, want in (("train_rules", aux_train),
                           ("serve_rules", float(aux0))):
            y, aux = o[name]
            np.testing.assert_allclose(y, np.asarray(y0), atol=2e-5,
                                       rtol=1e-4, err_msg=name)
            np.testing.assert_allclose(aux, want, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(o["block"], np.asarray(ref), atol=2e-5,
                                   rtol=1e-4)


DHT_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
assert len(jax.devices()) == 8, jax.devices()
from repro.core import sharded as SHT
d = np.load(sys.argv[1])
mesh = jax.make_mesh((8,), ("model",))
st, apply_fn = SHT.make_sharded_table(mesh, "model", int(d["m_global"]),
                                      int(d["capacity"]))
out = {}
for i in range(int(d["n"])):
    st, ret, ovf = apply_fn(st, jnp.asarray(d[f"ops{i}"]),
                            jnp.asarray(d[f"keys{i}"]))
    out[f"ret{i}"], out[f"ovf{i}"] = np.asarray(ret), np.asarray(ovf)
out["table"] = np.asarray(st.table)
out["num_keys"] = np.asarray(st.num_keys)
out["num_tombs"] = np.asarray(st.num_tombs)
np.savez(sys.argv[2], **out)
"""


def _dht_batches(rng, n_per_rank=48):
    """Inserts, lookups of present and absent keys, deletes and reinserts
    (tombstone reuse), with duplicates inside a batch and buckets past the
    capacity (overflow)."""
    B = 8 * n_per_rank
    base = rng.choice(1 << 27, size=3 * B, replace=False).astype(np.uint32)
    ins = base[:B].copy()
    ins[5::17] = ins[3]                              # duplicates
    mixed_ops = rng.integers(0, 3, size=B).astype(np.int32)
    mixed_keys = np.where(rng.random(B) < 0.5, base[:B], base[B:2 * B])
    return [
        (np.full(B, 1, np.int32), ins),
        (np.zeros(B, np.int32), np.concatenate([base[:B // 2],
                                                base[2 * B:2 * B + B // 2]])),
        (np.full(B, 2, np.int32), base[:B][::-1].copy()),
        (np.full(B, 1, np.int32), base[B:2 * B]),
        (mixed_ops, mixed_keys.astype(np.uint32)),
        (np.zeros(B, np.int32), base[B:2 * B]),
    ]


def test_mesh_dht_matches_reference():
    """``make_sharded_table`` over 8 ranks against the reference's on 8
    fake devices: every shard's table words, key and tombstone counts, and
    every batch's returns and overflow flags, bit for bit."""
    m_global, capacity = 1024, 10
    batches = _dht_batches(np.random.default_rng(0))
    with tempfile.TemporaryDirectory() as d:
        inp = os.path.join(d, "in.npz")
        outp = os.path.join(d, "out.npz")
        np.savez(inp, m_global=m_global, capacity=capacity, n=len(batches),
                 **{f"ops{i}": o for i, (o, _) in enumerate(batches)},
                 **{f"keys{i}": k for i, (_, k) in enumerate(batches)})
        run = run_python(["-c", DHT_SCRIPT, inp, outp], devices=8,
                         timeout=TIMEOUT_S)
        assert run.returncode == 0, run.stderr
        ref = dict(np.load(outp))
    outs = run_spmd(R.dht_rank, 8, (m_global, capacity, batches))
    n = batches[0][0].shape[0] // 8
    for i in range(len(batches)):
        ret = np.concatenate([o["rets"][i][0] for o in outs])
        ovf = np.concatenate([o["rets"][i][1] for o in outs])
        np.testing.assert_array_equal(ret, ref[f"ret{i}"], err_msg=str(i))
        np.testing.assert_array_equal(ovf, ref[f"ovf{i}"], err_msg=str(i))
    assert any(ref[f"ovf{i}"].any() for i in range(len(batches)))
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(
            o["table"], ref["table"][r].astype(np.uint32).view(np.int32))
        assert o["num_keys"] == int(ref["num_keys"][r])
        assert o["num_tombs"] == int(ref["num_tombs"][r])
    assert sum(o["num_tombs"] for o in outs) > 0 and n


def test_batcher_serves_on_a_mesh():
    """``ContinuousBatcher(rules=)`` on a (2, 2) mesh under both rule sets
    (4 ranks, qwen2.5 smoke in float32, K1's plain version): every request
    completes with 0 aborts, the page table and block table equal a
    one-device run's every round, every rank samples the same tokens;
    a one-device state cut into the ranks' pieces steps to the
    one-device logits (within ``F32_REL_TOL``), with ``logits_scaling``
    set on both sides too (the reference has no such key: the one-device
    port is the oracle), and re-hashes into a 2x pool to the pieces of
    the one-device re-hash, bit for bit."""
    import dataclasses
    arch = "qwen2.5-32b"
    cfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    params, _ = j_get_model(cfg).init(cfg, jax.random.PRNGKey(0))
    traffic = dict(batch=4, K=4, page_size=4, max_len=48, n_pages=64,
                   requests=8, prompt_len=(4, 16), max_new=(4, 20))
    outs = run_spmd(R.batcher_rank, 4,
                    (arch, (2, 2), ("data", "model"), _f32(params), traffic,
                     3, {"logits_scaling": 2.0}))
    for table in ("serve_rules", "serve_manual_rules"):
        r0 = outs[0][table]
        s = r0["summary"]
        assert s["completed"] == traffic["requests"] and s["aborts"] == 0
        live = r0["live"]
        rel = _rel([r0["logits"][live]], [r0["logits_one"][live]])
        assert rel <= F32_REL_TOL, (table, rel)
        rel = _rel([r0["logits_scaled"][live]],
                   [r0["logits_one_scaled"][live]])
        assert rel <= F32_REL_TOL, (table, "logits_scaling", rel)
        np.testing.assert_allclose(r0["logits_one_scaled"],
                                   r0["logits_one"] / 2.0, rtol=1e-6)
        for o in outs:
            assert o[table]["sampled"] == r0["sampled"], table
            assert o[table]["rebuilt_equal"], table
