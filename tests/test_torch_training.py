"""The port's training substrate against the JAX package's (analogs of
``tests/test_training.py``): checkpoint atomicity and round trips, restart
determinism, AdamW, clipping, gradient compression, the dedup data
pipeline and the fault-tolerance policies.

Beyond the reference's assertions: one ``optimizer.apply`` equals the
reference's on the same parameters and gradients within ``OPT_TOL``
(1e-6, relative); the n-gram fingerprints and the dedup table after every
``filter_batch`` equal the reference's bit for bit on the same tokens; the
quantizer's int8 codes equal the reference's; and a float32 checkpoint the
reference writes restores in the port.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.dist import compression as JCOMP
from repro.training import checkpoint as JCKPT
from repro.training import data as JD
from repro.training import optimizer as JOPT
from repro.training import train_step as JTS
from repro_torch.configs import get_smoke_config
from repro_torch.dist import compression as COMP
from repro_torch.dist import fault_tolerance as FT
from repro_torch.dist.table_shard import ShardManifest
from repro_torch.launch.train import TrainRunner
from repro_torch.models import convert
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import data as D
from repro_torch.training import optimizer as OPT
from repro_torch.training.train_step import init_state, make_train_step

OPT_TOL = 1e-6

torch.set_num_threads(1)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def u32(t) -> np.ndarray:
    return np.asarray(t).astype(np.int64).astype(np.uint32)


def test_checkpoint_roundtrip(tmp_path):
    """bf16 parameters (stored as their uint16 bits), f32 moments and the
    int32 counters all come back bit for bit, on the template's device."""
    cfg = get_smoke_config("qwen2.5-32b")
    state = init_state(cfg, gen(), "cpu")
    path = CKPT.save(str(tmp_path), 7, state)
    assert path.endswith("step_00000007")
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert leaves["params/embed/embedding"]["dtype"] == "bfloat16"
    assert leaves["opt/count"]["dtype"] == "int32"
    restored, step = CKPT.restore(str(tmp_path), state)
    assert step == 7
    for a, b in zip(CKPT._flatten(state).values(),
                    CKPT._flatten(restored).values()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert restored.params["embed"]["embedding"].requires_grad


def test_checkpoint_prune_and_latest(tmp_path):
    cfg = get_smoke_config("mamba2-2.7b")
    state = init_state(cfg, gen(), "cpu")
    for s in (1, 2, 3, 4):
        CKPT.save(str(tmp_path), s, state)
    CKPT.prune(str(tmp_path), keep=2)
    assert CKPT.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]


def test_reference_f32_checkpoint_restores(tmp_path):
    """A float32 train state the reference saves restores in the port, leaf
    for leaf, into the port's template of the same config."""
    jc = j_smoke("qwen2.5-32b")
    jc = type(jc)(**{**jc.__dict__, "dtype": "float32"})
    jstate, axes = JTS.init_state(jc, jax.random.PRNGKey(0))
    JCKPT.save(str(tmp_path), 5, jstate, axes)
    cfg = get_smoke_config("qwen2.5-32b")
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": "float32"})
    restored, step = CKPT.restore(str(tmp_path), init_state(cfg, gen(),
                                                            "cpu"))
    assert step == 5
    host = jax.tree.map(np.asarray, jstate)
    want = convert.train_state_from_numpy(host.params, host.opt.m,
                                          host.opt.v, host.opt.count, cfg,
                                          "cpu", step=host.step)
    got, ref = CKPT._flatten(restored), CKPT._flatten(want)
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k].detach()), k


def test_restart_determinism(tmp_path):
    """Crash/restart reproduces the uninterrupted run exactly: batches are a
    pure function of step, checkpoints capture all state."""
    cfg = get_smoke_config("codeqwen1.5-7b")
    step_fn = make_train_step(cfg)

    def run(state, start, n):
        losses = []
        for i in range(start, start + n):
            b = D.synth_batch(cfg, batch=2, seq_len=16, step=i,
                              device="cpu")
            state, m = step_fn(state, b)
            losses.append(float(m["loss"]))
        return state, losses

    _, full = run(init_state(cfg, gen(), "cpu"), 0, 6)
    s1, first = run(init_state(cfg, gen(), "cpu"), 0, 3)
    CKPT.save(str(tmp_path), 3, s1)
    s2, start = CKPT.restore(str(tmp_path), init_state(cfg, gen(), "cpu"))
    _, second = run(s2, start, 3)
    np.testing.assert_allclose(first + second, full, rtol=1e-6)


def test_runner_restores_on_start(tmp_path):
    """``TrainRunner`` resumes from its checkpoint: a 3-step run, then a run
    to 6, gives the uninterrupted 6-step run's losses."""
    cfg = get_smoke_config("qwen2.5-32b")
    kw = dict(batch=2, seq_len=16, seed=3)
    _, full = TrainRunner(cfg, device="cpu", dedup=True).run(steps=6, **kw)
    d = str(tmp_path)
    _, first = TrainRunner(cfg, ckpt_dir=d, ckpt_every=3,
                           device="cpu").run(steps=3, **kw)
    assert CKPT.latest_step(d) == 3
    _, second = TrainRunner(cfg, ckpt_dir=d, device="cpu").run(steps=6, **kw)
    np.testing.assert_allclose(first + second, full, rtol=1e-6)
    assert CKPT.latest_step(d) == 6


def test_adamw_decreases_loss_quadratic():
    cfg = OPT.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                          weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = OPT.init(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}      # d/dw ||w||^2
        params, opt, _ = OPT.apply(cfg, params, opt, grads)
    assert float(params["w"].abs().max()) < 0.5


def test_adamw_apply_matches_reference():
    """One step from a non-zero state (count 4, so the bias corrections
    and the schedule's warmup both act; gradients large enough to clip) on
    a bf16 matrix (decayed), an f32 matrix and an f32 vector (not
    decayed)."""
    rng = np.random.default_rng(2)
    shapes = {"a": (6, 5), "b": {"c": (7,), "d": (3, 4)}}

    def draw(scale, positive=False):
        def walk(t):
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            x = rng.normal(size=t) * scale
            return (np.abs(x) if positive else x).astype(np.float32)
        return walk(shapes)

    params, grads = draw(1.0), draw(3.0)
    m, v = draw(0.1), draw(0.1, positive=True)
    cfg = OPT.AdamWConfig(warmup_steps=10, total_steps=50)
    jcfg = JOPT.AdamWConfig(warmup_steps=10, total_steps=50)
    jparams = jax.tree.map(jnp.asarray, params)
    jparams["a"] = jparams["a"].astype(jnp.bfloat16)
    jp2, jo2, jmet = JOPT.apply(
        jcfg, jparams, JOPT.OptState(jax.tree.map(jnp.asarray, m),
                                     jax.tree.map(jnp.asarray, v),
                                     jnp.int32(4)), jax.tree.map(
            jnp.asarray, grads))

    tt = lambda t: ({k: tt(x) for k, x in t.items()} if isinstance(t, dict)
                    else torch.from_numpy(t.copy()))
    tparams = tt(params)
    tparams["a"] = tparams["a"].to(torch.bfloat16)
    tp2, to2, tmet = OPT.apply(cfg, tparams, OPT.OptState(
        tt(m), tt(v), torch.tensor(4, dtype=torch.int32)), tt(grads))
    assert int(to2.count) == 5
    for name in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                   rtol=OPT_TOL)
    for got, want in ((tp2, jp2), (to2.m, jo2.m), (to2.v, jo2.v)):
        for g, w in zip(OPT.leaves(got), jax.tree.leaves(want)):
            assert (g.dtype == torch.bfloat16) == (w.dtype == jnp.bfloat16)
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w, np.float32),
                                       rtol=OPT_TOL, atol=OPT_TOL)


def test_grad_clipping():
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = OPT.clip_by_global_norm(g, 1.0)
    assert float(norm) > 100
    assert abs(float(OPT.global_norm(clipped)) - 1.0) < 1e-5


@pytest.mark.parametrize("step", [0, 50, 99, 100, 2000, 10000, 12000])
def test_schedule_matches_reference(step):
    cfg = OPT.AdamWConfig()
    got = float(OPT.schedule(cfg, torch.tensor(step, dtype=torch.int32)))
    want = float(JOPT.schedule(JOPT.AdamWConfig(), jnp.int32(step)))
    np.testing.assert_allclose(got, want, rtol=OPT_TOL)


def test_compression_quantize_roundtrip():
    x = np.random.default_rng(0).normal(size=(5000,)).astype(np.float32)
    q, scale = COMP._quantize(torch.from_numpy(x))
    back = COMP._dequantize(q, scale, x.shape[0])
    err = np.abs(back.numpy() - x)
    blk_scale = np.abs(x).max() / 127
    assert err.max() <= blk_scale * 1.01
    jq, jscale = JCOMP._quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)


def test_compression_error_feedback_reduces_bias():
    """With error feedback, the *accumulated* quantization error stays
    bounded (residual carried, not lost); ``compress_leaf`` is the same
    round."""
    rng = np.random.default_rng(1)
    err = torch.zeros((1024,))
    total_in, total_out = 0.0, 0.0
    for i in range(20):
        g = torch.from_numpy(rng.normal(size=(1024,)).astype(np.float32)
                             ) * 1e-3
        sent, err2 = COMP.compress_leaf(g, err)
        x32 = g + err
        q, scale = COMP._quantize(x32)
        assert torch.equal(sent, COMP._dequantize(q, scale, 1024))
        err = err2
        total_in += float(g.sum())
        total_out += float(sent.sum())
    # everything not yet sent is still in the residual
    assert abs(total_in - (total_out + float(err.sum()))) < 1e-3
    assert COMP.compressed_bytes([torch.zeros(10), torch.zeros(3, 3)]) == \
        10 + 4 + 9 + 4


def test_dedup_filters_duplicates():
    cfg = get_smoke_config("qwen2.5-32b")
    dd = D.DedupState(m=1 << 12, window=8, device="cpu")
    b = D.synth_batch(cfg, batch=4, seq_len=64, step=0, device="cpu")
    keep1, frac1 = dd.filter_batch(b["tokens"])
    assert bool(keep1.all())
    keep2, frac2 = dd.filter_batch(b["tokens"])     # identical resubmission
    assert not bool(keep2.any())
    assert float(frac2) > 0.9


@pytest.mark.parametrize("S", [9, 10, 16, 32, 64, 100, 512, 1000, 4097])
def test_fingerprints_match_reference(S):
    rng = np.random.default_rng(S)
    toks = rng.integers(0, 152064, size=(3, S))
    want = np.asarray(JD._fingerprints(jnp.asarray(toks, jnp.int32)))
    got = D._fingerprints(torch.from_numpy(toks))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        D._offsets(S, D.NGRAM, D.FPR_PER_SEQ),
        np.asarray(jnp.linspace(0, max(S - D.NGRAM - 1, 0),
                                D.FPR_PER_SEQ).astype(jnp.int32)))


def test_dedup_table_matches_reference():
    """Batches with repeats, over a window of 2 (so deletes and tombstone
    reuse run): keep masks, duplicate fractions and the table equal the
    reference's after every ``filter_batch``."""
    rng = np.random.default_rng(9)
    jd = JD.DedupState(m=1 << 8, window=2)
    td = D.DedupState(m=1 << 8, window=2, device="cpu")
    prev = None
    for i in range(6):
        toks = rng.integers(0, 50, size=(4, 32))
        if prev is not None and i % 2:
            toks[:2] = prev[:2]          # resubmit part of the last batch
        prev = toks
        jkeep, jfrac = jd.filter_batch(jnp.asarray(toks, jnp.int32))
        tkeep, tfrac = td.filter_batch(torch.from_numpy(toks))
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
        assert float(tfrac) == pytest.approx(float(jfrac), abs=1e-7)
        np.testing.assert_array_equal(u32(td.table.table),
                                      np.asarray(jd.table.table))
        assert int(td.table.num_keys) == int(jd.table.num_keys)
        assert int(td.table.num_tombs) == int(jd.table.num_tombs)


def test_synth_batch_pure_function_of_seed_and_step():
    for arch in ("qwen2-vl-7b", "seamless-m4t-large-v2"):
        cfg = get_smoke_config(arch)
        a = D.synth_batch(cfg, batch=2, seq_len=32, step=5, seed=1,
                          device="cpu")
        b = D.synth_batch(cfg, batch=2, seq_len=32, step=5, seed=1,
                          device="cpu")
        c = D.synth_batch(cfg, batch=2, seq_len=32, step=6, seed=1,
                          device="cpu")
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k])
        assert not torch.equal(a["tokens"], c["tokens"])
        assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
        assert int(a["tokens"].min()) >= 0
        assert int(a["tokens"].max()) < cfg.vocab_size
    assert a["src_embeds"].shape == (2, 4, cfg.d_model)
    it = D.make_batch_iterator(cfg, batch=2, seq_len=32, seed=1,
                               start_step=5, device="cpu")
    step, first = next(it)
    assert step == 5 and torch.equal(first["tokens"], a["tokens"])


def test_straggler_monitor():
    mon = FT.StragglerMonitor(threshold=2.0, patience=2)
    verdicts = [mon.observe(i, 1.0) for i in range(5)]
    assert set(verdicts) == {"ok"}
    assert mon.observe(5, 5.0) == "straggler"
    assert mon.observe(6, 5.0) == "replan"
    assert mon.observe(7, 1.0) == "ok"


def test_watchdog_fires():
    wd = FT.StepWatchdog(deadline_s=0.0)
    wd.arm(3)
    with pytest.raises(FT.WatchdogTimeout):
        time.sleep(0.01)
        wd.check()


def test_elastic_plan():
    shape, axes = FT.elastic_plan(512, model_parallel=16)
    assert shape == (2, 16, 16) and axes == ("pod", "data", "model")
    shape, axes = FT.elastic_plan(240, model_parallel=16)  # lost a host
    assert shape == (15, 16) and axes == ("data", "model")
    assert FT.accum_for(256, 240) == 2


def test_elastic_table_plan_agrees_with_manifest():
    man = ShardManifest.balanced(4)
    new_man, shape, names = FT.elastic_table_plan(man, lost_shard=1,
                                                  model_parallel=16)
    assert len(new_man.live_shards()) == 3
    assert names == ("pod", "data", "model") and shape[0] == 3
    assert shape[0] * shape[1] * shape[2] == 3 * FT.POD_CHIPS
    one = ShardManifest.balanced(2)
    new_man, shape, names = FT.elastic_table_plan(one, lost_shard=1,
                                                  model_parallel=16)
    assert len(new_man.live_shards()) == 1
    assert names == ("data", "model") and shape == (16, 16)


def test_save_resave_merges_extra(tmp_path):
    """Re-saving a committed step with changed ``extra`` metadata lands it
    atomically; the leaves stay untouched."""
    state = {"w": torch.zeros((2,))}
    CKPT.save(str(tmp_path), 3, state, extra={"manifest": [0, 1]})
    path = CKPT.save(str(tmp_path), 3, {"w": torch.ones((2,))},
                     extra={"manifest": [0, 0]})
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["extra"]["manifest"] == [0, 0]
    restored, _ = CKPT.restore(str(tmp_path), state, step=3)
    np.testing.assert_array_equal(restored["w"].numpy(), np.zeros(2))


def test_sharded_checkpoint_commit_protocol(tmp_path):
    """save_shard is invisible until commit_sharded lands shards.json; the
    committed step round-trips every shard's payload + extras, and a
    re-commit with a new shard manifest replaces it atomically."""
    CKPT.save_shard(str(tmp_path), 4, 0,
                    {"keys": np.arange(3, dtype=np.uint32)},
                    extra={"n_cells": 32})
    CKPT.save_shard(str(tmp_path), 4, 1,
                    {"keys": torch.arange(5, dtype=torch.int32)})
    assert CKPT.latest_sharded_step(str(tmp_path)) is None   # not committed
    CKPT.commit_sharded(str(tmp_path), 4,
                        shard_manifest={"prefix_bits": 1, "owners": [0, 1]})
    assert CKPT.latest_sharded_step(str(tmp_path)) == 4
    shards, man, step = CKPT.restore_sharded(str(tmp_path))
    assert step == 4 and man["owners"] == [0, 1]
    assert [s["keys"].size for s in shards] == [3, 5]
    assert shards[0]["_extra"]["n_cells"] == 32
    CKPT.commit_sharded(str(tmp_path), 4,
                        shard_manifest={"prefix_bits": 1, "owners": [0, 0]})
    _, man, _ = CKPT.restore_sharded(str(tmp_path))
    assert man["owners"] == [0, 0]
