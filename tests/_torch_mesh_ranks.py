"""Rank bodies of ``tests/test_torch_mesh.py``, run by
``repro_torch.launch.mesh.run_spmd`` in spawned gloo ranks on the CPU.
They import only the port (no JAX), and return numpy results for the test
to hold against the JAX package's."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.dist import collectives as C
from repro_torch.dist import ctx
from repro_torch.dist import sharding as SH
from repro_torch.dist import tp as TP
from repro_torch.launch import mesh as M
from repro_torch.models import convert
from repro_torch.models import moe as MOE
from repro_torch.serving import engine as EG
from repro_torch.serving import page_table as PT

S_MAX, PAGE_SIZE = 32, 4


def _np(t):
    return t.detach().float().numpy() if t.is_floating_point() \
        else t.detach().numpy()


def _leaves(state):
    for k in sorted(state):
        v = state[k]
        for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
            yield f"{k}.{i}", t


def _step_logits(cfg, params, rules, toks):
    """The reference test's loop: T single steps at positions t, fed
    ``toks[:, t]``; returns the logits [T, B, V] and the final state."""
    B, T = toks.shape
    state, _ = EG.make_decode_state(cfg, B, S_max=S_MAX, page_size=PAGE_SIZE,
                                    rules=rules, device="cpu")
    step = EG.make_serve_step(cfg, S_max=S_MAX, page_size=PAGE_SIZE,
                              rules=rules)
    out = []
    for t in range(T):
        pos = torch.full((B,), t, dtype=torch.int32)
        lg, state = step(params, state,
                         torch.as_tensor(toks[:, t:t + 1], dtype=torch.int32),
                         pos)
        out.append(_np(lg))
    return np.stack(out), state


def _megastep_vs_steps(cfg, params, rules, tok0, K):
    """K single steps (greedy, the abort latch) and one K-token megastep
    from the same fresh state: tokens and every state leaf must be equal
    bit for bit; returns (equal, the megastep's state, its tokens, the
    block-table mismatches)."""
    B = tok0.shape[0]
    tok0 = torch.as_tensor(tok0, dtype=torch.int32)
    state, _ = EG.make_decode_state(cfg, B, S_max=S_MAX, page_size=PAGE_SIZE,
                                    rules=rules, device="cpu")
    step = EG.make_serve_step(cfg, S_max=S_MAX, page_size=PAGE_SIZE,
                              rules=rules)
    st, tok, ref = state, tok0, []
    for _ in range(K):
        lg, st = step(params, st, tok, st["pos"])
        nxt = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
        tok = torch.where(st["aborted"][:, None], tok, nxt)
        ref.append(tok[:, 0])
    ref = torch.stack(ref, dim=1)
    state2, _ = EG.make_decode_state(cfg, B, S_max=S_MAX, page_size=PAGE_SIZE,
                                     rules=rules, device="cpu")
    mega = EG.make_serve_megastep(cfg, S_max=S_MAX, K=K, page_size=PAGE_SIZE,
                                  rules=rules)
    mtoks, mst = mega(params, state2, tok0)
    equal = torch.equal(mtoks, ref) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(_leaves(st),
                                                    _leaves(mst)))
    bad = 0 if "table" not in mst else int(
        PT.for_strategy("linear").verify_block_table(
            mst["table"], mst["seq_ids"], mst["pos"], mst["block_table"],
            page_size=PAGE_SIZE))
    return equal, mst, _np(mtoks), bad


def decode_rank(rank, arch, shape, axes, over, params_np, toks, tok0, K):
    """Both decode rule sets on this rank: the reference test's 10 steps
    in float32 and in the config's bf16 (with the fused kernel K1 on, its
    plain version on CPU tensors) on the same weights, then, in bf16, the
    megastep against K single steps."""
    mesh = M.make_mesh(shape, axes, "cpu")
    out = {}
    for table in ("serve_rules", "serve_manual_rules"):
        rules = getattr(SH, table)(mesh)
        cfg = dataclasses.replace(get_smoke_config(arch), **over)
        if table == "serve_manual_rules":
            cfg = dataclasses.replace(cfg, tp_impl="manual")
        specs = EG.mesh_param_specs(cfg, params_np, rules)
        f32 = dataclasses.replace(cfg, dtype="float32")
        params = convert.from_numpy_tree(params_np, f32, specs=specs,
                                         mesh=mesh)
        logits, state = _step_logits(f32, params, rules, toks)
        fcfg = dataclasses.replace(cfg, fused_kernel=True)
        params = convert.from_numpy_tree(params_np, fcfg, specs=specs,
                                         mesh=mesh)
        logits_bf16, _ = _step_logits(fcfg, params, rules, toks)
        equal, mst, mtoks, bad = _megastep_vs_steps(fcfg, params, rules,
                                                    tok0, K)
        out[table] = {
            "report": EG.fallback_report(cfg, rules),
            "fused_report": EG.fallback_report(fcfg, rules),
            "logits": logits, "logits_bf16": logits_bf16,
            "mega_equal": equal, "mega_tokens": mtoks,
            "verify": bad,
            "table": _np(mst["table"].table) if "table" in mst else None,
            "pool_shape": (tuple(state["pools"].k.shape)
                           if "pools" in state else None),
        }
    return out


def moe_block_rank(rank, moe_cfg_over, moe_p, moe_x, block_p, block_x,
                   positions):
    """moe_apply under train_rules and serve_rules on a (2, 4) mesh, and
    the manual block_apply_tp under train_rules on a (4, 2) mesh; the
    outputs gathered back to the full batch."""
    cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                              **moe_cfg_over)
    mesh = M.make_mesh((2, 4), ("data", "model"), "cpu")
    t = lambda a: torch.from_numpy(np.asarray(a))
    out = {}
    for name in ("train_rules", "serve_rules"):
        rules = getattr(SH, name)(mesh)
        p = SH.local_shard({k: t(v) for k, v in moe_p.items()},
                           MOE.moe_param_specs(cfg, rules), mesh)
        x_spec = SH.P() if rules.mode == "serve" else SH.P(("data",))
        x = SH.local_shard(t(moe_x), x_spec, mesh)
        with ctx.use_rules(rules):
            y, aux = MOE.moe_apply(p, x, cfg)
        if rules.mode != "serve":
            y = C.all_gather(y, "data", dim=0)
        out[name] = (_np(y), float(aux))

    bcfg = dataclasses.replace(get_smoke_config("qwen2.5-32b"),
                               dtype="float32", tp_impl="manual")
    mesh = M.make_mesh((4, 2), ("data", "model"), "cpu")
    rules = SH.train_rules(mesh)
    bp = convert.from_numpy_tree(block_p, bcfg, "cpu")
    p = SH.local_shard(bp, TP.block_param_specs(bcfg, rules, bp), mesh)
    xs = TP.batch_spec(rules, block_x.shape[0])
    x = SH.local_shard(t(block_x), xs, mesh)
    with ctx.use_rules(rules):
        y = TP.block_apply_tp(bcfg, p, x, torch.as_tensor(positions))
        assert TP._manual_tp(bcfg, rules, need_ff=True) == 2
    if xs != SH.P():
        y = C.all_gather(y, xs[0], dim=0)
    out["block"] = _np(y)
    return out


def dht_rank(rank, m_global, capacity, batches):
    """The mesh DHT over the ``model`` axis of 8 ranks: each batch is
    (ops, keys) of all ranks, of which this rank sends its slice."""
    from repro_torch.core import sharded as SHT
    mesh = M.make_mesh((8,), ("model",), "cpu")
    st, apply_fn = SHT.make_sharded_table(mesh, "model", m_global, capacity)
    rets = []
    for ops, keys in batches:
        n = ops.shape[0] // 8
        sl = slice(rank * n, (rank + 1) * n)
        st, ret, ovf = apply_fn(st, torch.as_tensor(ops[sl]),
                                torch.as_tensor(keys[sl]))
        rets.append((_np(ret), _np(ovf)))
    return {"rets": rets, "table": _np(st.table[0]),
            "num_keys": int(st.num_keys[0]),
            "num_tombs": int(st.num_tombs[0])}


def _batcher(cfg, params, rules, traffic):
    from repro_torch.launch.serve import ContinuousBatcher
    from repro_torch.serving.sched import Scheduler, synthetic_workload
    B, K, PS, max_len = traffic["batch"], traffic["K"], traffic["page_size"], \
        traffic["max_len"]
    sched = Scheduler(slots=B, page_size=PS, max_len=max_len, megastep_k=K)
    srv = ContinuousBatcher(cfg, params, batch=B, max_len=max_len,
                            page_size=PS, megastep_k=K,
                            verify_block_table=True, scheduler=sched,
                            n_pages=traffic["n_pages"], auto_refill=False,
                            seed=0, rules=rules, device="cpu")
    sched.submit_many(synthetic_workload(
        traffic["requests"], vocab_size=cfg.vocab_size, max_len=max_len,
        seed=0, prompt_len=traffic["prompt_len"],
        max_new=traffic["max_new"]))
    return srv


def _tables(state):
    t = state["table"]
    return (_np(t.table), int(t.num_keys), int(t.num_tombs),
            _np(state["block_table"]))


def batcher_rank(rank, arch, shape, axes, params_np, traffic, snap_round,
                 scaled):
    """``ContinuousBatcher(rules=)`` on this rank under both rule sets,
    held every round to a one-device batcher run here on the same
    weights: page table and block table equal; then the one-device state
    after ``snap_round`` cut into this rank's pieces (``shard_state``)
    gives one mesh step's logits (returned beside the one-device step's,
    and again with the config keys ``scaled`` set on both sides) and,
    re-hashed into a 2x pool on the mesh, this rank's piece of the
    one-device re-hash bit for bit."""
    mesh = M.make_mesh(shape, axes, "cpu")
    base = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               fused_kernel=True)
    one = _batcher(base, convert.from_numpy_tree(params_np, base, "cpu"),
                   None, traffic)
    rounds, snap = [], None
    while not one.sched.drained:
        one.step_round()
        rounds.append(_tables(one.state))
        if len(rounds) == snap_round:
            snap = (EG.clone_state(one.state), one.tokens.clone())
    out = {"rounds": len(rounds)}
    for table in ("serve_rules", "serve_manual_rules"):
        rules = getattr(SH, table)(mesh)
        cfg = base if table == "serve_rules" else \
            dataclasses.replace(base, tp_impl="manual")
        params = convert.from_numpy_tree(
            params_np, cfg, specs=EG.mesh_param_specs(cfg, params_np, rules),
            mesh=mesh)
        srv = _batcher(cfg, params, rules, traffic)
        i = 0
        while not srv.sched.drained:
            srv.step_round()
            got = _tables(srv.state)
            assert i < len(rounds) and all(
                np.array_equal(a, b) for a, b in zip(got, rounds[i])), \
                (table, i)
            i += 1
        assert i == len(rounds), (table, i)
        summary = srv.sched.summary()
        _, axes_ = EG.make_decode_state(cfg, traffic["batch"],
                                        traffic["max_len"], rules=rules,
                                        page_size=traffic["page_size"],
                                        n_pages=traffic["n_pages"])
        st1, tok = snap
        mst = EG.shard_state(cfg, st1, axes_, rules)
        step = EG.make_serve_step(cfg, S_max=traffic["max_len"], rules=rules,
                                  page_size=traffic["page_size"])
        lg, _ = step(params, EG.clone_state(mst), tok, mst["pos"])
        step1 = EG.make_serve_step(base, S_max=traffic["max_len"],
                                   page_size=traffic["page_size"])
        params1 = convert.from_numpy_tree(params_np, base, "cpu")
        lg1, _ = step1(params1, EG.clone_state(st1), tok, st1["pos"])
        sc, sc1 = (dataclasses.replace(c, **scaled) for c in (cfg, base))
        lg_s, _ = EG.make_serve_step(
            sc, S_max=traffic["max_len"], rules=rules,
            page_size=traffic["page_size"])(params, EG.clone_state(mst),
                                            tok, mst["pos"])
        lg1_s, _ = EG.make_serve_step(
            sc1, S_max=traffic["max_len"],
            page_size=traffic["page_size"])(params1, EG.clone_state(st1),
                                            tok, st1["pos"])
        m_pages = 2 * traffic["n_pages"]
        grown = EG.rebuild_page_table(EG.clone_state(mst), n_pages=m_pages)
        grown1 = EG.rebuild_page_table(EG.clone_state(st1), n_pages=m_pages)
        _, axes2 = EG.make_decode_state(cfg, traffic["batch"],
                                        traffic["max_len"], rules=rules,
                                        page_size=traffic["page_size"],
                                        n_pages=m_pages)
        want = EG.shard_state(cfg, grown1, axes2, rules)
        rebuilt_equal = all(
            torch.equal(a, b) for (_, a), (_, b) in zip(_leaves(grown),
                                                        _leaves(want)))
        out[table] = {
            "sampled": {r.req_id: list(r.sampled)
                        for r in srv.sched.finished},
            "summary": summary, "logits": _np(lg), "logits_one": _np(lg1),
            "logits_scaled": _np(lg_s), "logits_one_scaled": _np(lg1_s),
            "live": _np(st1["active"] & ~st1["aborted"]),
            "rebuilt_equal": rebuilt_equal}
    return out


def encdec_rank(rank, shape, axes, table, params, src, toks):
    """seamless on this rank of the mesh under ``table``: the encoder's
    prefill over the rank's weight shards, then T single steps fed
    ``toks[:, t]`` at positions t; returns the logits, the final page
    table, the cross K/V piece's shape and the fallback report."""
    cfg = dataclasses.replace(get_smoke_config("seamless-m4t-large-v2"),
                              dtype="float32")
    mesh = M.make_mesh(shape, axes, "cpu")
    rules = getattr(SH, table)(mesh)
    p = convert.from_numpy_tree(params, cfg,
                                specs=EG.mesh_param_specs(cfg, params, rules),
                                mesh=mesh)
    B, T = toks.shape
    state, _ = EG.make_decode_state(cfg, B, S_max=S_MAX, page_size=PAGE_SIZE,
                                    rules=rules, device="cpu")
    state = EG.prepare_encdec_state(cfg, p, state, torch.as_tensor(src),
                                    rules=rules)
    step = EG.make_serve_step(cfg, S_max=S_MAX, page_size=PAGE_SIZE,
                              rules=rules)
    out = []
    for t in range(T):
        lg, state = step(p, state,
                         torch.as_tensor(toks[:, t:t + 1], dtype=torch.int32),
                         torch.full((B,), t, dtype=torch.int32))
        out.append(_np(lg))
    return {"logits": np.stack(out), "table": _np(state["table"].table),
            "cross_shape": tuple(state["cross_k"].shape),
            "report": EG.fallback_report(cfg, rules)}
