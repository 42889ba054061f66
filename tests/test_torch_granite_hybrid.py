"""granitemoehybrid's ``layer_types`` stack in the port (granite-4.0-h-small
at small sizes, on the CPU, seeded): the full-sequence forward and the
decode through the page table against the benchmark's plain float32
reference (``perfbench/reference/granitemoehybrid.py``), each new key of
``ModelConfig`` alive, the mamba state updated in place with frozen and
refused lanes kept bit for bit, a K-token megastep equal to K single
steps, the spans of the stack, and the mesh refused.  Imports no JAX."""
import dataclasses

import numpy as np
import pytest
import torch

from perfbench import modules, port
from perfbench.reference import weights as RW
from perfbench.tests import small
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import hybrid, lm
from repro_torch.obs import trace as OT
from repro_torch.serving import engine as EG

torch.set_num_threads(1)

CONFIG = "granite-4.0-h-small.stage20"
PS = 4


def _bench(dtype="float32"):
    """The benchmark's configuration at the small sizes, its reference,
    draws and the port's config and parameters (in ``dtype``)."""
    cfg = small.config(CONFIG)
    w = RW.draw(cfg, 2**31 + 29, "cpu")
    pc = dataclasses.replace(port.model_config(cfg), dtype=dtype)
    prm = port.params(cfg, w)
    if dtype == "float32":
        prm = hybrid.nn.tree_map(lambda t: t.float(), prm)
    return cfg, w, pc, prm


def _reference_logits(cfg, w, seqs):
    """The reference's logits [sum of lengths, V] of every sequence."""
    ref = modules.reference(cfg)
    return (ref.hidden(cfg, w, seqs) @ ref.head(cfg, w).float()
            / cfg["logits_scaling"])


def test_forward_matches_reference_over_several_chunks():
    """The port's forward of sequences of 5 and 40 tokens (three SSD
    chunks of 16, the last one short) against the reference's.  Both in
    float32; what differs is summation order (the port's SSD against
    the reference's minimal SSD, the MoE's combine): ~1e-7 on logits of
    order 0.1-1, so 1e-5 leaves a hundredfold room and still refuses a
    bf16 step anywhere (~1e-3)."""
    cfg, w, pc, prm = _bench()
    rng = np.random.default_rng(4)
    for n in (5, 40):
        seq = rng.integers(0, cfg["vocab_size"], n)
        got, _ = hybrid.forward(pc, prm, torch.as_tensor(seq)[None])
        want = _reference_logits(cfg, w, [seq])
        assert torch.allclose(got[0], want, atol=1e-5, rtol=0)


def test_prefill_then_decode_matches_reference(monkeypatch):
    """Three lanes prefill prompts of different lengths through the
    megastep's teacher forcing, then decode greedily through the page
    table (K1's plain version); every step's logits, read where the
    engine makes them, against the reference's full forward over prompt
    and served tokens.  Float32 on both sides: 1e-5, the forward's test's
    bound for summation order, here through the recurrence and the
    pages."""
    cfg, w, _, prm = _bench()
    pc = dataclasses.replace(port.model_config(cfg), dtype="float32",
                             fused_kernel=True)
    B, K, S = 3, 8, 48
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, pc.vocab_size, n) for n in (3, 9, 14)]
    seen = []
    real = lm._logits

    def record(cfg_, params, x):
        out = real(cfg_, params, x)
        seen.append(out[:, 0].clone())
        return out
    monkeypatch.setattr(lm, "_logits", record)
    state, _ = EG.make_decode_state(pc, B, S_max=S, page_size=PS,
                                    device="cpu")
    mega = EG.make_serve_megastep(pc, S_max=S, K=K, page_size=PS)
    forced = np.zeros((B, 16), np.int32)
    fmask = np.zeros((B, 16), bool)
    for b, p in enumerate(prompts):
        forced[b, :len(p) - 1] = p[1:]
        fmask[b, :len(p) - 1] = True
    tok = torch.as_tensor(np.array([[p[0]] for p in prompts], np.int32))
    streams = [[] for _ in range(B)]
    for r in range(4):
        sl = slice(r * K, (r + 1) * K)
        f = (torch.as_tensor(forced[:, sl]), torch.as_tensor(fmask[:, sl])) \
            if r < 2 else (None, None)
        toks, state = mega(prm, state, tok, None, *f)
        for b in range(B):
            streams[b] += toks[b].tolist()
        tok = toks[:, -1:]
    logits = torch.stack(seen, dim=1)                      # [B, 32, V]
    seqs = [np.concatenate([[p[0]], s[:-1]]) for p, s in zip(prompts,
                                                             streams)]
    for b, p in enumerate(prompts):
        assert streams[b][:len(p) - 1] == list(p[1:])     # forced prefill
    want = _reference_logits(cfg, w, seqs).reshape(B, 4 * K, -1)
    assert torch.allclose(logits, want, atol=1e-5, rtol=0), \
        (logits - want).abs().max()
    # greedy past the prompt: each served token is the reference's best
    for b, p in enumerate(prompts):
        for t in range(len(p) - 1, 4 * K):
            gap = want[b, t].max() - want[b, t, streams[b][t]]
            assert gap <= 1e-5


def _smoke(**over):
    cfg = dataclasses.replace(get_smoke_config("granite-4.0-h-small"),
                              dtype="float32", **over)
    return cfg


NEW_KEYS = {
    "attention_multiplier": dict(attention_multiplier=0.5),
    "embedding_multiplier": dict(embedding_multiplier=12.0),
    "residual_multiplier": dict(residual_multiplier=0.22),
    "logits_scaling": dict(logits_scaling=16.0),
    "rms_norm_eps": dict(rms_norm_eps=1e-2),
    "nope": dict(position_embedding="nope"),
}
DEFAULTS = dict(attention_multiplier=0.0, embedding_multiplier=1.0,
                residual_multiplier=1.0, logits_scaling=1.0,
                rms_norm_eps=1e-6, position_embedding="rope")


def _decode_logits(cfg, prm, toks):
    st, _ = EG.make_decode_state(cfg, toks.shape[0], S_max=16, page_size=PS,
                                 device="cpu")
    step = EG.make_serve_step(cfg, S_max=16, page_size=PS)
    out = []
    for t in range(toks.shape[1]):
        lg, st = step(prm, st, toks[:, t:t + 1], st["pos"])
        out.append(lg)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("key", sorted(NEW_KEYS) + ["shared_expert"])
def test_each_new_key_changes_the_output(key):
    """With every new key at its default, then one set in turn: the
    forward's and the decode's logits move, so none of them is dead
    (the shared expert: the same weights with and without it)."""
    base = _smoke(**DEFAULTS)
    prm = hybrid.init(base, torch.Generator().manual_seed(1), "cpu")
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, base.vocab_size, (2, 6)).astype(np.int32))
    if key == "shared_expert":
        cfg, prm2 = base, prm
        prm = dict(prm, ffn=dict(prm["ffn"], moe={
            k: v for k, v in prm["ffn"]["moe"].items() if k != "shared"}))
    else:
        cfg, prm2 = dataclasses.replace(base, **NEW_KEYS[key]), prm
    f0, _ = hybrid.forward(base, prm, toks.long())
    f1, _ = hybrid.forward(cfg, prm2, toks.long())
    assert not torch.allclose(f0, f1, atol=1e-6, rtol=0)
    d0, d1 = _decode_logits(base, prm, toks), _decode_logits(cfg, prm2, toks)
    assert not torch.allclose(d0, d1, atol=1e-6, rtol=0)
    torch.testing.assert_close(d1, f1, atol=1e-5, rtol=1e-5)


def _ssm_copy(state):
    return [t.clone() for t in state["ssm"]]


def test_frozen_and_refused_lanes_keep_their_mamba_state_bitwise():
    """bf16, four lanes over a pool too small for their second pages: the
    step at the page crossing refuses some lanes, and one lane is
    inactive.  Those lanes' ``h`` and conv tails are the same bits after
    the step, the others' moved; every leaf of the mamba state is the
    same storage before and after (one copy, updated in place)."""
    cfg = dataclasses.replace(get_smoke_config("granite-4.0-h-small"),
                              fused_kernel=True)
    prm = hybrid.init(cfg, torch.Generator().manual_seed(2), "cpu")
    B = 4
    st, _ = EG.make_decode_state(cfg, B, S_max=16, page_size=PS, n_pages=5,
                                 device="cpu")
    step = EG.make_serve_step(cfg, S_max=16, page_size=PS)
    ptrs = [t.data_ptr() for t in st["ssm"]]
    tok = torch.arange(B, dtype=torch.int32)[:, None] + 7
    for _ in range(PS):                 # the first page of every lane
        lg, st = step(prm, st, tok, st["pos"])
        tok = lg.argmax(-1).to(torch.int32)[:, None]
    assert not st["aborted"].any()
    st["active"] = torch.tensor([True, True, True, False])
    before = _ssm_copy(st)
    lg, st = step(prm, st, tok, st["pos"])
    refused = st["aborted"].clone()
    assert refused.any() and not refused.all()
    frozen = refused | ~st["active"]
    assert [t.data_ptr() for t in st["ssm"]] == ptrs
    for t, t0 in zip(st["ssm"], before):
        for b in range(B):
            same = torch.equal(t[:, b], t0[:, b])
            assert same == bool(frozen[b]), (b, same)


def test_reset_lanes_clears_in_place():
    cfg = get_smoke_config("granite-4.0-h-small")
    st, _ = EG.make_decode_state(cfg, 3, S_max=16, page_size=PS,
                                 device="cpu")
    for t in st["ssm"]:
        t.fill_(1)
    ptrs = [t.data_ptr() for t in st["ssm"]]
    st = EG.reset_lanes(st, [1])
    assert [t.data_ptr() for t in st["ssm"]] == ptrs
    for t in st["ssm"]:
        assert (t[:, 1] == 0).all() and (t[:, [0, 2]] == 1).all()


@pytest.mark.parametrize("fused", [False, True])
def test_megastep_equals_single_steps_bitwise(fused):
    """K=8 megastep == 8 single steps for the stack, on K1's path and the
    plain path: same tokens, same final state."""
    cfg = dataclasses.replace(get_smoke_config("granite-4.0-h-small"),
                              fused_kernel=fused)
    prm = hybrid.init(cfg, torch.Generator().manual_seed(3), "cpu")
    B, K = 3, 8
    tok0 = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, 1)).astype(np.int32))
    s1, _ = EG.make_decode_state(cfg, B, S_max=32, page_size=PS,
                                 device="cpu")
    s2 = EG.clone_state(s1)
    step = EG.make_serve_step(cfg, S_max=32, page_size=PS)
    tok, outs = tok0, []
    for _ in range(K):
        logits, s1 = step(prm, s1, tok, s1["pos"])
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        tok = torch.where(s1["aborted"][:, None], tok, nxt)
        outs.append(tok[:, 0])
    mtoks, s2 = EG.make_serve_megastep(cfg, S_max=32, K=K, page_size=PS)(
        prm, s2, tok0)
    assert torch.equal(mtoks, torch.stack(outs, dim=1))
    for k in s1:
        a, b = s1[k], s2[k]
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert torch.equal(x, y), k


def test_spans_of_the_stack_and_no_sync():
    """One megastep's spans: each layer in ``model.layer``, each mamba
    layer's ``model.mamba`` with its four children, the shared expert
    inside ``model.moe``; none of them waits on the card, and no RoPE
    runs (NoPE)."""
    cfg = dataclasses.replace(get_smoke_config("granite-4.0-h-small"),
                              fused_kernel=True)
    prm = hybrid.init(cfg, torch.Generator().manual_seed(4), "cpu")
    st, _ = EG.make_decode_state(cfg, 2, S_max=16, page_size=PS,
                                 device="cpu")
    mega = EG.make_serve_megastep(cfg, S_max=16, K=2, page_size=PS)
    with OT.record_spans() as spans:
        mega(prm, st, torch.zeros((2, 1), dtype=torch.int32))
    table = OT.summarize(spans)
    n_mamba = cfg.layer_types.count("mamba")
    for name in ("model.mamba", "model.mamba.in_proj", "model.mamba.conv",
                 "model.mamba.state", "model.mamba.out"):
        assert table[name]["count"] == 2 * n_mamba, name
        assert table[name]["syncs"] == 0, name
    assert table["model.moe.shared"]["count"] == 2 * cfg.num_layers
    assert table["model.moe.shared"]["syncs"] == 0
    assert table["model.layer"]["count"] == 2 * cfg.num_layers
    assert "model.rope" not in table
    names = {s.name: s for s in spans}
    parent = spans[names["model.moe.shared"].parent].name
    assert parent == "model.moe"
    assert spans[names["model.mamba.state"].parent].name == "model.mamba"


def test_mesh_is_refused():
    cfg = get_smoke_config("granite-4.0-h-small")
    with pytest.raises(ValueError, match="one device"):
        EG.make_serve_step(cfg, S_max=16, page_size=PS, rules=object())


def test_state_counts_mamba_layers_and_pools_attention_layers():
    cfg = get_smoke_config("granite-4.0-h-small")
    st, _ = EG.make_decode_state(cfg, 2, S_max=16, page_size=PS,
                                 device="cpu")
    assert st["ssm"].h.shape[0] == cfg.layer_types.count("mamba")
    assert st["pools"].k.shape[0] == cfg.layer_types.count("attention")


def test_published_parameter_counts():
    """32B total, 9B active (``Granite 4.0-H Small 32B-A9B``)."""
    cfg = get_config("granite-4.0-h-small")
    assert 31.5e9 < cfg.param_count() < 32.5e9
    assert 8.5e9 < cfg.active_param_count() < 9.5e9
    assert cfg.layer_types.count("attention") == 4


def test_loss_trains_every_kind_of_layer():
    """The stack's loss under remat: every leaf of each kind (mamba,
    attention, the routed and the shared experts) gets a gradient, and
    the parameters have logical axes for the train step's specs."""
    from repro_torch.dist import sharding as SH
    cfg = _smoke()
    prm = hybrid.init(cfg, torch.Generator().manual_seed(5), "cpu")
    leaves = hybrid.nn.tree_leaves(prm)
    for t in leaves:
        t.requires_grad_(True)
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 20)))
    hybrid.loss_fn(cfg, prm, toks[:, :-1], toks[:, 1:], remat=True).backward()
    for name in ("mamba", "attn", "ffn"):
        for t in hybrid.nn.tree_leaves(prm[name]):
            assert t.grad is not None and torch.isfinite(t.grad).all()
    assert prm["ffn"]["moe"]["shared"]["wo"].grad.abs().sum() > 0
    assert SH.param_axes(prm)["ffn"]["moe"]["shared"]["wo"] == \
        ("layer", "mlp", "embed")
