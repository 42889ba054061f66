"""The block's arithmetic is the same function on the serve side and the
forward side, for every family, with each of its config keys off its
default: ``rms_norm_eps``, ``residual_multiplier``,
``embedding_multiplier``, ``logits_scaling`` and, where the family has
attention, ``attention_multiplier``.

Each family's smoke config in float32 with the port's own parameters
(no JAX): a few decode steps through the page table (and gemma3's rings
past their window, the mamba state, encdec's cross K/V) against the
family's own ``forward`` of the same tokens at the same positions,
within ``test_torch_families.py``'s ``DECODE_ATOL``; and the key moves
the forward's logits, so that no side passes by ignoring it.  The reference has
none of these keys, so the port's forward is the oracle here; the
forward itself is held to the reference at the keys' defaults by the
families' parity tests."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import get_model
from repro_torch.serving import engine as EG

DECODE_ATOL = 1e-4
KEYS = dict(rms_norm_eps=1e-5, residual_multiplier=0.5,
            embedding_multiplier=3.0, logits_scaling=2.0,
            attention_multiplier=0.1)
FAMILIES = {"dense": "qwen2.5-32b", "moe": "granite-moe-1b-a400m",
            "vlm": "qwen2-vl-7b", "gemma3": "gemma3-12b",
            "mamba2": "mamba2-2.7b", "zamba2": "zamba2-1.2b",
            "encdec": "seamless-m4t-large-v2"}
# each key alone, then all of them (mamba2 has no attention to scale)
CASES = [(f, k) for f in sorted(FAMILIES) for k in sorted(KEYS) + ["all"]
         if not (f == "mamba2" and k == "attention_multiplier")]
B, T = 2, 12
DEFAULTS = {f.name: f.default for f in dataclasses.fields(ModelConfig)}

torch.set_num_threads(1)


def _cfg(arch, key):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    over = dict(KEYS) if key == "all" else {key: KEYS[key]}
    if cfg.family == "ssm":
        over.pop("attention_multiplier", None)
    return dataclasses.replace(cfg, **over)


@pytest.mark.parametrize("family,key", CASES)
def test_decode_matches_forward_with_the_keys_set(family, key):
    cfg = _cfg(FAMILIES[family], key)
    if cfg.pattern_local:
        assert cfg.local_window < T              # the ring wraps
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, T)))
    kw = {}
    if cfg.family == "vlm":
        kw["mrope_positions"] = torch.arange(T).expand(3, B, T)
    if cfg.family == "encdec":
        kw["src_embeds"] = torch.randn(
            B, 5, cfg.d_model, generator=torch.Generator().manual_seed(2))
    want, _ = model.forward(cfg, params, toks, **kw)
    # the key is alive: the forward's logits move off the defaults' ones
    plain = dataclasses.replace(cfg, **{k: DEFAULTS[k] for k in KEYS})
    assert not torch.equal(want, model.forward(plain, params, toks,
                                               **kw)[0])
    state, _ = EG.make_decode_state(cfg, B, S_max=32, page_size=4,
                                    device="cpu")
    if cfg.family == "encdec":
        state = EG.prepare_encdec_state(cfg, params, state,
                                        kw["src_embeds"])
    step = EG.make_serve_step(cfg, S_max=32, page_size=4)
    for t in range(T):
        pos = torch.full((B,), t, dtype=torch.int32)
        args = (params, state, toks[:, t:t + 1].to(torch.int32), pos)
        if cfg.family == "vlm":
            args += (pos[None, :, None].expand(3, B, 1),)
        logits, state = step(*args)
        np.testing.assert_allclose(logits.numpy(), want[:, t].numpy(),
                                   atol=DECODE_ATOL, rtol=DECODE_ATOL,
                                   err_msg=f"{family} {key} step {t}")
