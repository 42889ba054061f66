"""Paged decode against the full forward for all ten configs (the port's
analog of ``tests/test_serving.py::test_decode_matches_forward``).

Each smoke config in f32, with the reference's own ``init`` parameters
converted: the port's decode step, token by token over 2 x 12 tokens,
against the JAX package's ``forward`` of the same tokens, ``ATOL``
(1e-4) absolute; once through the plain attention and once with
``fused_kernel`` (K1's plain version on the CPU, where the family runs
it).  encdec's cross K/V come from ``prepare_encdec_state`` on the same
``src_embeds`` that the reference's forward encodes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as j_smoke
from repro.models.registry import get_model as j_get_model
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert
from repro_torch.serving import engine as EG

ATOL = 1e-4
B, T = 2, 12

torch.set_num_threads(1)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_decode_matches_reference_forward(arch, fused):
    jc = dataclasses.replace(j_smoke(arch), dtype="float32")
    tc = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                             fused_kernel=fused)
    jp, _ = j_get_model(jc).init(jc, jax.random.PRNGKey(0))
    tp = convert.from_numpy_tree(jax.tree.map(np.asarray, jp), tc, "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab_size, (B, T))
    state, _ = EG.make_decode_state(tc, B, S_max=64, page_size=8,
                                    device="cpu")
    kw = {}
    if jc.family == "vlm":
        kw["mrope_positions"] = jnp.broadcast_to(
            jnp.arange(T)[None, None], (3, B, T)).astype(jnp.int32)
    if jc.family == "encdec":
        src = rng.standard_normal((B, 8, jc.d_model)).astype(np.float32)
        kw["src_embeds"] = jnp.asarray(src)
        state = EG.prepare_encdec_state(tc, tp, state, torch.from_numpy(src))
    ref, _ = j_get_model(jc).forward(jc, jp, jnp.asarray(toks), **kw)
    ref = np.asarray(ref)
    step = EG.make_serve_step(tc, S_max=64, page_size=8)
    tt = torch.from_numpy(toks.astype(np.int32))
    for t in range(T):
        pos = torch.full((B,), t, dtype=torch.int32)
        args = (tp, state, tt[:, t:t + 1], pos)
        if tc.family == "vlm":
            args += (pos[None, :, None].expand(3, B, 1),)
        logits, state = step(*args)
        np.testing.assert_allclose(logits.numpy(), ref[:, t], atol=ATOL,
                                   rtol=0, err_msg=f"{arch} token {t}")
    assert (state["pos"] == T).all() and not state["aborted"].any()
