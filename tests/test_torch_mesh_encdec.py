"""encdec (seamless) decode on the port's mesh on the CPU: 8 ``gloo``
ranks (``repro_torch.launch.mesh.run_spmd``, the body in
``tests/_torch_mesh_ranks.py``) under ``serve_rules`` on (data 4, model 2)
and (pod 2, data 2, model 2), and under ``serve_manual_rules``, which
refuses encdec (the reference's ``_manual_decode_ok``) and decodes on the
gspmd step with its pages over (pod, data).  The smoke config in float32
on the reference's weights: the encoder's prefill over the rank's weight
shards, then 10 single steps; each step's logits within
``test_torch_mesh.F32_REL_TOL`` (relative, in the norm) of the
reference's single-device decode, every rank with the same logits and
page table, and each rank holding its lanes and KV heads of the cross
K/V."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_ranks as R
from repro.configs import get_smoke_config as j_smoke
from repro.models.registry import get_model as j_get_model
from repro.serving import engine as JEG
from repro_torch.launch.mesh import run_spmd
from test_torch_mesh import F32_REL_TOL, _rel

ARCH = "seamless-m4t-large-v2"
B, T = 2, 10
CASES = {
    "serve_4x2": ((4, 2), ("data", "model"), "serve_rules"),
    "serve_2x2x2": ((2, 2, 2), ("pod", "data", "model"), "serve_rules"),
    "manual_4x2": ((4, 2), ("data", "model"), "serve_manual_rules"),
}
# the manual-decode gate's refusal for encdec (the reference's string)
ENCDEC_REASON = "cross-attention decode state not yet inside the fused region"


@pytest.mark.parametrize("case", sorted(CASES))
def test_encdec_mesh_decode_matches_reference(case):
    shape, axes, table = CASES[case]
    cfg = dataclasses.replace(j_smoke(ARCH), dtype="float32")
    if table == "serve_manual_rules":
        cfg = dataclasses.replace(cfg, tp_impl="manual")
    params, _ = j_get_model(cfg).init(cfg, jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    rng = np.random.default_rng(3)
    src = rng.standard_normal((B, R.S_MAX // 8, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    state, _ = JEG.make_decode_state(cfg, B, S_max=R.S_MAX,
                                     page_size=R.PAGE_SIZE)
    state = JEG.prepare_encdec_state(cfg, params, state, jnp.asarray(src))
    step = jax.jit(JEG.make_serve_step(cfg, S_max=R.S_MAX,
                                       page_size=R.PAGE_SIZE))
    ref = []
    for t in range(T):
        lg, state = step(params, state, jnp.asarray(toks[:, t:t + 1]),
                         jnp.full((B,), t, jnp.int32))
        ref.append(np.asarray(lg))
    outs = run_spmd(R.encdec_rank, 8,
                    (shape, axes, table, params, src, toks))
    r0 = outs[0]
    rel = _rel(r0["logits"], np.stack(ref))
    assert rel <= F32_REL_TOL, (case, rel)
    sizes = dict(zip(axes, shape))
    want_cross = (cfg.num_layers, B // sizes["data"] if B % sizes["data"]
                  == 0 else B, R.S_MAX // 8, cfg.n_kv // sizes["model"],
                  cfg.hd)
    for o in outs:
        np.testing.assert_array_equal(o["logits"], r0["logits"])
        np.testing.assert_array_equal(o["table"], r0["table"])
        assert o["cross_shape"] == want_cross, (o["cross_shape"], want_cross)
    assert r0["report"]["decode_tp"] == ENCDEC_REASON
