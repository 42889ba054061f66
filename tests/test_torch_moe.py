"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's, on numpy inputs from a seed.

Expert ids must be equal (ties broken by the lower index, values on the
snap grid's edges rounded half to even); outputs in f32 within
``ATOL``; the aux loss within ``AUX_RTOL``.  The conversion of a bf16 MoE
model keeps the router in float32, as the reference draws it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import lm as j_lm
from repro.models import moe as j_moe
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert, lm, moe
from repro_torch.models.registry import get_model

# f32 on both sides; the port sums each token's k expert outputs in
# another order than the reference's scatter-add, and the matrix products
# differ by rounding only
ATOL = 1e-5
AUX_RTOL = 1e-6

torch.set_num_threads(1)


def _tie_logits(rng, T, E):
    """Router logits with exact ties between experts, values on the snap
    grid, on its half-way edges (round half to even decides) and one ulp
    to either side of an edge."""
    g = moe.ROUTER_SNAP_GRID
    base = rng.integers(-40, 40, (T, E)).astype(np.float32) * np.float32(g)
    kind = rng.integers(0, 5, (T, E))
    half = base + np.float32(g / 2)
    logits = np.where(kind == 1, half, base)
    logits = np.where(kind == 2, np.nextafter(half, np.float32(np.inf)),
                      logits)
    logits = np.where(kind == 3, np.nextafter(half, np.float32(-np.inf)),
                      logits)
    # rows of many equal values: ties broken by the lower expert index
    logits[3::3, : E // 2] = logits[3::3, :1]
    logits[1::3, 1::2] = np.float32(3.5 * g)
    # row 0 all equal; row 2 alternates two half-way edges, 0.5 and 1.5
    # grid steps, which round (half to even) to 0 and 2
    logits[0] = np.float32(-0.75)
    logits[2] = np.where(np.arange(E) % 2, np.float32(1.5 * g),
                         np.float32(0.5 * g))
    return logits.astype(np.float32)


@pytest.mark.parametrize("E,k", [(4, 2), (8, 2), (32, 8), (128, 8)])
def test_router_top_k_matches_reference(E, k):
    rng = np.random.default_rng(E * 7 + k)
    logits = _tie_logits(rng, 48, E)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    jg, jids = j_moe._router_top_k(jnp.asarray(logits), probs, k, E)
    tg, tids = moe._router_top_k(torch.from_numpy(logits),
                                 torch.from_numpy(np.array(probs)), k, E)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    # the tie rows really tie: the lowest indices win, in order
    np.testing.assert_array_equal(tids[0].numpy(), np.arange(k))
    np.testing.assert_array_equal(tids[2].numpy(), 2 * np.arange(k) + 1)


def _moe_cfgs(arch, **over):
    jc = dataclasses.replace(j_smoke(arch), dtype="float32", **over)
    tc = dataclasses.replace(get_smoke_config(arch), dtype="float32", **over)
    return jc, tc


def _moe_params(jc, tc, seed=0):
    from repro.models.moe import moe_init
    jp, _ = moe_init(jax.random.PRNGKey(seed), jc, jnp.float32)
    tp = convert.from_numpy_tree({"moe": jax.tree.map(np.asarray, jp)}, tc,
                                 "cpu")["moe"]
    return jp, tp


def _apply_both(jc, tc, jp, tp, x):
    jy, jaux = j_moe.moe_apply(jp, jnp.asarray(x), jc)
    ty, taux = moe.moe_apply(tp, torch.from_numpy(x), tc)
    return np.asarray(jy), float(jaux), ty.numpy(), float(taux)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "qwen3-moe-235b-a22b"])
def test_moe_apply_matches_reference_without_drops(arch):
    jc, tc = _moe_cfgs(arch)
    jp, tp = _moe_params(jc, tc)
    x = np.random.default_rng(1).standard_normal(
        (3, 5, jc.d_model)).astype(np.float32)
    jy, jaux, ty, taux = _apply_both(jc, tc, jp, tp, x)
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=0)
    np.testing.assert_allclose(taux, jaux, rtol=AUX_RTOL)


def test_moe_apply_matches_reference_with_drops():
    """capacity factor 1.0 and T = 256 tokens over E/k = 2: C = 128 slots
    an expert, so the popular experts drop tokens.  The dropped set (the
    tokens whose output differs from the no-drop run) is the same on both
    sides and not empty, and the outputs agree within ATOL."""
    jc, tc = _moe_cfgs("granite-moe-1b-a400m", moe_capacity_factor=1.0)
    jn, tn = _moe_cfgs("granite-moe-1b-a400m")          # factor 100
    jp, tp = _moe_params(jc, tc, seed=3)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 64, jc.d_model)).astype(np.float32)
    # skew the routing so that the capacity binds
    x += 2.0 * np.asarray(jp["router"])[:, 0][None, None, :] / np.linalg.norm(
        np.asarray(jp["router"])[:, 0])
    T, E, k = 256, jc.num_experts, jc.experts_per_token
    assert j_moe._capacity(T, k, E, 1.0) == 128
    jy, jaux, ty, taux = _apply_both(jc, tc, jp, tp, x)
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=0)
    np.testing.assert_allclose(taux, jaux, rtol=AUX_RTOL)
    jy0, _, ty0, _ = _apply_both(jn, tn, jp, tp, x)
    j_drop = np.abs(jy - jy0).reshape(T, -1).max(-1) > 1e-6
    t_drop = np.abs(ty - ty0).reshape(T, -1).max(-1) > 1e-6
    np.testing.assert_array_equal(t_drop, j_drop)
    assert 0 < int(t_drop.sum()) < T


def test_convert_keeps_router_f32():
    """A bf16 MoE model: the reference draws its router in f32 and every
    other leaf in bf16; the conversion keeps exactly that, bit for bit.
    The port's own ``lm.init`` draws the router in f32 too."""
    jc = j_smoke("granite-moe-1b-a400m")
    tc = get_smoke_config("granite-moe-1b-a400m")
    assert tc.activation_dtype() == torch.bfloat16
    jp, _ = j_lm.init(jc, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jp)
    tp = convert.from_numpy_tree(np_tree, tc, "cpu")
    assert np_tree["layers"]["moe"]["router"].dtype == np.float32
    flat_j = jax.tree_util.tree_flatten_with_path(np_tree)[0]
    for path, a in flat_j:
        keys = [p.key for p in path]
        t = tp
        for kk in keys:
            t = t[kk]
        want = (torch.float32 if keys[-2:] == ["moe", "router"]
                else torch.bfloat16)
        assert t.dtype == want, keys
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32))
    own = get_model(tc).init(tc, torch.Generator().manual_seed(0), "cpu")
    assert own["layers"]["moe"]["router"].dtype == torch.float32
    assert own["layers"]["moe"]["wi_gate"].dtype == torch.bfloat16


def test_moe_mesh_paths_raise():
    """The mesh paths on a one-rank mesh, where every
    collective is the identity: ``moe_apply`` under both serve and train
    rules and the manual region's ``moe_decode_local`` give the
    single-device output bit for bit (its aux too), and without a bound
    mesh the collectives raise rather than run on one device quietly.
    The 8-rank paths are ``tests/test_torch_mesh.py``'s."""
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import serve_rules, train_rules
    from repro_torch.launch.mesh import make_mesh
    jc, tc = _moe_cfgs("granite-moe-1b-a400m")
    jp, _ = j_moe.moe_init(jax.random.PRNGKey(0), jc, jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 4, tc.d_model)).astype(np.float32))
    y0, aux0 = moe.moe_apply(p, x, tc)
    with pytest.raises(RuntimeError, match="no mesh"):
        moe.moe_decode_local(p, x, tc)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    try:
        for rules in (serve_rules(mesh), train_rules(mesh)):
            y, aux = moe.moe_apply(p, x, tc, rules=rules)
            assert torch.equal(y, y0) and torch.equal(aux, aux0)
        assert torch.equal(moe.moe_decode_local(p, x, tc), y0)
    finally:
        C.set_mesh(None)


def test_moe_forward_and_aux_match_reference():
    """qwen3-moe's smoke config (8 experts top-2, untied head) end to end:
    logits and the summed aux loss equal the reference's within ATOL."""
    jc, tc = _moe_cfgs("qwen3-moe-235b-a22b")
    jp, _ = j_lm.init(jc, jax.random.PRNGKey(0))
    tp = convert.from_numpy_tree(jax.tree.map(np.asarray, jp), tc, "cpu")
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 10))
    want, jaux = j_lm.forward(jc, jp, jnp.asarray(toks))
    got, taux = lm.forward(tc, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
