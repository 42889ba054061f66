"""The port's train step (``repro_torch.training.train_step``) against the
JAX package's, for all ten smoke configs in f32 (the analog of
``tests/test_archs.py::test_smoke_train_step``), and the flash-attention
gradients against the reference's custom VJP (the analog of
``tests/test_models.py::test_flash_attention_vjp``).

Both packages start from the reference's own ``init_state`` (converted
with ``models.convert.train_state_from_numpy``) and take the same batches,
drawn from a seeded numpy generator.  Held: the loss within ``LOSS_RTOL``
(1e-5, relative), every gradient leaf within ``GRAD_TOL`` (1e-4, atol =
rtol) of the reference's ``jax.value_and_grad`` of ``make_loss_fn``, the
parameters after two steps within ``PARAM_TOL`` (1e-4), and the port's
loss and gradients with ``remat`` on equal to those with it off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as j_smoke
from repro.models.layers import flash_attention as j_flash
from repro.training import optimizer as JOPT
from repro.training import train_step as JTS
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert, nn
from repro_torch.models.layers import flash_attention
from repro_torch.training import train_step as TS

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-4
B, S = 2, 32

torch.set_num_threads(1)


def np_batch(cfg, rng):
    """A batch in ``data.synth_batch``'s layout from a numpy generator."""
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1))
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        out["src_embeds"] = rng.normal(size=(B, S // 8, cfg.d_model)
                                       ).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(size=(B, S // 2, cfg.d_model)
                                         ).astype(np.float32)
        out["mrope_positions"] = np.broadcast_to(
            np.arange(S)[None, None], (3, B, S)).copy()
    return out


def to_jax(b):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
            for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def port_loss_and_grads(cfg, state, batch, remat):
    leaves = nn.tree_leaves(state.params)
    loss = TS.make_loss_fn(cfg, remat=remat)(state.params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_smoke_train_step_matches_reference(arch):
    jc = dataclasses.replace(j_smoke(arch), dtype="float32")
    tc = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jstate, _ = JTS.init_state(jc, jax.random.PRNGKey(0))
    loss_fn = JTS.make_loss_fn(jc)
    adamw = JOPT.AdamWConfig()

    @jax.jit
    def ref_step(state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, batch)
        p2, o2, _ = JOPT.apply(adamw, state.params, state.opt, grads)
        return JTS.TrainState(p2, o2, state.step + 1), loss, grads

    host = jax.tree.map(np.asarray, jstate)
    tstate = convert.train_state_from_numpy(host.params, host.opt.m,
                                            host.opt.v, host.opt.count, tc,
                                            "cpu", step=host.step)
    step = TS.make_train_step(tc)
    rng = np.random.default_rng(1)
    for i in range(2):
        b = np_batch(jc, rng)
        jstate, jloss, jgrads = ref_step(jstate, to_jax(b))
        tb = to_torch(b)
        if i == 0:
            loss, grads = port_loss_and_grads(tc, tstate, tb, remat=True)
            np.testing.assert_allclose(float(loss), float(jloss),
                                       rtol=LOSS_RTOL)
            jleaves = nn.tree_leaves(jax.tree.map(np.asarray, jgrads))
            for n, (g, jg) in enumerate(zip(grads, jleaves)):
                close(g, jg, GRAD_TOL, f"{arch} grad leaf {n}")
            loss0, grads0 = port_loss_and_grads(tc, tstate, tb, remat=False)
            assert torch.equal(loss, loss0)
            for g, g0 in zip(grads, grads0):
                assert torch.equal(g, g0)
        tstate, metrics = step(tstate, tb)
        np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                                   rtol=LOSS_RTOL)
        assert np.isfinite(float(metrics["grad_norm"]))
    assert int(tstate.step) == 2 == int(jstate.step)
    jleaves = nn.tree_leaves(jax.tree.map(np.asarray, jstate.params))
    for n, (p, jp) in enumerate(zip(nn.tree_leaves(tstate.params), jleaves)):
        close(p, jp, PARAM_TOL, f"{arch} param leaf {n} after 2 steps")


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_flash_attention_vjp_matches_reference(causal, window):
    """Gradients of ``sum(sin(flash_attention(q, k, v)))`` through the
    port's autograd against the reference's custom VJP, the reference
    test's shapes and chunks."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 64, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 64, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 64, 2, 8)).astype(np.float32)

    def f(q, k, v):
        return jnp.sum(jnp.sin(j_flash(q, k, v, causal=causal, window=window,
                                       q_chunk=16, kv_chunk=16)))

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, window=window,
                          q_chunk=16)
    got = torch.autograd.grad(torch.sin(out).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=1e-4)
