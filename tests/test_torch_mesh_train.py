"""Training on the port's mesh on the CPU: gloo ranks
(``repro_torch.launch.mesh.run_spmd``, the bodies in
``tests/_torch_mesh_train_ranks.py``), held against the JAX package on
the same numpy inputs.  The reference's multi-device results (the
manual-pod step on (2, 2, 2) and the pipeline on (4, 2)) are computed once
per module in a subprocess with 8 fake CPU devices, like
``tests/test_mesh.py::run_with_devices``.

- ``tree_compressed_psum`` on (pod 4, data 2): the sum and the residual
  against the reference's ``compress_leaf`` outputs summed in member
  order, bit for bit; the wire bytes and ``compressed_bytes`` equal to the
  reference's;
- the manual-pod step on (pod 2, data 2, model 2), smoke codeqwen in
  float32: loss, updated params and every pod's error buffer within
  ``POD_TOL`` (relative, and absolute on the params) of the reference's
  ``make_train_step_manual_pod``, every rank with the same params;
- the rules step on (data 2, model 2) and (pod 2, data 2, model 2),
  float32, two steps: losses and params within ``RULES_TOL`` of the port's
  one-device step and of the reference's ``make_train_step``;
- elastic restore from (data 2, model 2) onto (data 4, model 2): every
  rank's leaves equal to their cut of the saved arrays, bit for bit; the
  reference's ``restore`` reads the port's mesh checkpoint bit for bit;
- ``TrainRunner(rules=)`` on (data 2, model 2): restore on start from
  its mesh checkpoint, losses within ``RULES_TOL`` of one device's runner;
- GPipe on (pod 4, data 2), L 8, d 16, M 4: within the reference test's
  atol = rtol = 1e-5 of its ``make_pipelined_forward``; the single-stage
  case and the bad partitions raise;
- ``ppermute`` and ``reduce_scatter`` on gloo ranks, and on the card
  (``gpu``-marked: on the placement's transport, nothing staged, equal to
  gloo's staged run).
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_train_ranks as R
from repro.configs import get_smoke_config as j_smoke
from repro.dist import compression as JCOMP
from repro.training import checkpoint as JCKPT
from repro.training import data as JD
from repro.training import train_step as JTS
from repro_torch.dist import collectives as C
from repro_torch.dist import pipeline as PL
from repro_torch.launch.mesh import run_spmd
from repro_torch.training import data as TD
from repro_torch.training import train_step as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the manual-pod step in float32: the ranks' pmean over data and the
# compressed sum over pod add the same numbers as the reference's
# all-reduces, so loss, params and residuals agree to float32 rounding
# (readings: 0 on the loss, <= 3e-8 on params and residuals)
POD_TOL = 1e-5
# the rules step in float32, within 1e-4: the gradient is summed over
# the batch slices in another order than one device's backward
RULES_TOL = 1e-4
PIPE_TOL = 1e-5

REF_SCRIPT = r"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
assert len(jax.devices()) == 8, jax.devices()
from repro.configs import get_smoke_config
from repro.dist import pipeline as PL
from repro.dist.sharding import train_rules
from repro.training import data as D
from repro.training import train_step as TS
f = lambda t: jax.tree.map(np.asarray, t)
cfg = dataclasses.replace(get_smoke_config("codeqwen1.5-7b"), dtype="float32")
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
state, _ = TS.init_state(cfg, jax.random.PRNGKey(0))
keys = iter(jax.random.split(jax.random.PRNGKey(7), 64))
err = jax.tree.map(lambda p: 1e-3 * jax.random.normal(next(keys), (2,) + p.shape),
                   state.params)
b = D.synth_batch(cfg, batch=8, seq_len=16, step=0)
step = TS.make_train_step_manual_pod(cfg, mesh, rules=train_rules(mesh))
s2, e2, m = jax.jit(step)(state, err, b)
out = {"state": {"params": f(state.params), "m": f(state.opt.m),
                 "v": f(state.opt.v), "count": np.asarray(state.opt.count)},
       "err": f(err), "batch": f(b), "params2": f(s2.params), "err2": f(e2),
       "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
pmesh = jax.make_mesh((4, 2), ("pod", "data"))
ws = jax.random.normal(jax.random.PRNGKey(0), (8, 16, 16)) * 0.1
class Cfg: num_layers = 8
def apply_range(w_stack, x):
    def body(x, w):
        return jnp.tanh(x @ w), None
    return jax.lax.scan(body, x, w_stack)[0]
x = jax.random.normal(jax.random.PRNGKey(1), (8, 4, 16))
fwd = PL.make_pipelined_forward(Cfg, pmesh, apply_range, microbatches=4)
out.update(ws=np.asarray(ws), x=np.asarray(x),
           y_pipe=np.asarray(jax.jit(fwd)(ws, x)),
           bubble=PL.bubble_fraction(4, 4))
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.pkl")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT, path], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _close(got, want, tol, what):
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=what)


def test_tree_compressed_psum_bitwise():
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (3,), "c": (2, 3, 4)}
    grads = {k: rng.standard_normal((4,) + s).astype(np.float32)
             for k, s in shapes.items()}
    errs = {k: 0.01 * rng.standard_normal((4,) + s).astype(np.float32)
            for k, s in shapes.items()}
    outs = run_spmd(R.compressed_psum_rank, 8, (grads, errs))
    want_sum, want_err = {}, {}
    for k in shapes:
        acc = None
        for p in range(4):
            sent, e2 = JCOMP.compress_leaf(jnp.asarray(grads[k][p]),
                                           jnp.asarray(errs[k][p]))
            acc = np.asarray(sent) if acc is None else acc + np.asarray(sent)
            want_err[(k, p)] = np.asarray(e2)
        want_sum[k] = acc
    ref_bytes = JCOMP.compressed_bytes({k: jnp.zeros(s)
                                        for k, s in shapes.items()})
    for r, o in enumerate(outs):
        p = r // 2
        for k in shapes:
            np.testing.assert_array_equal(o["sum"][k], want_sum[k])
            np.testing.assert_array_equal(o["err"][k], want_err[(k, p)])
        assert o["bytes"] == ref_bytes
        assert o["wire"] == 3 * ref_bytes      # to the 3 other pod members


def test_manual_pod_step_matches_reference(ref):
    outs = run_spmd(R.manual_pod_rank, 8,
                    (ref["state"], ref["err"], ref["batch"]))
    for o in outs:
        np.testing.assert_allclose(o["loss"], ref["loss"], rtol=POD_TOL)
        np.testing.assert_allclose(o["grad_norm"], ref["grad_norm"],
                                   rtol=POD_TOL)
        _close(o["params"], ref["params2"], POD_TOL, "params")
        want = jax.tree.map(lambda e: e[o["pod"]:o["pod"] + 1], ref["err2"])
        _close(o["err"], want, POD_TOL, "error buffers")
        for a, b in zip(_leaves(o["params"]), _leaves(outs[0]["params"])):
            np.testing.assert_array_equal(a, b)


def _ref_state():
    cfg = dataclasses.replace(j_smoke(R.ARCH), dtype="float32")
    st, _ = JTS.init_state(cfg, jax.random.PRNGKey(0))
    f = lambda t: jax.tree.map(np.asarray, t)
    return cfg, st, {"params": f(st.params), "m": f(st.opt.m),
                     "v": f(st.opt.v), "count": np.asarray(st.opt.count)}


@pytest.fixture(scope="module")
def rules_ref():
    """The two steps both mesh shapes are held to: the reference's
    one-device ``make_train_step`` and the port's, from the same numpy
    state and batches."""
    jcfg, jst, st = _ref_state()
    batches = [jax.tree.map(np.asarray,
                            JD.synth_batch(jcfg, batch=8, seq_len=16,
                                           step=i)) for i in range(2)]
    jstep = jax.jit(JTS.make_train_step(jcfg))
    jlosses = []
    for b in batches:
        jst, m = jstep(jst, b)
        jlosses.append(float(m["loss"]))
    cfg = R.f32_cfg()
    pst = R._state(cfg, st)
    pstep = TS.make_train_step(cfg)
    plosses = []
    for b in batches:
        pst, m = pstep(pst, R._batch(b))
        plosses.append(float(m["loss"]))
    return {"state": st, "batches": batches, "jlosses": jlosses,
            "jparams": jst.params, "plosses": plosses,
            "pparams": R._np(pst.params)}


@pytest.mark.parametrize("shape,axes", [
    ((2, 2), ("data", "model")),
    ((2, 2, 2), ("pod", "data", "model"))])
def test_rules_step_matches_one_device_and_reference(shape, axes, rules_ref):
    outs = run_spmd(R.rules_step_rank, int(np.prod(shape)),
                    (shape, axes, rules_ref["state"], rules_ref["batches"]))
    for o in outs:
        got = [l for l, _ in o["losses"]]
        np.testing.assert_allclose(got, rules_ref["jlosses"], rtol=RULES_TOL)
        np.testing.assert_allclose(got, rules_ref["plosses"], rtol=RULES_TOL)
        _close(o["params"], rules_ref["jparams"], RULES_TOL, "vs reference")
        _close(o["params"], rules_ref["pparams"], RULES_TOL,
               "vs one device")
        assert all(np.isfinite(g) for _, g in o["losses"])


def test_elastic_restore_bitwise_and_into_reference(tmp_path):
    jcfg, jst, st = _ref_state()
    d = str(tmp_path / "ck")
    saved = run_spmd(R.elastic_save_rank, 4, (st, d))
    assert [o["committed"] for o in saved] == [5] * 4
    outs = run_spmd(R.elastic_restore_rank, 8, (d,))
    for o in outs:
        assert o["step"] == 5 and o["shapes_ok"] and o["n"] > 0
        assert o["bad"] == [], o["bad"]
    restored, step = JCKPT.restore(d, jst)
    assert step == 5
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_runner_on_a_mesh_restores_and_matches_one_device(tmp_path):
    """``TrainRunner(rules=)`` on (data 2, model 2): 4 steps with a
    checkpoint every 2, then a second run to 6 that restores step 4 on
    every rank; the 6 losses within ``RULES_TOL`` of one device's
    ``TrainRunner`` from the same seed, every rank the same."""
    from repro_torch.launch.train import TrainRunner
    d = str(tmp_path / "ck")
    first = run_spmd(R.runner_rank, 4, (d, 4))
    second = run_spmd(R.runner_rank, 4, (d, 6))
    _, want = TrainRunner(R.f32_cfg(), device="cpu").run(
        batch=4, seq_len=16, steps=6, log_every=100)
    for a, b in zip(first, second):
        got = a["losses"] + b["losses"]
        assert got == first[0]["losses"] + second[0]["losses"]
        np.testing.assert_allclose(got, want, rtol=RULES_TOL)
    assert len(second[0]["losses"]) == 2       # restored at step 4


def test_pipeline_matches_reference(ref):
    outs = run_spmd(R.pipeline_rank, 8, (ref["ws"], ref["x"]))
    for o in outs:
        np.testing.assert_allclose(o["y"], ref["y_pipe"], atol=PIPE_TOL,
                                   rtol=PIPE_TOL)
        np.testing.assert_allclose(o["y"], R._pipe_apply(
            torch.as_tensor(ref["ws"]), torch.as_tensor(ref["x"])).numpy(),
            atol=PIPE_TOL, rtol=PIPE_TOL)
    # 7 ticks; stage 0 sends on every tick, receives none
    assert outs[0]["by_op"]["ppermute"]["calls"] == 7
    assert PL.bubble_fraction(4, 4) == pytest.approx(ref["bubble"])
    assert PL.bubble_fraction(4, 4) == pytest.approx(3 / 7)


def test_pipeline_single_stage_and_bad_partitions():
    mesh = C.Mesh((1,), ("pod",), "cpu")
    C.set_mesh(mesh)
    try:
        class Cfg:
            num_layers = 4
        ws = torch.randn((4, 8, 8), generator=torch.Generator().manual_seed(0)
                         ) * 0.1
        x = torch.randn((4, 3, 8), generator=torch.Generator().manual_seed(1))
        fwd = PL.make_pipelined_forward(Cfg, mesh, R._pipe_apply,
                                        microbatches=2)
        np.testing.assert_allclose(fwd(ws, x).numpy(),
                                   R._pipe_apply(ws, x).numpy(),
                                   atol=1e-6, rtol=1e-6)
        bad = PL.make_pipelined_forward(Cfg, mesh, lambda w, x: x,
                                        microbatches=3)
        with pytest.raises(ValueError):
            bad(torch.zeros((4, 2, 2)), torch.zeros((4, 2)))   # 4 % 3
        with pytest.raises(ValueError):
            PL.make_pipelined_forward(
                type("C3", (), {"num_layers": 3}), C.AbstractMesh(
                    (2,), ("pod",)), R._pipe_apply)
    finally:
        C.set_mesh(None)


def test_ppermute_and_reduce_scatter_on_gloo():
    outs = run_spmd(R.collectives_rank, 4, ((2, 2), ("pod", "data")))
    xs = [np.arange(12, dtype=np.float32).reshape(4, 3) + 100 * r
          for r in range(4)]
    for r, o in enumerate(outs):
        pod, data = o["coords"]["pod"], o["coords"]["data"]
        peer = (1 - pod) * 2 + data
        np.testing.assert_array_equal(o["perm"], xs[peer])
        total = xs[0] + xs[1] + xs[2] + xs[3]
        np.testing.assert_array_equal(o["psum"], total)
        np.testing.assert_array_equal(o["rs"], o["psum"][o["idx"]:o["idx"]
                                                         + 1])


@pytest.mark.gpu
def test_ppermute_staged_on_the_card():
    """On a CUDA device: ``ppermute`` of card tensors delivers each rank's
    tensor to its destination on the transport the placement gives (the
    peer buffers on one card, NCCL on two), nothing staged through the
    host, with the bits of gloo's staged run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    outs = run_spmd(R.card_collectives_rank, 2, (), device="cuda")
    want = "nccl" if torch.cuda.device_count() >= 2 else "peer"
    np.testing.assert_array_equal(outs[0]["placed"]["perm"], outs[1]["mine"])
    np.testing.assert_array_equal(outs[1]["placed"]["perm"], outs[0]["mine"])
    for o in outs:
        assert o["placed"]["transport"] == want
        assert o["placed"]["staged"] == 0 and o["gloo"]["staged"] >= 2
        np.testing.assert_array_equal(o["placed"]["perm"], o["gloo"]["perm"])


@pytest.mark.gpu
def test_reduce_scatter_staged_on_the_card():
    """On a CUDA device: ``reduce_scatter`` of card tensors equals
    ``psum``'s chunk bit for bit on the placement's transport, nothing
    staged, and both equal gloo's staged run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    outs = run_spmd(R.card_collectives_rank, 2, (), device="cuda")
    for o in outs:
        got = o["placed"]
        assert got["staged"] == 0
        np.testing.assert_array_equal(got["rs"], got["psum"][got["idx"] * 2:
                                                             got["idx"] * 2
                                                             + 2])
        np.testing.assert_array_equal(got["rs"], o["gloo"]["rs"])
        np.testing.assert_array_equal(got["psum"], o["gloo"]["psum"])


def test_port_data_matches_reference_shapes():
    """The batches the rank bodies take are the reference's; the port's
    own synth batch has the same shapes (the runner feeds it)."""
    jcfg = dataclasses.replace(j_smoke(R.ARCH), dtype="float32")
    jb = JD.synth_batch(jcfg, batch=8, seq_len=16, step=0)
    tb = TD.synth_batch(R.f32_cfg(), batch=8, seq_len=16, step=0,
                        device="cpu")
    assert {k: tuple(v.shape) for k, v in jb.items()} == \
        {k: tuple(v.shape) for k, v in tb.items()}
