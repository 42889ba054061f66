"""Rank bodies of ``tests/test_torch_mesh_train.py`` and
``tests/test_torch_tooling.py``, run by ``repro_torch.launch.mesh.run_spmd``
in spawned gloo ranks on the CPU.  They import only the port (no JAX) and
return numpy results for the tests to hold against the JAX package's."""
import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.dist import collectives as C
from repro_torch.dist import compression as COMP
from repro_torch.dist import pipeline as PL
from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import convert
from repro_torch.models import nn
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import train_step as TS

ARCH = "codeqwen1.5-7b"


def f32_cfg(arch=ARCH):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def _batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _state(cfg, st, specs=None, mesh=None):
    return convert.train_state_from_numpy(
        st["params"], st["m"], st["v"], st["count"], cfg, "cpu",
        specs=specs, mesh=mesh)


def compressed_psum_rank(rank, grads, errs):
    """(pod 4, data 2): member p of ``pod`` reduces ``grads[p]`` with
    residual ``errs[p]``; returns the sum, the residual, the wire bytes
    and ``compressed_bytes``."""
    mesh = make_mesh((4, 2), ("pod", "data"), "cpu")
    p = mesh.coords["pod"]
    g = {k: torch.as_tensor(v[p]) for k, v in grads.items()}
    e = {k: torch.as_tensor(v[p]) for k, v in errs.items()}
    C.reset_stats()
    s, e2 = COMP.tree_compressed_psum(g, "pod", e)
    return {"sum": _np(s), "err": _np(e2),
            "wire": C.COLLECTIVE_STATS["by_op"]["all_gather"]["sent"],
            "bytes": COMP.compressed_bytes(g)}


def manual_pod_rank(rank, st, err, batch):
    """The manual-pod step on (pod 2, data 2, model 2) from the
    reference's state and error buffers; returns the loss, the params and
    this rank's error buffer piece."""
    cfg = f32_cfg()
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    state = _state(cfg, st)
    e = convert.pod_error_from_numpy(err, mesh)
    step = TS.make_train_step_manual_pod(cfg, mesh,
                                         rules=SH.train_rules(mesh))
    state, e2, m = step(state, e, _batch(batch))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": _np(state.params), "err": _np(e2),
            "pod": mesh.coords["pod"]}


def rules_step_rank(rank, shape, axes, st, batches):
    """The rules-sharded step on ``shape`` from the reference's state
    (each rank converting its shards); returns the losses and the whole
    params gathered after the steps."""
    cfg = f32_cfg()
    mesh = make_mesh(shape, axes, "cpu")
    rules = SH.train_rules(mesh)
    specs = TS.param_specs(cfg, rules)
    state = _state(cfg, st, specs, mesh)
    step = TS.make_train_step(cfg, rules=rules)
    losses = []
    for b in batches:
        state, m = step(state, _batch(b))
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    full = nn.tree_unflatten(state.params, [
        TS.gather_full(p, sp) for p, sp in zip(nn.tree_leaves(state.params),
                                               nn.tree_leaves(specs))])
    return {"losses": losses, "params": _np(full)}


def elastic_save_rank(rank, st, ckpt_dir):
    """A (data 2, model 2) rank's shards of the reference's state, saved
    from the mesh (rank 0 writes)."""
    cfg = f32_cfg()
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = SH.train_rules(mesh)
    state = _state(cfg, st, TS.param_specs(cfg, rules), mesh)
    CKPT.save(ckpt_dir, 5, state, TS.state_axes(cfg), rules=rules,
              specs=TS.state_specs(cfg, rules))
    return {"committed": CKPT.latest_step(ckpt_dir)}


def elastic_restore_rank(rank, ckpt_dir):
    """Restore onto (data 4, model 2): this rank's leaves against its cut
    of the saved arrays, bit for bit."""
    cfg = f32_cfg()
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    rules = SH.train_rules(mesh)
    tmpl = TS.init_state(cfg, torch.Generator().manual_seed(1), "cpu",
                         rules=rules)
    restored, step = CKPT.restore(ckpt_dir, tmpl, rules=rules)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    bad, shapes_ok = [], True
    for key, leaf in CKPT._flatten(restored).items():
        entry = manifest["leaves"][key]
        arr = np.load(os.path.join(path, entry["file"]))
        spec = rules.spec(tuple(entry["logical_axes"]), arr.shape)
        want = arr[SH.shard_slices(spec, arr.shape, mesh)]
        got = leaf.detach().numpy()
        if got.shape != want.shape or not np.array_equal(got, want):
            bad.append(key)
        shapes_ok &= tuple(got.shape) == rules.local_shape(spec, arr.shape)
    return {"step": step, "bad": bad, "shapes_ok": shapes_ok,
            "n": len(manifest["leaves"])}


class PipeCfg:
    num_layers = 8


def _pipe_apply(w, x):
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
    return x


def pipeline_rank(rank, ws, x):
    """GPipe on (pod 4, data 2), M = 4: this stage's layers of ``ws``."""
    mesh = make_mesh((4, 2), ("pod", "data"), "cpu")
    w = torch.as_tensor(ws)[PL.stage_layers(PipeCfg, mesh)]
    fwd = PL.make_pipelined_forward(PipeCfg, mesh, _pipe_apply,
                                    microbatches=4)
    C.reset_stats()
    y = fwd(w, torch.as_tensor(x))
    return {"y": y.numpy(),
            "by_op": {k: dict(v)
                      for k, v in C.COLLECTIVE_STATS["by_op"].items()}}


def collectives_rank(rank, shape, axes):
    """ppermute and reduce_scatter on this rank's values: returns what
    each gave (the test holds them to the permutation and to psum's
    chunk)."""
    mesh = make_mesh(shape, axes, "cpu")
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 100 * rank
    out = {"perm": C.ppermute(x, axes[0], [(0, 1), (1, 0)]).numpy(),
           "rs": C.reduce_scatter(x, axes, dim=0).numpy(),
           "psum": C.psum(x, axes).numpy(),
           "idx": C.axis_index(axes), "coords": dict(mesh.coords)}
    return out


def card_collectives_rank(rank):
    """ppermute, reduce_scatter and psum of card tensors over a 2-rank
    ``pod`` axis, under the transport the placement gives (the peer
    buffers when the ranks share a card, NCCL when each has one) and
    under gloo named explicitly (staged through the host)."""
    x = torch.randn((4, 3), generator=torch.Generator().manual_seed(rank)
                    ).to("cuda")
    out = {"mine": x.cpu().numpy()}
    for key, transport in (("placed", None), ("gloo", "gloo")):
        mesh = make_mesh((2,), ("pod",), "cuda", transport=transport)
        C.reset_stats()
        out[key] = {
            "perm": C.ppermute(x, "pod", [(0, 1), (1, 0)]).cpu().numpy(),
            "rs": C.reduce_scatter(x, "pod", dim=0).cpu().numpy(),
            "psum": C.psum(x, "pod").cpu().numpy(),
            "idx": C.axis_index("pod"), "transport": mesh.transport,
            "staged": C.COLLECTIVE_STATS["staged"]}
    return out


# ---------------------------------------------------------------------------
# Tooling: the analytic collective counts against real steps.

def decode_step_rank(rank, cases):
    """One decode step per case (arch, table, shape, axes) on gloo ranks:
    ``COLLECTIVE_STATS`` of the step beside ``dryrun.decode_collectives``
    for the same cfg, rules and batch."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.models.registry import get_model
    from repro_torch.serving import engine as EG
    B, S_MAX, PS = 4, 32, 4
    out = {}
    for name, (arch, table, shape, axes) in cases.items():
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        if table == "serve_manual_rules":
            cfg = dataclasses.replace(cfg, tp_impl="manual")
        mesh = make_mesh(shape, axes, "cpu")
        rules = getattr(SH, table)(mesh)
        full = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
        params = SH.local_shard(full, EG.mesh_param_specs(cfg, full, rules),
                                mesh)
        state, _ = EG.make_decode_state(cfg, B, S_MAX, rules=rules,
                                        page_size=PS, device="cpu")
        if cfg.family == "encdec":
            src = torch.randn((B, S_MAX // 8, cfg.d_model),
                              generator=torch.Generator().manual_seed(2))
            state = EG.prepare_encdec_state(cfg, params, state, src,
                                            rules=rules)
        step = EG.make_serve_step(cfg, S_max=S_MAX, page_size=PS,
                                  rules=rules)
        toks = torch.zeros((B, 1), dtype=torch.int32)
        pos = torch.zeros((B,), dtype=torch.int32)
        args = (toks, pos) if cfg.family != "vlm" else (
            toks, pos, pos[None, :, None].expand(3, -1, 1))
        C.reset_stats()
        step(params, state, *args)
        real = {k: dict(v) for k, v in C.COLLECTIVE_STATS["by_op"].items()}
        C.set_mesh(C.RecordingMesh(shape, axes))
        rec_rules = getattr(SH, table)(C.current_mesh())
        counted = DR.decode_collectives(cfg, rec_rules, B, S_MAX)
        C.set_mesh(mesh)
        out[name] = {"real": real, "counted": counted}
    return out


def train_step_rank(rank, shape, axes):
    """One rules step of the smoke codeqwen on gloo ranks: its
    ``COLLECTIVE_STATS`` beside ``dryrun.train_collectives`` and the
    recording on meta."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR
    from repro_torch.training import data as DATA
    cfg = f32_cfg()
    mesh = make_mesh(shape, axes, "cpu")
    rules = SH.train_rules(mesh)
    st = TS.init_state(cfg, torch.Generator().manual_seed(0), "cpu",
                       rules=rules)
    b = DATA.synth_batch(cfg, batch=8, seq_len=16, step=0, device="cpu")
    C.reset_stats()
    TS.make_train_step(cfg, rules=rules)(st, b)
    real = {k: dict(v) for k, v in C.COLLECTIVE_STATS["by_op"].items()}
    shp = ShapeConfig("smoke", 16, 8, "train")
    C.set_mesh(C.RecordingMesh(shape, axes))
    rec_rules = SH.train_rules(C.current_mesh())
    counted = DR.train_collectives(cfg, shp, rec_rules)
    recorded = DR.record_train(cfg, shp, rec_rules)
    pshp = ShapeConfig("smoke", 16, 8, "prefill")
    prefill = (DR.record_prefill(cfg, pshp, rec_rules),
               DR.prefill_collectives(cfg, rec_rules))
    C.set_mesh(mesh)
    return {"real": real, "counted": counted, "recorded": recorded,
            "prefill": prefill}


def runner_rank(rank, ckpt_dir, steps):
    """``TrainRunner(rules=)`` on (data 2, model 2): ``steps`` steps of
    the smoke codeqwen in float32 with a checkpoint every 2 steps (saved
    from the mesh, restored on start)."""
    from repro_torch.launch.train import TrainRunner
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    runner = TrainRunner(f32_cfg(), rules=SH.train_rules(mesh),
                         ckpt_dir=ckpt_dir, ckpt_every=2, device="cpu")
    _, losses = runner.run(batch=4, seq_len=16, steps=steps, log_every=100)
    return {"losses": losses, "history": runner.history}
