"""Multi-pod dry-run (PyTorch port of ``launch/dryrun.py``): every
(architecture x input shape x mesh) cell on the production mesh
(``make_production_mesh``, its shape only), with the reference's rule
choice per cell, and one JSON artifact per cell.  Nothing is allocated:
shapes come from the ``meta`` device.

Per cell:

* the per-rank bytes of the parameters (``rules.spec`` of every leaf's
  logical axes, ``rules.local_shape``: the reference's placement), of the
  AdamW moments (train) and of the decode state
  (``engine.make_decode_state(rules=)`` on ``meta``), and of the
  parameters a decode rank holds (``engine.mesh_param_specs``);
* executed FLOPs and HBM bytes (``launch/flops_model``) and the roofline
  terms against the H100 (``launch/roofline``);
* the bytes one step puts on the wire per rank.  A train or prefill step
  runs on a ``RecordingMesh`` (``dist/collectives``): every rank-local
  tensor lives on ``meta`` and ``COLLECTIVE_STATS`` records each
  collective as a rank would (``collectives_source: "recorded"``).  The
  decode step branches on device values (page allocation), so its
  collectives are counted from the engine's code (``decode_collectives``,
  ``"analytic"``).  A train or prefill step whose model cannot run on
  ``meta`` (qwen2-vl's ``repeat_interleave``) is counted from the step's
  code as well (``train_collectives``, ``prefill_collectives``).
* for decode cells, the reference's fallback strings
  (``engine.fallback_report``): which layout, whether K1 is the attention
  kernel, the probe strategy, and zamba2's mamba head sharding.

Usage (CPU)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
      --shape train_4k --mesh single [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, cell_applicable
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.launch import roofline as RL
from repro_torch.launch.flops_model import (executed_bytes_per_chip,
                                            executed_flops)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import nn
from repro_torch.models.registry import get_model
from repro_torch.serving import engine as EG
from repro_torch.training import train_step as TS

_DTYPE_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2,
                torch.int8: 1, torch.int32: 4, torch.int64: 8,
                torch.bool: 1, torch.uint8: 1}


def input_shapes(cfg, shape) -> Dict[str, tuple]:
    """(shape, dtype) of every model input of a cell (the reference's
    ``configs/base.input_specs``)."""
    B, S = shape.global_batch, shape.seq_len
    i64, act = torch.int64, cfg.activation_dtype()
    if shape.kind == "train":
        out = {"tokens": ((B, S), i64), "labels": ((B, S), i64)}
    elif shape.kind == "prefill":
        out = {"tokens": ((B, S), i64)}
    else:
        out = {"tokens": ((B, 1), i64), "positions": ((B,), i64)}
    if cfg.family == "encdec" and shape.kind != "decode":
        out["src_embeds"] = ((B, max(S // 8, 1), cfg.d_model), act)
    if cfg.family == "vlm" and shape.kind != "decode":
        n_patch = 1024 if S >= 1024 else S // 2
        out["patch_embeds"] = ((B, n_patch, cfg.d_model), act)
        out["mrope_positions"] = ((3, B, S), i64)
    if cfg.family == "vlm" and shape.kind == "decode":
        out["mrope_positions"] = ((3, B, 1), i64)
    return out


def cell_rules(cfg, shape, mesh, preset: str = "default"):
    """The reference's rule choice: dp or train rules for train and
    prefill; for decode the fused manual rules where the manual region
    applies, else ``serve_rules``.  Returns (rules, manual rules or
    None)."""
    if shape.kind in ("train", "prefill"):
        return (SH.dp_rules(mesh) if preset == "dp"
                else SH.train_rules(mesh)), None
    man = SH.serve_manual_rules(mesh)
    return (man if EG._manual_decode_ok(cfg, man)
            else SH.serve_rules(mesh)), man


def _nbytes(shape, dtype) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * _DTYPE_BYTES[dtype]


def local_bytes(rules, specs, tree) -> int:
    """Bytes of one rank's pieces of ``tree`` (meta tensors) cut by the
    spec tree ``specs``."""
    return sum(_nbytes(rules.local_shape(sp, tuple(t.shape)), t.dtype)
               for sp, t in zip(nn.tree_leaves(_expand(specs, tree)),
                                nn.tree_leaves(tree)))


def param_bytes_per_chip(cfg, rules) -> int:
    """One rank's parameter bytes where ``rules`` place them (the spec of
    every leaf's logical axes, as the reference's dry-run shards them)."""
    shapes = TS.param_shapes(cfg)
    return local_bytes(rules, rules.tree_specs(SH.param_axes(shapes),
                                               shapes), shapes)


def _expand(specs, tree):
    """A spec tree as deep as ``tree`` (a ``P`` covers its subtree)."""
    if isinstance(specs, SH.P):
        return nn.tree_map(lambda _: specs, tree)
    return {k: _expand(specs[k], tree[k]) for k in tree}


def _state_bytes(state) -> int:
    total = 0
    for v in state.values():
        leaves = (v if isinstance(v, tuple) and not hasattr(v, "table")
                  else (v,))
        for t in leaves:
            if hasattr(t, "table"):          # the page table's hash table
                t = t.table
            if isinstance(t, torch.Tensor):
                total += _nbytes(tuple(t.shape), t.dtype)
    return total


# ---------------------------------------------------------------------------
# Recorded collectives: the step on meta tensors over a RecordingMesh.

def _meta_batch(cfg, shape) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(s, dtype=dt, device="meta")
            for k, (s, dt) in input_shapes(cfg, shape).items()}


def record_train(cfg, shape, rules) -> Dict[str, Dict[str, int]]:
    """One rules-sharded train step on ``meta`` over the bound recording
    mesh: its collectives, by op."""
    st = TS.init_state(cfg, None, "meta", rules=rules)
    step = TS.make_train_step(cfg, rules=rules)
    C.reset_stats()
    step(st, _meta_batch(cfg, shape))
    return {k: dict(v) for k, v in C.COLLECTIVE_STATS["by_op"].items()}


def record_prefill(cfg, shape, rules) -> Dict[str, Dict[str, int]]:
    """The port's prefill on a mesh, on ``meta``: the parameters
    all-gathered from their shards (FSDP), then the forward of this rank's
    batch slice, last position only."""
    shapes = TS.param_shapes(cfg)
    specs = TS.param_specs(cfg, rules)
    params = SH.local_shard(shapes, specs, rules.mesh)
    C.reset_stats()
    full = nn.tree_unflatten(params, [
        TS.gather_full(p, sp) for p, sp in zip(nn.tree_leaves(params),
                                               nn.tree_leaves(specs))])
    batch = _meta_batch(cfg, shape)
    b = TS.local_batch(batch, TS.batch_axes(rules, batch), rules.mesh)
    kw = {k: b[k] for k in ("src_embeds", "patch_embeds", "mrope_positions")
          if k in b}
    with torch.no_grad():
        get_model(cfg).forward(cfg, full, b["tokens"], remat=False,
                               last_only=True, **kw)
    return {k: dict(v) for k, v in C.COLLECTIVE_STATS["by_op"].items()}


# ---------------------------------------------------------------------------
# Analytic collectives, counted from the code of the steps.

class _Tally:
    """Collectives by op as ``COLLECTIVE_STATS["by_op"]`` counts them: a
    gather, psum or pmax of x over n ranks sends (n - 1) x's bytes, an
    all-to-all n - 1 of its n chunks."""

    def __init__(self, mesh):
        self.mesh, self.by_op = mesh, {}

    def add(self, op: str, axes, nbytes: int) -> None:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = 1
        for a in axes:
            n *= self.mesh.shape.get(a, 1)
        if n == 1:
            return
        moved = (n - 1) * (nbytes // n if op in ("all_to_all",
                                                  "reduce_scatter")
                           else nbytes)
        e = self.by_op.setdefault(op, {"calls": 0, "sent": 0, "received": 0})
        e["calls"] += 1
        e["sent"] += moved
        e["received"] += moved


def _gathers(tally, rules, t, sp) -> None:
    """``train_step.gather_full``'s collectives for one leaf: the piece
    all-gathered dim by dim over the axes that cut it."""
    local = list(rules.local_shape(sp, tuple(t.shape)))
    for d, e in enumerate(sp):
        ax = SH._as_tuple(e)
        if ax:
            tally.add("all_gather", ax, _nbytes(local, t.dtype))
            local[d] *= rules.mesh_size(e)


def prefill_collectives(cfg, rules) -> Dict[str, Dict[str, int]]:
    """The port's prefill on a mesh from its code (``record_prefill``):
    the parameters gathered; the forward runs on the rank's own slice and
    needs none."""
    tally = _Tally(rules.mesh)
    shapes = TS.param_shapes(cfg)
    for t, sp in zip(nn.tree_leaves(shapes),
                     nn.tree_leaves(TS.param_specs(cfg, rules))):
        _gathers(tally, rules, t, tuple(sp) + (None,) * (t.dim() - len(sp)))
    return tally.by_op


def train_collectives(cfg, shape, rules) -> Dict[str, Dict[str, int]]:
    """The rules step's collectives from its code (``train_step``): the
    parameters gathered dim by dim, the loss psum'd over the batch axes,
    each gradient cut to its shard (reduce-scatter over the batch axes
    that shard it, psum over the others), one norm psum per group of
    sharding axes."""
    mesh = rules.mesh
    tally = _Tally(mesh)
    shapes = TS.param_shapes(cfg)
    specs = TS.param_specs(cfg, rules)
    baxes = SH._as_tuple(rules.axis_for("batch", shape.global_batch))
    groups = set()
    for t, sp in zip(nn.tree_leaves(shapes), nn.tree_leaves(specs)):
        sp = tuple(sp) + (None,) * (t.dim() - len(sp))
        _gathers(tally, rules, t, sp)
        g = [n // (rules.mesh_size(e) if not set(SH._as_tuple(e))
                   & set(baxes) else 1) for n, e in zip(t.shape, sp)]
        done = set()
        for d, e in enumerate(sp):
            ax = SH._as_tuple(e)
            if ax and set(ax) <= set(baxes):
                tally.add("reduce_scatter", ax, _nbytes(g, t.dtype))
                g[d] //= rules.mesh_size(e)
                done.update(ax)
        rest = tuple(a for a in mesh.axis_names
                     if a in baxes and a not in done)
        if rest:
            tally.add("psum", rest, _nbytes(g, t.dtype))
        groups.add(SH.spec_axes(sp))
    if baxes:
        tally.add("psum", baxes, 4)
    for axes in groups:
        if axes:
            tally.add("psum", tuple(a for a in mesh.axis_names if a in axes),
                      4)
    return tally.by_op


def decode_collectives(cfg, rules, B: int, S_max: int
                       ) -> Dict[str, Dict[str, int]]:
    """One decode token step's collectives from the engine's code, on the
    layout ``rules`` selects (the fused manual region or the gspmd step),
    from this rank's local parameter and state shapes (``meta``)."""
    from repro_torch.models import moe as MOE
    mesh = rules.mesh
    tally = _Tally(mesh)
    add = tally.add
    act = _DTYPE_BYTES[cfg.activation_dtype()]
    d, hd, nq, nkv = cfg.d_model, cfg.hd, cfg.n_q, cfg.n_kv
    manual = EG._manual_decode_ok(cfg, rules)
    shapes = TS.param_shapes(cfg)
    loc = _local_shapes(rules, EG.mesh_param_specs(cfg, shapes, rules),
                        shapes)
    state, _ = EG.make_decode_state(cfg, B, S_max, rules=rules)
    ops = EG._ops(cfg, rules)
    pa = tuple(a for a in ops.page_axes() if mesh.shape[a] > 1)
    has_model = "model" in mesh.shape

    def attn_paged(ap):
        hq = ap["wq"][-2]
        if manual:
            if pa:
                add("pmax", pa, B * hq * 4)
                add("psum", pa, B * hq * hd * 2)
                add("psum", pa, B * hq * 4)
            add("psum", "model", B * d * act)
            return
        q_sh = hq < nq
        if q_sh:
            add("all_gather", "model", B * hq * hd * act)
        if ap["wk"][-2] < nkv:
            add("all_gather", "model", B * ap["wk"][-2] * hd * act)
            add("all_gather", "model", B * ap["wk"][-2] * hd * act)
        if pa:
            add("pmax", pa, B * nq * 4)
            add("psum", pa, B * nq * hd * 2)
            add("psum", pa, B * nq * 4)
        if q_sh:
            add("psum", "model", B * d * act)

    def attn_ring(ap):
        if manual:
            add("psum", "model", B * d * act)
            return
        hq, hkv = ap["wq"][-2], ap["wk"][-2]
        if hq < nq:
            add("all_gather", "model", B * hq * hd * act)
        if hkv < nkv:
            add("all_gather", "model", B * hkv * hd * act)
            add("all_gather", "model", B * hkv * hd * act)
        Bl, kvl = state["ring_k"].shape[1], state["ring_k"].shape[3]
        G = nq // nkv
        if kvl < nkv:
            add("all_gather", "model", Bl * kvl * G * hd * act)
        if Bl < B:
            add("all_gather", "data", Bl * nq * hd * act)
        if hq < nq:
            add("psum", "model", B * d * act)

    def mlp(mp):
        if manual or mp["wo"][-2] < cfg.d_ff:
            add("psum", "model", B * d * act)

    def moe():
        if manual:
            add("psum", "model", B * d * act)
            return
        E = cfg.num_experts
        tp = mesh.shape.get("model", 1)
        have = MOE.moe_param_specs(cfg, rules)
        full = {"router": ((d, E), torch.float32),
                "wi_gate": ((E, d, cfg.d_ff), cfg.activation_dtype()),
                "wi_up": ((E, d, cfg.d_ff), cfg.activation_dtype()),
                "wo": ((E, cfg.d_ff, d), cfg.activation_dtype())}
        ep = (has_model and rules.axis_for("experts", E) is not None
              and E % tp == 0)
        if ep:
            f_spec = ("data" if "data" in mesh.shape
                      and cfg.d_ff % mesh.shape["data"] == 0 else None)
            want = {"router": SH.P(), "wi_gate": SH.P("model", None, f_spec),
                    "wi_up": SH.P("model", None, f_spec),
                    "wo": SH.P("model", f_spec)}
        else:
            want = {n: SH.P() for n in have}
        for n, (shp, dt) in full.items():
            _reshard(tally, rules, shp, dt, have[n], want[n])
        if ep:
            add("psum", ("data", "model") if f_spec else "model",
                B * d * act)
            add("psum", "model", 4)
            return
        all_axes = tuple(a for a in ("pod", "data", "model")
                         if a in mesh.shape)
        n_all = rules.mesh_size(all_axes)
        add("psum", all_axes, 4)
        if B % n_all == 0:
            add("all_gather", all_axes, B // n_all * d * act)

    def mamba(lp, n_layers):
        ssm_tp = ops.ssm_axis is not None
        Bl = state["ssm"].h.shape[1]
        for _ in range(n_layers):
            if ssm_tp:
                add("psum", "model", Bl * 4)
                add("psum", "model", Bl * d * 4)
            if not manual and Bl < B:
                add("all_gather", "data", Bl * d * act)

    def cross(cp):
        Bl = state["cross_k"].shape[1]
        if cp["wq"][-2] < nq:
            add("psum", "model", Bl * d * act)
        if Bl < B:
            add("all_gather", "data", Bl * d * act)

    # embed
    if not manual and loc["embed"]["embedding"][0] < cfg.vocab_size:
        add("psum", "model", B * d * act)
    lay = loc.get("layers")
    if cfg.family == "ssm":
        mamba(lay, cfg.num_layers)
    elif cfg.family == "hybrid":
        n_inv = cfg.num_layers // cfg.shared_attn_every
        for _ in range(n_inv):
            mamba(lay, cfg.shared_attn_every)
            attn_paged(loc["shared"]["attn"])
            mlp(loc["shared"]["mlp"])
        mamba(lay, cfg.num_layers - n_inv * cfg.shared_attn_every)
    elif cfg.family == "encdec":
        dec = loc["decoder"]
        for _ in range(cfg.num_layers):
            attn_paged(dec["attn"])
            cross(dec["cross"])
            mlp(dec["mlp"])
    else:
        n_paged, n_ring = EG._n_attn_layers(cfg)
        for _ in range(n_ring):
            attn_ring(lay["attn"])
        for _ in range(n_paged):
            attn_paged(lay["attn"])
        for _ in range(cfg.num_layers):
            moe() if cfg.family == "moe" else mlp(lay["mlp"])
    # read-out
    if cfg.tie_embeddings:
        V_l = loc["embed"]["embedding"][0]
    else:
        V_l = loc["lm_head"]["w"][-1]
    if V_l < cfg.vocab_size:
        add("all_gather", "model", B * V_l * act)
    return tally.by_op


def _local_shapes(rules, specs, tree):
    """This rank's shape of every leaf (a tree of tuples)."""
    ex = _expand(specs, tree)

    def walk(sp, t):
        if isinstance(t, dict):
            return {k: walk(sp[k], t[k]) for k in t}
        return rules.local_shape(sp, tuple(t.shape))
    return walk(ex, tree)


def _reshard(tally, rules, shape, dtype, have, want) -> None:
    """``sharding.reshard``'s collectives: a dim whose axes differ is
    all-gathered over the axes it had, then cut."""
    nd = len(shape)
    have = tuple(have) + (None,) * (nd - len(have))
    want = tuple(want) + (None,) * (nd - len(want))
    cur = list(rules.local_shape(have, shape))
    for d, (h, w) in enumerate(zip(have, want)):
        if SH._as_tuple(h) == SH._as_tuple(w):
            continue
        if SH._as_tuple(h):
            tally.add("all_gather", SH._as_tuple(h), _nbytes(cur, dtype))
            cur[d] *= rules.mesh_size(h)
        if SH._as_tuple(w):
            cur[d] //= rules.mesh_size(w)


# ---------------------------------------------------------------------------
# Cells.

def run_cell(arch_id: str, shape_name: str, multi_pod: bool, out_dir: str,
             verbose: bool = True, cfg_overrides: dict | None = None,
             tag_suffix: str = "") -> dict:
    overrides = dict(cfg_overrides or {})
    preset = overrides.pop("rules", "default")
    cfg = dataclasses.replace(get_config(arch_id), **overrides)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    tag = f"{arch_id}__{shape_name}__{mesh_name}{tag_suffix}"
    ok, why = cell_applicable(cfg, shape)
    rec: dict = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                 "overrides": cfg_overrides or {}}
    if not ok:
        rec.update(status="skipped", reason=why)
        _save(out_dir, tag, rec)
        return rec
    t0 = time.time()
    try:
        rec.update(status="ok", kind=shape.kind,
                   **cell_record(cfg, shape, multi_pod, preset))
        rec["seconds"] = time.time() - t0
        if verbose:
            rl = rec["roofline"]
            print(f"[{tag}] params/chip={rec['param_bytes_per_chip']:.3e}B "
                  f"coll_wire={rl['collective_wire_bytes']:.3e}B "
                  f"({rec['collectives_source']})  dom={rl['dominant']}  "
                  f"frac={rl['roofline_fraction']:.3f}")
    except Exception as e:  # noqa: BLE001 — record, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[{tag}] FAILED: {type(e).__name__}: {e}")
    _save(out_dir, tag, rec)
    return rec


def cell_record(cfg, shape, multi_pod: bool, preset: str = "default"
                ) -> dict:
    """Everything a cell's artifact holds but its status (see the module
    docstring)."""
    from repro_torch.serving.sharded_table import plan_table_shards
    prod = make_production_mesh(multi_pod=multi_pod)
    mesh = C.RecordingMesh(tuple(prod.shape.values()), prod.axis_names)
    C.set_mesh(mesh)
    try:
        rules, man = cell_rules(cfg, shape, mesh, preset)
        shapes = TS.param_shapes(cfg)
        pspecs = rules.tree_specs(SH.param_axes(shapes), shapes)
        rec = {"chips": mesh.size, "table_shards": plan_table_shards(mesh),
               "rules": preset if shape.kind != "decode" else
               ("serve_manual_rules" if man is rules else "serve_rules"),
               "param_bytes_per_chip": param_bytes_per_chip(cfg, rules)}
        mem = rec["param_bytes_per_chip"]
        if shape.kind == "train":
            rec["opt_bytes_per_chip"] = 2 * local_bytes(
                rules, pspecs, nn.tree_map(
                    lambda t: t.to(torch.float32), shapes))
            mem += rec["opt_bytes_per_chip"]
            try:
                coll, src = record_train(cfg, shape, rules), "recorded"
            except (RuntimeError, NotImplementedError) as e:
                coll, src = train_collectives(cfg, shape, rules), "analytic"
                rec["record_error"] = f"{type(e).__name__}: {e}"[:300]
        elif shape.kind == "prefill":
            try:
                coll, src = record_prefill(cfg, shape, rules), "recorded"
            except (RuntimeError, NotImplementedError) as e:
                coll, src = prefill_collectives(cfg, rules), "analytic"
                rec["record_error"] = f"{type(e).__name__}: {e}"[:300]
        else:
            B = shape.global_batch
            state, _ = EG.make_decode_state(cfg, B, shape.seq_len,
                                            rules=rules)
            rec["decode_state_bytes_per_chip"] = _state_bytes(state)
            rec["decode_param_bytes_per_chip"] = local_bytes(
                rules, EG.mesh_param_specs(cfg, shapes, rules), shapes)
            mem = (rec["decode_param_bytes_per_chip"]
                   + rec["decode_state_bytes_per_chip"])
            coll, src = (decode_collectives(cfg, rules, B, shape.seq_len),
                         "analytic")
            report = EG.fallback_report(cfg, man)
            rec["decode_tp"] = ("manual-fused" if report["decode_tp"] == "ok"
                                else "gspmd")
            rec["megastep"] = "loop-K4"
            rec["fused_kernel"] = report["fused_kernel"]
            rec["probe_strategy"] = report["probe_strategy"]
            if cfg.family == "hybrid":
                from repro_torch.dist import tp as TP
                rec["mamba_tp"] = (
                    "sharded-model" if man is rules
                    and TP.decode_ssm_tp(cfg, mesh.shape["model"])
                    else "replicated")
        fb = executed_flops(cfg, shape)
        rl = RL.Roofline(
            arch=cfg.name, shape=shape.name,
            mesh="2x16x16" if multi_pod else "16x16", chips=mesh.size,
            executed_flops_total=fb.total,
            executed_bytes_per_chip=executed_bytes_per_chip(
                cfg, shape, mesh.size, 16),
            collective_wire_bytes=float(sum(v["sent"]
                                            for v in coll.values())),
            collective_breakdown=RL.wire_breakdown(coll),
            collectives_source=src,
            model_flops_total=RL.model_flops(cfg, shape),
            peak_memory_per_chip=float(mem))
        rec.update(collectives_source=src, collectives=coll,
                   flops_breakdown=dataclasses.asdict(fb),
                   roofline=rl.to_dict())
        return rec
    finally:
        C.set_mesh(None)


def _save(out_dir: str, tag: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=float)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (e.g. tp_impl=manual, "
                         "rules=dp)")
    ap.add_argument("--tag", default="", help="artifact name suffix")
    ap.add_argument("--expect-fused", default="",
                    help="comma-separated archs whose decode cells MUST "
                         "take the fused manual-TP path with the K-token "
                         "megastep loop and an ok probe strategy (exit 1 "
                         "on any quiet gspmd fallback)")
    ap.add_argument("--expect-fused-kernel", default="",
                    help="comma-separated archs whose decode cells MUST "
                         "run the one-dispatch fused decode kernel K1 "
                         "(fused_kernel == 'ok'; exit 1 on any quiet "
                         "two-dispatch fallback)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
        overrides[k] = v

    archs = sorted(ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = [run_cell(arch, shape, mp, args.out, cfg_overrides=overrides,
                        tag_suffix=args.tag)
               for arch in archs for shape in shapes for mp in meshes]
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"of {len(results)} cells")
    not_fused = expect_gate(results, args.expect_fused, _not_fused)
    if not_fused:
        print("expect-fused VIOLATED (quiet gspmd fallback): "
              + ", ".join(not_fused))
    no_kernel = expect_gate(results, args.expect_fused_kernel, _no_kernel)
    if no_kernel:
        print("expect-fused-kernel VIOLATED (quiet two-dispatch "
              "fallback): " + ", ".join(no_kernel))
    return 0 if n_err == 0 and not not_fused and not no_kernel else 1


def _not_fused(r: dict) -> str:
    """Why an ok decode cell is not on the fused manual-TP path ('' when
    it is): the gspmd layout, a megastep that is not the K-token loop, or
    a probe strategy that fell back to the plain oracle."""
    if r.get("decode_tp") != "manual-fused":
        return "decode_tp=" + str(r.get("decode_tp"))
    if not str(r.get("megastep", "")).startswith("loop-"):
        return "megastep=" + str(r.get("megastep"))
    if not str(r.get("probe_strategy", ": ok")).endswith(": ok"):
        return "probe_strategy=" + str(r.get("probe_strategy"))
    return ""


def _no_kernel(r: dict) -> str:
    """Why an ok decode cell does not run K1 ('' when it does)."""
    return ("" if r.get("fused_kernel") == "ok"
            else "fused_kernel=" + str(r.get("fused_kernel")))


def expect_gate(results, archs: str, why) -> list:
    """The reference's CI gates: every ok decode cell of the archs named
    in ``archs`` (comma-separated) must pass ``why`` (which returns the
    fault, '' for none), and every named arch must have one ok decode
    cell, or the gate would pass vacuously.  Returns the violations."""
    expect = {a.strip() for a in archs.split(",") if a.strip()}
    bad, seen = [], set()
    for r in results:
        if (r["arch"] not in expect or r["status"] != "ok"
                or r.get("kind") != "decode"):
            continue
        seen.add(r["arch"])
        fault = why(r)
        if fault:
            bad.append(f"{r['arch']}/{r['shape']}/{r['mesh']} ({fault})")
    bad += [f"{a}/<no ok decode cell>" for a in sorted(expect - seen)]
    return bad


if __name__ == "__main__":
    raise SystemExit(main())
